"""The port's host layer against the reference's, bitwise, on the CPU.

The host layer -- timescales, the analytic ephemeris, the Earth's
orientation, the observatories with their (empty) clock chains and the
``TOAs`` pipeline from arrays -- is host numpy in both packages, so the
port's copy must give the same bits on the same machine:

* ``get_TOAs_array`` at ``gbt``, ``arecibo``, ``parkes``, ``@`` and
  ``coe``, planets on and off: clock corrections, TDB (longdouble and its
  low word), the three position/velocity columns and the planets';
  every field of ``to_batch`` against the reference's;
* the pair branch of ``compute_TDBs`` (the UTC MJDs carry a low word, as
  on a platform whose longdouble is only a double);
* the TZR row an absolute phase builds with ``make_single_toa`` equals the
  committed snapshots' ``tzr/`` batch (ngc6440e, with PHOFF as well);
* the contexts of fresh TOAs equal the reference's
  ``model._build_context(toas)`` for b1855's components (DMX, JUMP, FD),
  small_pta's (DMJUMP, CMX, the delay jump) and the Vela stand-in's
  (troposphere), the piecewise solar wind's ``theta0`` the committed
  one's, and a noise component's masks its parameters'
  ``select_toa_mask``;
* ``model.phase`` on host TOAs caches the batch per TOAs object and
  version; ``to_batch`` runs on the card unless asked for the CPU.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

MJDS = np.linspace(55000.013, 55003.871, 9)
SITES = ("gbt", "arecibo", "parkes", "@", "coe")


def _both(obs, planets, times=MJDS, **kw):
    from pint_torch import toa as ptoa
    from pint_tpu import toa as rtoa

    args = dict(freqs=np.linspace(800.0, 1600.0, len(MJDS)), ephem="DE440",
                planets=planets, **kw)
    return (rtoa.get_TOAs_array(times, obs, **args),
            ptoa.get_TOAs_array(times, obs, **args))


def _same(a, b, what):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert np.array_equal(a, b), what


def _host_columns_equal(r, p):
    for name in ("clock_corr_s", "tdb", "tdb_lo", "ssb_obs_pos_km",
                 "ssb_obs_vel_kms", "obs_sun_pos_km", "utc_mjd",
                 "utc_mjd_lo"):
        rv, pv = getattr(r, name), getattr(p, name)
        assert (rv is None) == (pv is None), name
        if rv is not None:
            _same(rv, pv, name)
    assert r.planet_pos_km.keys() == p.planet_pos_km.keys()
    for k in r.planet_pos_km:
        _same(r.planet_pos_km[k], p.planet_pos_km[k], k)
    assert list(r.obs) == list(p.obs) and r.ephem == p.ephem


def _batches_equal(rb, pb):
    """Every field of the reference's ``to_batch`` against the port's."""
    def t(x):
        return x.cpu().numpy()

    for name in ("tdb", "tdb_s"):
        _same(np.asarray(getattr(rb, name).hi), t(getattr(pb, name).hi), name)
        _same(np.asarray(getattr(rb, name).lo), t(getattr(pb, name).lo), name)
    assert float(rb.tdb0) == pb.tdb0
    for name in ("freq", "error_us", "ssb_obs_pos", "ssb_obs_vel",
                 "obs_sun_pos"):
        _same(np.asarray(getattr(rb, name)), t(getattr(pb, name)), name)
    assert rb.planet_pos.keys() == pb.planet_pos.keys()
    for k in rb.planet_pos:
        _same(np.asarray(rb.planet_pos[k]), t(pb.planet_pos[k]), k)


@pytest.mark.parametrize("planets", [False, True])
@pytest.mark.parametrize("obs", SITES)
def test_get_toas_array_bitwise(obs, planets):
    r, p = _both(obs, planets)
    _host_columns_equal(r, p)
    _batches_equal(r.to_batch(), p.to_batch(device="cpu"))
    pb = p.to_batch(device="cpu")
    _same(pb.mjds, np.asarray(r.get_mjds(), dtype=np.float64), "mjds")
    assert list(pb.obs) == [str(o) for o in r.obs]
    assert pb.ephem == r.ephem and pb.contexts is None


def test_pair_input_and_pair_branch_bitwise():
    """An ``(mjd1, mjd2)`` input, and the pair branch of ``compute_TDBs``
    with its ``to_batch``: the UTC MJDs given a low word, as the native
    parser gives them where longdouble is only a double."""
    from pint_torch import toa as ptoa
    from pint_tpu import toa as rtoa

    ints = np.floor(MJDS)
    r, p = _both("gbt", True, times=(ints, MJDS - ints))
    _host_columns_equal(r, p)
    lo = np.random.default_rng(5).uniform(-1e-17, 1e-17, len(MJDS))
    tabs = []
    for mod in (rtoa, ptoa):
        n = len(MJDS)
        t = mod.TOAs(utc_mjd=np.asarray(MJDS, dtype=np.longdouble),
                     error_us=np.ones(n), freq_mhz=np.full(n, 1400.0),
                     obs=np.array(["gbt"] * n, dtype=object),
                     flags=[{} for _ in range(n)])
        t.utc_mjd_lo = lo.copy()
        mod._finalize_toas(t, "DE440", True, True, True, "BIPM2021", "warn")
        tabs.append(t)
    r, p = tabs
    assert r.tdb_lo is not None and p.tdb_lo is not None
    _host_columns_equal(r, p)
    _batches_equal(r.to_batch(), p.to_batch(device="cpu"))


@pytest.mark.parametrize("which", ["NGC_PATH", "NGC_PHOFF_PATH"])
def test_tzr_batch_from_the_host_layer_equals_the_snapshots(which):
    from pint_torch import bridge

    m, _ = bridge.load_snapshot(getattr(bridge, which), device="cpu")
    ab = m.components["AbsPhase"]
    stored = ab.context["tzr_batch"]
    host = ab.host_tzr_batch()
    assert host.tzr and host.ntoas == 1 and host.tdb0 == stored.tdb0
    for name in ("freq", "error_us", "ssb_obs_pos", "ssb_obs_vel",
                 "obs_sun_pos"):
        assert torch.equal(getattr(host, name), getattr(stored, name)), name
    for name in ("tdb", "tdb_s"):
        for w in ("hi", "lo"):
            assert torch.equal(getattr(getattr(host, name), w),
                               getattr(getattr(stored, name), w)), name
    assert host.planet_pos.keys() == stored.planet_pos.keys()
    _same(host.mjds, stored.mjds, "mjds")
    for comp, ctx in stored.contexts.items():
        hc = host.contexts[comp]
        assert hc.keys() == ctx.keys(), comp
        for k in ctx:
            assert torch.equal(hc[k], ctx[k]), (comp, k)
    # the absolute phase with the host-built row is the stored one's
    b = bridge.load_snapshot(getattr(bridge, which), device="cpu")[1]
    ph_stored = m.phase(b, abs_phase=True)
    ab.context.pop("tzr_batch")
    ph_host = m.phase(b, abs_phase=True)
    assert torch.equal(ph_stored.int_, ph_host.int_)
    assert torch.equal(ph_stored.frac, ph_host.frac)


def _flags(n):
    fe = ["430", "L-wide"]
    be = ["ASP", "PUPPI"]
    return [{"fe": fe[i % 2], "f": f"{be[(i // 2) % 2]}_{fe[i % 2]}",
             "be": be[(i // 2) % 2]} for i in range(n)]


def _context_pair(model, mjds, obs="gbt"):
    """(reference contexts, port model, port contexts) of fresh TOAs."""
    from pint_torch import toa as ptoa
    from pint_torch.bridge import load_snapshot
    from pint_tpu import toa as rtoa

    kw = dict(freqs=np.where(np.arange(len(mjds)) % 2, 1400.0, 430.0),
              flags=_flags(len(mjds)), ephem="DE440")
    r = rtoa.get_TOAs_array(mjds, obs, **kw)
    p = ptoa.get_TOAs_array(mjds, obs, **kw)
    m, _ = load_snapshot(standin.export_state(model, r), device="cpu")
    return r, p, model._build_context(r), m, m.host_contexts(p)


def _flat(prefix, obj, out):
    if obj is None:
        out[prefix] = None
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = obj


def _contexts_equal(ref, port, model):
    for name, ctx in ref.items():
        if getattr(model.components[name], "kind", "") == "noise":
            continue
        a, b = {}, {}
        _flat(name, ctx, a)
        _flat(name, port[name], b)
        assert a.keys() == b.keys(), name
        for k in a:
            if a[k] is None:
                assert b[k] is None, k
                continue
            pv = b[k].cpu().numpy() if torch.is_tensor(b[k]) \
                else np.asarray(b[k])
            ra = np.asarray(a[k], dtype=np.float64)
            assert ra.shape == pv.shape and np.array_equal(ra, pv), k


def _noise_masks_equal(r, p, model, m):
    for name, comp in model.components.items():
        if getattr(comp, "kind", "") != "noise":
            continue
        masks = m.components[name].host_context(p).get("masks", {})
        for pname in comp.params:
            par = comp._params_dict[pname]
            if pname in masks:
                want = np.zeros(len(r), dtype=bool)
                want[par.select_toa_mask(r)] = True
                assert np.array_equal(masks[pname], want), pname


def test_contexts_of_fresh_toas_b1855():
    from pint_tpu.models import get_model

    model = get_model(standin.standin_par(standin.FULL_SETTINGS, full=True)
                      .splitlines(keepends=True))
    mjds = np.linspace(53380.0, 56580.0, 24)
    r, p, ref, m, port = _context_pair(model, mjds)
    assert {"DispersionDMX", "PhaseJump", "FD"} <= set(ref)
    assert port["PhaseJump"]["masks"]["JUMP1"].sum() > 0
    assert port["DispersionDMX"]["masks"].sum() == len(mjds)
    _contexts_equal(ref, port, model)
    _noise_masks_equal(r, p, model, m)


def test_contexts_of_fresh_toas_small_pta():
    """small_pta's DMJUMP, CMX and delay jump."""
    from pint_tpu.models import get_model

    # the stand-in's model as make_standin builds it, without its TOAs
    model = get_model(standin.standin_par(standin.SMALL_PTA_SETTINGS,
                                          full=False).splitlines(keepends=True))
    standin._add_delay_jump(model)
    if "PLSWNoise" in model.components:
        standin._patch_sw_geometry(model)
    mjds = np.linspace(54010.0, 55990.0, 16)
    r, p, ref, m, port = _context_pair(model, mjds)
    assert {"DispersionJump", "ChromaticCMX", "DelayJump"} <= set(ref)
    _contexts_equal(ref, port, model)
    _noise_masks_equal(r, p, model, m)


def test_contexts_of_fresh_toas_vela():
    """The Vela stand-in's troposphere (the Niell-mapped zenith delay at
    each site) and glitches."""
    from pint_tpu.models import get_model

    model = get_model(standin.vela_par(standin.YOUNG_SETTINGS, full=True)
                      .splitlines(keepends=True))
    mjds = np.linspace(54010.0, 55990.0, 16)
    r, p, ref, m, port = _context_pair(model, mjds, obs="parkes")
    assert "TroposphereDelay" in ref
    # zero below 5 degrees of altitude, as in the reference
    assert np.any(port["TroposphereDelay"]["delay"].numpy() > 0)
    _contexts_equal(ref, port, model)


def test_swx_theta0_is_the_snapshots():
    """The conjunction's elongation of the piecewise solar wind, from the
    ecliptic astrometry, bitwise the reference's stored ``theta0``."""
    from pint_torch.bridge import PTA_PATH, load_snapshot

    m, _ = load_snapshot(PTA_PATH, device="cpu")
    c = m.components["SolarWindDispersionX"]
    assert c._theta0() == float(c.context["theta0"])


def test_phase_of_host_toas_matches_its_batch_and_caches_it():
    """``TimingModel.phase`` takes host TOAs: the batch (with the model's
    contexts) is made once per TOAs object and version."""
    from pint_torch import toa as ptoa
    from pint_torch.bridge import NGC_PATH, load_snapshot

    m, _ = load_snapshot(NGC_PATH, device="cpu")
    t = ptoa.get_TOAs_array(np.linspace(53800.0, 53801.0, 5), "@",
                            freqs=1400.0, ephem="DE421")
    ph = m.phase(t, abs_phase=True)
    b = m.batch_of(t)
    assert m.batch_of(t) is b
    ph2 = m.phase(t.to_batch(device="cpu", model=m), abs_phase=True)
    assert torch.equal(ph.int_, ph2.int_) and torch.equal(ph.frac, ph2.frac)
    t.compute_TDBs(ephem="DE421")
    assert m.batch_of(t) is not b
    assert m.delay(t).shape == (5,)


def test_to_batch_defaults_to_the_gpu():
    from pint_torch import NoGPUError
    from pint_torch import toa as ptoa

    t = ptoa.get_TOAs_array(MJDS, "gbt", freqs=1400.0, ephem="DE440")
    if torch.cuda.is_available():
        assert t.to_batch().device.type == "cuda"
        return
    with pytest.raises(NoGPUError):
        t.to_batch()
