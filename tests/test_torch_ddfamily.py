"""The DD family on the CPU: K2's plain twin in its BT, DD, DDGR and DDK
modes, with DDS's and DDH's rows, against the reference's engines
(``pint_tpu/models/binary/engines.py:127-352``), and the small BT, DDS
and DDH stand-ins end to end.

Engines: seeded random orbits, ECC from 1e-5 to 0.95, half the TOAs within
5 s of a whole orbit (the mean anomaly's wrap), go through the reference's
eager engine and through the port's delay, built as the components build
it (the reparameterized row in torch, then K2's twin; DDK's corrections in
torch).  The delay within 1e-14 s; the partials of the delay with respect
to tt0 and each parameter the model reads, from ``torch.func`` through the
twin's reverse sweep and the torch reparameterizations, within 1e-10 of
their column's largest against ``jax.jacfwd`` of the reference; a NaN delay
poisons every partial the kernel writes.  DDK runs with equatorial and
ecliptic proper motion (the latter rotated to equatorial as the reference
rotates it) and with K96 on and off.

Stand-ins: ``SMALL_BT_SETTINGS``, ``SMALL_DDS_SETTINGS``,
``SMALL_DDH_SETTINGS`` (the small GLS stand-in's binary as BT, DDS, DDH),
exported by the reference and loaded into the port: residuals 1e-10 s,
the GLS fit's and ``Fitter.auto``'s chi2 1e-6 rel, values 1e-2 sigma,
uncertainties 1e-6 rel, ``Fitter.auto``'s class, converged flag and steps.
The ``validate`` refusals raise the reference's exception types.
"""

import math
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import jacfwd, jvp

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

from pint_torch.kernels import dd_binary as K2  # noqa: E402
from pint_torch.models.binary import components as C  # noqa: E402
from pint_torch.models.binary import engines as T  # noqa: E402
from pint_torch.models.timing_model import stack_params  # noqa: E402
from pint_torch.pulsar_ecliptic import OBL_IERS2010_RAD  # noqa: E402

pytestmark = pytest.mark.torch

F64 = torch.float64
N = 160

#: the parameters each model reads (the reference's ``pv`` keys)
READS = {
    "BT": ("PB", "PBDOT", "XPBDOT", "A1", "A1DOT", "ECC", "EDOT", "OM",
           "OMDOT", "GAMMA"),
    "DD": T.DD_PARAMS,
    "DDS": T.DD_PARAMS[:10] + ("SHAPMAX",) + T.DD_PARAMS[11:],
    "DDH": T.DD_PARAMS[:9] + ("H3", "STIGMA") + T.DD_PARAMS[11:],
    "DDGR": ("PB", "PBDOT", "XPBDOT", "A1", "A1DOT", "ECC", "EDOT", "OM",
             "MTOT", "M2", "XOMDOT", "A0", "B0"),
    "DDK": T.DD_PARAMS[:10] + T.DD_PARAMS[11:] + ("KIN", "KOM", "PX",
                                                   "PMRA", "PMDEC"),
}
#: DDK's variants: (proper motion frame, K96)
DDK_CASES = [("equatorial", 1.0), ("equatorial", 0.0), ("ecliptic", 1.0),
             ("ecliptic", 0.0)]


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _orbit(model, ecc, seed):
    """A parameter dict of ``model`` (B1913+16-, J1713+0747- or
    B1855-like scales) and N tt0 values, half near whole orbits."""
    rng = np.random.default_rng(seed)
    pb = 0.322997448918 if model == "DDGR" else 5.741 * (1 + 0.1 * rng.normal())
    pv = dict(PB=pb, PBDOT=rng.uniform(-3e-12, 3e-12),
              XPBDOT=rng.uniform(-1e-13, 1e-13),
              A1=2.341776 if model == "DDGR" else 3.37 * (1 + 0.1 * rng.normal()),
              A1DOT=rng.uniform(-2e-14, 2e-14), ECC=ecc,
              EDOT=rng.uniform(-1e-17, 1e-17), OM=rng.uniform(0.0, 360.0),
              OMDOT=rng.uniform(0.0, 4.0), M2=rng.uniform(0.2, 1.4),
              SINI=rng.uniform(0.5, 0.999), GAMMA=rng.uniform(0.0, 4e-3),
              DR=rng.uniform(-3e-6, 3e-6), DTH=rng.uniform(-3e-6, 3e-6),
              A0=rng.uniform(-3e-7, 3e-7), B0=rng.uniform(-3e-7, 3e-7))
    if model == "DDS":
        pv["SHAPMAX"] = -math.log(1.0 - pv.pop("SINI"))
    elif model == "DDH":
        s = pv.pop("SINI")
        st = s / (1.0 + math.sqrt(1.0 - s * s))
        pv.update(STIGMA=st, H3=T.TSUN * pv.pop("M2") * st**3)
    elif model == "DDGR":
        pv.update(MTOT=2.828378 * (1 + 1e-3 * rng.normal()), M2=1.389,
                  XOMDOT=rng.uniform(-1e-3, 1e-3))
    elif model == "DDK":
        pv.pop("SINI")
        pv.update(KIN=rng.uniform(20.0, 85.0), KOM=rng.uniform(0.0, 360.0),
                  PX=rng.uniform(0.5, 2.0), PMRA=rng.uniform(-20.0, 20.0),
                  PMDEC=rng.uniform(-20.0, 20.0))
    pv = {k: pv[k] for k in READS[model]}
    t = np.concatenate([
        rng.uniform(-3e8, 3e8, N // 2),
        np.round(rng.uniform(-2e3, 2e3, N // 2)) * pb * 86400.0
        + rng.uniform(-5.0, 5.0, N // 2)])
    return pv, t


def _sky(seed):
    """A unit vector to the pulsar (N, 3), slightly moving, and the
    observatory's positions (N, 3) [ls]; with the ecliptic (ELONG, ELAT)
    [rad] and proper motion (PMELONG, PMELAT) [mas/yr] whose rotation the
    ecliptic case applies."""
    rng = np.random.default_rng(seed)
    lon, lat = rng.uniform(0, 2 * np.pi), rng.uniform(-1.2, 1.2)
    dl = rng.uniform(-1e-7, 1e-7, N)
    v = np.stack([np.cos(lat + dl) * np.cos(lon + dl),
                  np.cos(lat + dl) * np.sin(lon + dl), np.sin(lat + dl)], 1)
    ph = rng.uniform(0, 2 * np.pi, N)
    obs = 499.0 * np.stack([np.cos(ph), 0.917 * np.sin(ph),
                            0.398 * np.sin(ph)], 1)
    ecl = dict(ELONG=rng.uniform(0, 2 * np.pi), ELAT=rng.uniform(-1.2, 1.2),
               PMELONG=rng.uniform(-20, 20), PMELAT=rng.uniform(-20, 20))
    return v, obs, ecl


def _ref_fn(model, sky=None, frame="equatorial", k96=1.0):
    """The reference's delay of (pv, tt0), as its component calls it."""
    from pint_tpu.models.binary import components as jc
    from pint_tpu.models.binary import engines as eng

    if model != "DDK":
        return {"BT": eng.bt_delay, "DD": eng.dd_delay,
                "DDS": eng.dds_delay, "DDH": eng.ddh_delay,
                "DDGR": eng.ddgr_delay}[model]
    v, obs, ecl = sky

    def fn(pv, t, v=v, obs=obs):
        pv = dict(pv, K96=k96)
        if frame == "ecliptic":
            pv["PMRA"], pv["PMDEC"] = jc._ecliptic_pm_to_equatorial(
                ecl["ELONG"], ecl["ELAT"], pv.pop("PMRA"), pv.pop("PMDEC"))
        return eng.ddk_delay(pv, t, jnp.asarray(v), jnp.asarray(obs))
    return fn


def _port_delay(model, pv, tt0, sky=None, frame="equatorial", k96=1.0):
    """The port's delay as its component computes it: the row (DDS, DDH,
    DDGR reparameterized in torch) and, for DDK, the corrections, into
    K2 (its twin on these CPU tensors)."""
    comp = {"BT": C.BinaryBT, "DD": C.BinaryDD, "DDS": C.BinaryDDS,
            "DDH": C.BinaryDDH, "DDGR": C.BinaryDDGR}.get(model)
    if comp is not None:
        return comp({}, {}).binary_delay(pv, tt0)
    v, obs, ecl = sky
    v, obs = _t(v), _t(obs)
    pv2 = dict(pv)
    if frame == "ecliptic":
        pv2["PMRA"], pv2["PMDEC"] = T.ecliptic_pm_to_equatorial(
            ecl["ELONG"], ecl["ELAT"], pv2.pop("PMRA"), pv2.pop("PMDEC"),
            OBL_IERS2010_RAD, tt0)
    d_a1, d_om, kin = T.ddk_corrections(pv2, tt0, v, obs, k96)
    return K2.dd_binary(tt0, stack_params(pv2, T.DD_PARAMS, tt0.device),
                        T.DDK, (d_a1, d_om, torch.sin(kin)))


def _cases():
    out = []
    for model in ("BT", "DD", "DDS", "DDH", "DDGR"):
        out += [(model, "equatorial", 1.0)]
    return out + [("DDK", f, k) for f, k in DDK_CASES]


ECCS = [1e-5, 0.3, 0.617, 0.95]


@pytest.mark.parametrize("ecc", ECCS)
@pytest.mark.parametrize("model,frame,k96", _cases())
def test_delay_matches_reference_engine(model, frame, k96, ecc):
    """The port's delay against the reference's eager engine within
    1e-14 s (measured up to a few 1e-16 s: torch's and XLA's CPU sines,
    and for DDGR their pow, may differ in the last bit)."""
    pv, t = _orbit(model, ecc, seed=int(ecc * 1e4) + len(model) + int(k96))
    sky = _sky(7) if model == "DDK" else None
    want = np.asarray(_ref_fn(model, sky, frame, k96)(
        {k: jnp.asarray(v) for k, v in pv.items()}, jnp.asarray(t)))
    got = _port_delay(model, pv, _t(t)[None], sky, frame, k96)
    assert got.dtype == F64 and got.shape == (1, N)
    assert np.isfinite(want).all()
    assert np.abs(got[0].numpy() - want).max() <= 1e-14


@pytest.mark.parametrize("ecc", [1e-5, 0.617, 0.95])
@pytest.mark.parametrize("model,frame,k96", _cases())
def test_partials_match_reference_jacfwd(model, frame, k96, ecc):
    """d delay / d (tt0, each parameter read) from ``torch.func`` through
    the twin's reverse sweep (and the torch reparameterizations) against
    ``jax.jacfwd`` of the reference, per TOA: each within 1e-10 of its
    column's largest."""
    pv, t = _orbit(model, ecc, seed=int(ecc * 1e4) + 3 * len(model))
    sky = _sky(11) if model == "DDK" else None
    names = list(pv)
    x0 = np.array([pv[n] for n in names])
    v, obs = (sky[0], sky[1]) if sky is not None else (np.zeros((N, 3)),) * 2

    def one(x, vi, oi):
        p = {n: x[1 + j] for j, n in enumerate(names)}
        if model == "DDK":
            return _ref_fn(model, (vi[None], oi[None], sky[2]), frame,
                           k96)(p, x[:1])[0]
        return _ref_fn(model)(p, x[0])

    x = np.concatenate([t[:, None], np.broadcast_to(x0, (N, len(x0)))], 1)
    J = np.asarray(jax.jit(jax.vmap(jax.jacfwd(one)))(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(obs)))

    def port(vals, tt0):
        p = {n: vals[:, j:j + 1] for j, n in enumerate(names)}
        return _port_delay(model, p, tt0, sky, frame, k96)

    vals, tt0 = _t(x0)[None], _t(t)[None]
    Jp = jacfwd(port, argnums=0)(vals, tt0)[0, :, 0, :].numpy()
    _, Jt = jvp(lambda s: port(vals, s), (tt0,), (torch.ones_like(tt0),))
    got = np.concatenate([Jt[0].numpy()[:, None], Jp], axis=1)
    scale = np.abs(J).max(axis=0)
    err = np.abs(got - J).max(axis=0)
    assert (err <= 1e-10 * np.where(scale > 0, scale, 1.0)).all(), \
        dict(zip(["tt0"] + names, err / np.maximum(scale, 1e-300)))


@pytest.mark.parametrize("mode", [T.DD, T.BT, T.DDGR, T.DDK])
def test_nan_delay_poisons_every_partial(mode):
    """A NaN TOA (and in DD and DDK a sini > 1, in DDGR an ar below a1,
    whose Shapiro log is NaN) gives a NaN delay and NaN in every partial K2
    writes; the other elements stay finite."""
    rng = np.random.default_rng(5 + mode)
    B, n = 3, 64
    row = np.array([[5.741, 1e-12, 0.0, 3.37, 0.0, 0.4, 0.0, 87.0, 0.02,
                     0.3, 0.97, 2e-5, 0.0, 0.0, 1e-7, 1e-7]] * B)
    if mode == T.DDGR:
        row[:, 8:11] = [[1e-9, 6.8e-6, 5.0]] * B
        row[-1, 10] = 3.0            # ar < a1: sini > 1
    elif mode != T.BT:
        row[-1, 10] = 1.5
    t = rng.uniform(-3e8, 3e8, (B, n))
    t[0, ::7] = np.nan
    toa = None
    if mode == T.DDK:
        sini = np.full((B, n), 0.97)
        sini[-1] = 1.5
        toa = (_t(rng.uniform(-1e-7, 1e-7, (B, n))),
               _t(rng.uniform(-1e-6, 1e-6, (B, n))), _t(sini))
    d, P = K2.dd_binary_reference(_t(t), _t(row), True, mode, toa)
    assert P.shape == (B, n, K2.npartial(mode))
    bad = torch.isnan(d)
    assert bool(bad[0, ::7].all())
    if mode != T.BT:
        assert bool(bad[-1].any())
    assert bool(torch.isnan(P[bad]).all())
    assert bool(torch.isfinite(P[~bad]).all())
    assert bool(torch.isfinite(d[1]).all())


def test_bt_and_ddk_partials_of_unread_entries_are_zero():
    """BT reads 10 of the 16 row entries and DDK not the row's SINI: K2
    writes no column for the rest (11 and 19 partials), and through its
    jvp their partials are exact zeros where the delay is finite."""
    pv, t = _orbit("DD", 0.3, 1)
    row = _t([[pv[k] for k in T.DD_PARAMS]])
    z = torch.zeros((1, N), dtype=F64)
    toas = {T.BT: None, T.DDK: (z, z, torch.full_like(z, 0.9))}
    unread = {T.BT: ("M2", "SINI", "DR", "DTH", "A0", "B0"),
              T.DDK: ("SINI",)}
    for mode, toa in toas.items():
        _, P = K2.dd_binary_reference(_t(t)[None], row, True, mode, toa)
        assert P.shape[-1] == K2.npartial(mode) \
            == 17 - len(unread[mode]) + (3 if mode == T.DDK else 0)
        idx = [1 + T.DD_PARAMS.index(k) for k in unread[mode]]
        assert not set(idx) & set(T.partial_columns(mode))
        J = jacfwd(lambda r: K2.dd_binary(_t(t)[None], r, mode, toa))(row)
        assert bool(torch.isfinite(J).all())
        for i in idx:
            assert bool((J[..., i - 1] == 0).all())
        assert bool((J[..., [i - 1 for i in range(1, 17)
                             if i not in idx]] != 0).any(-1).all())


def test_ddgr_row_matches_the_references_arithmetic():
    """DDGR's per-row quantities (ar, k, gamma, the GR orbital decay) on
    2000 random rows against the reference's, from ``_ddgr_arr`` and
    ``ddgr_delay``'s expressions: within 8 ulp.  The port repeats the
    reference's operations; torch's and XLA's ``pow`` (the 1/3, 2/3,
    5/3, -1/3 and -3.5 powers) round a last bit apart on a few rows
    (measured over 20000 rows: at most 2 ulp of ar, 3 of k and gamma, 4
    of the decay, on 1-4% of rows).  The companion mass is handed in
    seconds, exactly the reference's."""
    from pint_tpu.models.binary import engines as eng

    rng = np.random.default_rng(2)
    n = 2000
    mtot = rng.uniform(1.0, 3.5, n)
    m2 = mtot * rng.uniform(0.1, 0.6, n)
    pb, e0 = rng.uniform(0.1, 30.0, n), rng.uniform(0.0, 0.95, n)
    row = T.ddgr_row({"MTOT": _t(mtot)[:, None], "M2": _t(m2)[:, None],
                      "PB": _t(pb)[:, None], "ECC": _t(e0)[:, None]},
                     torch.zeros((n, 1), dtype=F64))
    mt, m2s = jnp.asarray(mtot) * eng.TSUN, jnp.asarray(m2) * eng.TSUN
    m1 = mt - m2s
    nn = eng.TWO_PI / (jnp.asarray(pb) * 86400.0)
    arr0, arr = eng._ddgr_arr(mt, m1, m2s, nn)
    e = jnp.asarray(e0)
    fe = (1.0 + (73.0 / 24.0) * e**2 + (37.0 / 96.0) * e**4) \
        * (1.0 - e**2) ** (-3.5)
    want = dict(
        AR=arr * (m2s / mt), K=3.0 * mt / (arr0 * (1.0 - e**2)),
        GAMMA=e * m2s * (m1 + 2.0 * m2s) / (nn * arr0 * mt),
        PBDOT=(-192.0 * math.pi / 5.0) * nn ** (5.0 / 3.0) * m1 * m2s
        * mt ** (-1.0 / 3.0) * fe)
    for k, w in want.items():
        w = np.asarray(w)
        ulp = np.abs(row[k][:, 0].numpy() - w) / np.spacing(np.abs(w))
        assert ulp.max() <= 8, (k, ulp.max())
    np.testing.assert_array_equal(row["M2S"][:, 0].numpy(), np.asarray(m2s))


def test_component_ddk_matches_the_engine_path():
    """``BinaryDDK.delay_func`` on the small DDK stand-in (ecliptic
    astrometry) equals the engine path built by hand from the same
    inputs: the rotation of PMELONG/PMELAT, the corrections and K2."""
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(standin.SMALL_DDK_SETTINGS,
                                       full=False)
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    comp = m.components["BinaryDDK"]
    pv = m.const_pv()
    acc = torch.zeros((1, b.ntoas), dtype=F64)
    got = comp.delay_func(pv, b, {}, acc)
    tt0 = comp._tt0(pv, b, acc)
    astro = m.components["AstrometryEcliptic"]
    psr = astro.ssb_to_psb_xyz(pv, b.tdb.hi)
    pm = T.ecliptic_pm_to_equatorial(pv["ELONG"], pv["ELAT"],
                                     pv["PMELONG"], pv["PMELAT"],
                                     OBL_IERS2010_RAD, tt0)
    pv2 = dict(pv, PMRA=pm[0], PMDEC=pm[1])
    d_a1, d_om, kin = T.ddk_corrections(pv2, tt0, psr, b.ssb_obs_pos, 1.0)
    want, _ = K2.dd_binary_reference(
        tt0, stack_params(pv2, T.DD_PARAMS, tt0.device), False, T.DDK,
        (d_a1, d_om, torch.sin(kin)))
    assert torch.equal(got, want)
    # the reference's ecliptic rotation of the same proper motion
    from pint_tpu.models.binary import components as jc

    ra, dec = jc._ecliptic_pm_to_equatorial(
        jnp.asarray(pv["ELONG"]), jnp.asarray(pv["ELAT"]),
        jnp.asarray(pv["PMELONG"]), jnp.asarray(pv["PMELAT"]))
    assert abs(float(pm[0]) - float(ra)) <= 1e-14 * abs(float(ra))
    assert abs(float(pm[1]) - float(dec)) <= 1e-14 * abs(float(dec))


# ---------------------------------------------------------------------------
# the small BT, DDS and DDH stand-ins end to end
# ---------------------------------------------------------------------------
SMALL = {"BT": standin.SMALL_BT_SETTINGS, "DDS": standin.SMALL_DDS_SETTINGS,
         "DDH": standin.SMALL_DDH_SETTINGS}


@pytest.fixture(scope="module", params=list(SMALL))
def small(request):
    from pint_torch.bridge import load_snapshot, read_snapshot

    s = SMALL[request.param]
    model, toas = standin.make_standin(s, full=False)
    snap = standin.export_snapshot(model, toas, s, grid=False)
    meta, arrays = read_snapshot(snap)
    m, b = load_snapshot(snap, device="cpu")
    return request.param, meta, arrays, m, b


def test_small_stand_in_residuals_and_design_matrix_match(small):
    from pint_torch.residuals import Residuals

    name, meta, ref, m, b = small
    assert f"Binary{name}" in m.components
    r = Residuals(b, m).time_resids.numpy()
    assert np.abs(r - ref["ref/time_resids"]).max() <= 1e-10
    M, names = m.designmatrix(b)
    Mr = ref["ref/designmatrix"]
    assert names == meta["reference"]["designmatrix_names"]
    err = np.abs(M.numpy() - Mr).max(axis=0) / np.abs(Mr).max(axis=0)
    assert err.max() <= 1e-9


@pytest.mark.parametrize("key", ["postfit", "auto"])
def test_small_stand_in_fits_match(small, key):
    """``GLSFitter.fit_toas(maxiter=2)`` and ``Fitter.auto``'s fit from the
    snapshot's values: chi2, values, uncertainties; for the auto fit its
    class, converged flag and downhill steps."""
    from pint_torch.fitter import Fitter
    from pint_torch.gls_fitter import GLSFitter

    name, meta, ref, m, b = small
    rr = meta["reference"]
    f = GLSFitter(b, m.copy()) if key == "postfit" else Fitter.auto(b, m.copy())
    chi2 = f.fit_toas(maxiter=2) if key == "postfit" else f.fit_toas()
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref[f"ref/{key}_uncertainties"]
    assert abs(chi2 / rr[f"{key}_chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref[f"ref/{key}_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6
    if key == "auto":
        assert type(f).__name__ == rr["auto_fitter"]
        assert (bool(f.converged), f.iterations) == (
            rr["auto_converged"], rr["auto_iterations"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def _state(settings):
    model, toas = standin.make_standin(settings, full=False)
    return model, standin.export_state(model, toas)


def _with(arrays, **values):
    """A copy of the snapshot with parameter values replaced."""
    import json

    meta = json.loads(str(arrays["meta"]))
    for p in meta["params"]:
        if p["name"] in values:
            p["value"] = values[p["name"]]
    return dict(arrays, meta=np.asarray(json.dumps(meta)))


def _ref_raises(model, **values):
    for k, v in values.items():
        getattr(model, k).value = v
    try:
        model.validate()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("settings,values", [
    ("DDS", dict(SHAPMAX=-1.0)),
    ("DDH", dict(STIGMA=None)),
    ("DDH", dict(H3=None)),
    ("BT", dict(ECC=1.2)),
    ("BT", dict(A1=None)),
    ("DDGR", dict(MTOT=None)),
    ("DDK", dict(KOM=None)),
    ("DDK", dict(PX=0.0)),
    ("DDK", dict(SINI=0.9)),
])
def test_validate_refusals_match_the_references_types(settings, values):
    from pint_torch.bridge import load_snapshot
    from pint_torch.exceptions import ModelError

    s = {"DDS": standin.SMALL_DDS_SETTINGS, "DDH": standin.SMALL_DDH_SETTINGS,
         "BT": standin.SMALL_BT_SETTINGS, "DDGR": standin.SMALL_DDGR_SETTINGS,
         "DDK": standin.SMALL_DDK_SETTINGS}[settings]
    model, arrays = _state(s)
    want = _ref_raises(model, **values)
    assert want in ("MissingParameter", "TimingModelError")
    with pytest.raises(Exception) as e:
        load_snapshot(_with(arrays, **values), device="cpu")
    assert type(e.value).__name__ == want
    assert isinstance(e.value, ModelError)
