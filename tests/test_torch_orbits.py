"""FBX and ORBWAVES orbits and the piecewise BT on the CPU.

K6 (``binary_orbits``)'s plain twin against the reference's
``orbits_fbx`` and ``orbits_waves`` (``pint_tpu/models/binary/
engines.py:68-108``): FBX bitwise, the waves within 1e-15 rel, with a TOA
within 1e-12 orbits of a whole orbit (where one ulp would flip the orbit
count); its partials through ``torch.func`` against ``jax.jacfwd``.  K2's
and K4's orbit-input forms fed ``orbits_pb``'s own output give the PB
form's delay bitwise.  The components -- ELL1 on FB0..FB3 orbits, DD on
ORBWAVES with a PB base, ELL1 on ORBWAVES with an FBX base, the piecewise
BT with two pieces -- against the reference: the delay within 1e-13 s,
the design matrix (partials through K6's and K2's or K4's ``jvp``) within
1e-10 of each column's largest.  The small_dd_fbx and small_bt_piecewise
stand-ins end to end against the reference outputs stored in their
snapshots, and a small black-widow slice's FB0 x FB1 grid against the
reference's.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import jacfwd

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

from pint_torch.kernels import binary_orbits as K6  # noqa: E402
from pint_torch.kernels import dd_binary as K2  # noqa: E402
from pint_torch.kernels import ell1_binary as K4  # noqa: E402
from pint_torch.models.binary import engines as T  # noqa: E402

pytestmark = pytest.mark.torch

F64 = torch.float64
#: K6's forms at the stand-ins' orders
FORMS = {"fbx": (T.FBX, 4, 0), "waves_pb": (T.WAVES_PB, 0, 5),
         "waves_fbx": (T.WAVES_FBX, 2, 5)}
_VALUES = {"PB": 0.1388, "FB0": 8.338951e-05, "FB1": -4.0e-20,
           "FB2": 1.0e-28, "FB3": -2.0e-36, "ORBWAVE_OM": 4.49e-8}


def _coef(form, nfb, nw, seed=0):
    rng = np.random.default_rng(seed)
    names = T.orbit_coefficients(form, nfb, nw)
    vals = [_VALUES.get(n, 1e-4 * rng.normal()) for n in names]
    return names, np.array(vals)


def _tt0(seed=0, n=300):
    """TOAs over +-2e8 s, one within 1e-12 orbits of a whole orbit."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-2e8, 2e8, n)
    t[0] = 1234.0 / 8.338951e-05 * (1.0 + 1e-16)
    return t


def _ref(names, vals, t, form, nfb, nw, off):
    from pint_tpu.models.binary import engines as je

    pv = dict(zip(names, [jnp.asarray(v) for v in vals]))
    fbn = [f"FB{i}" for i in range(nfb)]
    if form == T.FBX:
        return je.orbits_fbx([pv[n] for n in fbn], t)
    cn = [f"ORBWAVEC{k}" for k in range(nw)]
    sn = [f"ORBWAVES{k}" for k in range(nw)]
    return je.orbits_waves(pv, t, t + off, cn, sn,
                           fb_names=fbn if form == T.WAVES_FBX else None)


@pytest.mark.parametrize("which", list(FORMS))
def test_orbit_twin_matches_reference(which):
    form, nfb, nw = FORMS[which]
    names, vals = _coef(form, nfb, nw)
    t, off = _tt0(), 1234.5678
    o_ref, p_ref = _ref(names, vals, jnp.asarray(t), form, nfb, nw, off)
    o, p, _ = K6.binary_orbits_reference(
        torch.tensor(t)[None], torch.tensor(vals)[None], form, nfb, nw, off,
        False)
    tol = 0.0 if form == T.FBX else 1e-15
    assert np.abs(o[0].numpy() / np.asarray(o_ref) - 1).max() <= tol
    assert np.abs(p[0].numpy() / np.asarray(p_ref) - 1).max() <= tol
    # the orbit count next to a whole orbit is the reference's
    assert np.floor(o[0, 0].item()) == np.floor(float(o_ref[0]))


@pytest.mark.parametrize("which", list(FORMS))
def test_orbit_partials_match_reference_jacfwd(which):
    """d(orbits, pbprime)/d(tt0, coefficients) through K6's ``jvp`` (B = 2
    points, so ``vmap`` folds) against ``jax.jacfwd`` of the reference."""
    form, nfb, nw = FORMS[which]
    names, vals = _coef(form, nfb, nw, seed=3)
    t, off = _tt0(3, 60), 98.25
    c = torch.tensor(vals)[None].expand(2, -1).clone()

    def port(cc):
        o, p = K6.binary_orbits(torch.tensor(t)[None], cc, form, nfb, nw, off)
        return torch.stack([o, p], dim=-1)

    J = jacfwd(port)(c)[0, :, :, 0, :].numpy()              # (N, 2, nc)
    Jt = jacfwd(lambda tt: K6.binary_orbits(
        tt, torch.tensor(vals)[None], form, nfb, nw, off)[0])(
        torch.tensor(t)[None])[0, :, 0, :].diagonal().numpy()

    def ref(cv):
        o, p = _ref(names, cv, jnp.asarray(t), form, nfb, nw, off)
        return jnp.stack([o, p], axis=-1)

    Jr = np.asarray(jax.jacfwd(ref)(jnp.asarray(vals)))
    scale = np.abs(Jr).max(axis=0)
    assert (np.abs(J - Jr).max(axis=0) <= 1e-10 * scale + 1e-300).all()
    Jtr = np.asarray(jax.jacfwd(lambda tt: _ref(
        names, vals, tt, form, nfb, nw, off)[0])(jnp.asarray(t))).diagonal()
    assert np.abs(Jt - Jtr).max() <= 1e-10 * np.abs(Jtr).max()


def _partials_as_before(t, c, form, nfb, nw, off, pbprime, freq):
    """One element's (2, 1 + nc) partials as the kernel wrote them before
    its tile: the pbprime row first as dg, each entry then scaled by
    -pbprime^2 (``binary_orbits.cu``'s earlier read-back)."""
    nc = len(c)
    Po, Pg = [0.0] * (1 + nc), [0.0] * (1 + nc)
    if form == T.WAVES_PB:
        pb_s = c[0] * 86400.0
        po_t = 1.0 / pb_s
        Po[1] = -((t / pb_s) / pb_s) * 86400.0
        Pg[1] = 0.0 - 86400.0 / (pb_s * pb_s)
        pg_t, first = 0.0, 1
    else:
        cn = 1.0
        for n in range(nfb):
            nxt = (cn * t) * (1.0 / (n + 1))
            Po[1 + n], Pg[1 + n], cn = nxt, cn, nxt
        dfreq = 0.0
        for n in range(nfb - 1, 0, -1):
            dfreq = (dfreq * t) * (1.0 / n) + c[n]
        po_t, pg_t, first = freq, dfreq, nfb
    if form != T.FBX:
        om, tw = c[first + 2 * nw], t + off
        g_om_o = g_om_g = 0.0
        for k in range(nw):
            cc, ss = c[first + 2 * k], c[first + 2 * k + 1]
            w = (k + 1) * om
            ph = w * tw
            sp, cp = np.sin(ph), np.cos(ph)
            rate, curv = ss * cp - cc * sp, ss * sp + cc * cp
            Po[1 + first + 2 * k], Po[2 + first + 2 * k] = cp, sp
            Pg[1 + first + 2 * k], Pg[2 + first + 2 * k] = -(w * sp), w * cp
            po_t = po_t + w * rate
            pg_t = pg_t - (w * w) * curv
            g_om_o = g_om_o + ((k + 1) * tw) * rate
            g_om_g = g_om_g + (k + 1) * rate - (w * ((k + 1) * tw)) * curv
        Po[nc], Pg[nc] = g_om_o, g_om_g
    Po[0], Pg[0] = po_t, pg_t
    m = -(pbprime * pbprime)
    return np.array([Po, [m * g for g in Pg]])


@pytest.mark.parametrize("form,nfb,nw", [(T.FBX, 4, 0), (T.WAVES_PB, 0, 60),
                                         (T.WAVES_FBX, 2, 230)])
def test_twin_partials_keep_the_layout_and_scaled_pbprime_row(form, nfb, nw):
    """K6's twin partials (B, N, 2, 1 + nc) against the kernel's formulas
    as they were before its shared-memory tile, element by element: the
    orbits row, then the pbprime row scaled by -pbprime^2.  At 60 ORBWAVES
    terms the tile of 128 threads passes 227 KB (the dual takes fewer
    threads); at 230 one warp's passes it (the direct dual).  Within
    1e-14 of each column's largest (numpy's sine against torch's)."""
    names, vals = _coef(form, nfb, nw, seed=7)
    t, off = _tt0(7, 40), 4321.5
    o, pb, P = K6.binary_orbits_reference(
        torch.tensor(t)[None], torch.tensor(vals)[None], form, nfb, nw, off)
    f = T.binary_orbits_forward(torch.tensor(t)[None],
                                torch.tensor(vals)[None], form, nfb, nw, off)
    freq = f["freq"].expand(1, len(t))[0].numpy() if "freq" in f else \
        np.zeros(len(t))
    nc = len(vals)
    assert P.shape == (1, len(t), 2, 1 + nc)
    want = np.stack([_partials_as_before(t[i], vals, form, nfb, nw, off,
                                         float(pb[0, i]), float(freq[i]))
                     for i in range(len(t))])
    got = P[0].numpy()
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want) <= 1e-14 * scale).all()


@pytest.mark.parametrize("mode", K2.MODES)
def test_k2_orbit_input_equals_the_pb_form(mode):
    """Fed ``orbits_pb``'s own output (and, for BT, PB 86400 as R's
    period), K2's orbit-input form gives the PB form's delay bitwise, and
    its partials chain to the PB form's PB and PBDOT columns."""
    rng = np.random.default_rng(mode)
    B, N = 2, 200
    row = np.tile([5.741, 1e-12, 0.0, 3.3667, 1e-14, 0.17, 1e-15, 1.35, 0.5,
                   0.3, 0.95, 1e-4, 1e-6, 1e-6, 1e-7, 1e-7], (B, 1))
    row[:, 5] = rng.uniform(0.0, 0.8, B)
    if mode == K2.DDGR:
        row[:, 10] = row[:, 3] / 0.95   # ar: sini = a1 / ar
    p = torch.tensor(row)
    t = torch.tensor(rng.uniform(-3e8, 3e8, (B, N)))
    toa = None
    if mode == K2.DDK:
        toa = tuple(torch.tensor(rng.uniform(lo, hi, (B, N)))
                    for lo, hi in ((-1e-6, 1e-6), (-1e-5, 1e-5), (0.5, 0.99)))
    elif mode == K2.BTX:
        toa = (torch.tensor(rng.uniform(3.36, 3.37, (B, N))),)
    f = {}
    T.kepler_inputs({k: p[:, i:i + 1] for i, k in enumerate(T.DD_PARAMS)},
                    t, f)
    orbits = f["frac"] - 0.5 * f["pbdot"] * f["frac"] * f["frac"]
    pbp = (p[:, :1] * 86400.0).expand(B, N) if mode in (K2.BT, K2.BTX) \
        else f["pbprime"].expand(B, N)
    d_pb, P_pb = K2.dd_binary_reference(t, p, True, mode, toa)
    d_or, P_or = K2.dd_binary_reference(t, p, True, mode, toa, (orbits, pbp))
    assert torch.equal(d_pb, d_or)
    assert P_or.shape[-1] == K2.npartial(mode) - 1
    # d delay / d PB through the orbit inputs
    g_orb, g_pbp = P_or[..., 1], P_or[..., 2]
    pb_s = p[:, :1] * 86400.0
    d_orb_dpb = -(f["frac"] * (1.0 - f["pbdot"] * f["frac"])) / pb_s * 86400
    want = g_orb * d_orb_dpb + g_pbp * 86400.0
    assert torch.allclose(want, P_pb[..., 1], rtol=1e-9,
                          atol=1e-10 * P_pb[..., 1].abs().max().item())


@pytest.mark.parametrize("mode", [K4.ELL1, K4.ELL1K, K4.ELL1H_EXACT,
                                  K4.ELL1H_HARMONIC])
def test_k4_orbit_input_equals_the_pb_form(mode):
    rng = np.random.default_rng(10 + mode)
    B, N = 2, 200
    row = [0.1388, 1e-12, 0.0, 0.0348, 1e-14, 1.5e-5, -2e-5, 1e-17, 1e-17,
           1.7, 2e-4] + ([0.2, 0.9] if mode < 2 else [1e-6, 0.0, 0.3])
    p = torch.tensor([row] * B)
    t = torch.tensor(rng.uniform(-3e8, 3e8, (B, N)))
    pb_s = p[:, :1] * 86400.0
    frac = t / pb_s
    orbits = frac - 0.5 * (p[:, 1:2] + p[:, 2:3]) * frac * frac
    orb = (orbits, pb_s + p[:, 1:2] * t)
    d_pb, _ = K4.ell1_binary_reference(t, p, mode)
    d_or, P_or = K4.ell1_binary_reference(t, p, mode, orb=orb)
    assert torch.equal(d_pb, d_or)
    assert P_or.shape[-1] == K4.npartial(mode) - 1


# ---------------------------------------------------------------------------
# the components against the reference
# ---------------------------------------------------------------------------
#: the binaries of this slice, as small stand-ins (80 TOAs)
SMALL_BW = dict(standin.BW_SETTINGS, n_epochs=20, n_subbands=4,
                mjd_start=54000.0, mjd_end=56000.0, n_dmx=3, dmx_days=700.0,
                grid_points=3)
CASES = {"fbx": SMALL_BW,
         "orbwaves": standin.SMALL_DD_FBX_SETTINGS,
         "orbwaves_fbx": dict(SMALL_BW, orbwaves=5, grid=None),
         "bt_piecewise": standin.SMALL_BT_PIECEWISE_SETTINGS}


@pytest.fixture(scope="module", params=list(CASES))
def loaded(request):
    return request.param, standin.port_and_reference(CASES[request.param])


def test_port_matches_reference_on_the_form(loaded):
    """The binary's delay within 1e-13 s and the design matrix within 1e-10
    of each column's largest, against the reference (FBX: ELL1 on FB0..FB3;
    orbwaves: DD on ORBWAVES with a PB base; orbwaves_fbx: ELL1 on ORBWAVES
    with an FBX base; bt_piecewise: BT with two pieces)."""
    which, (model, toas, m, b) = loaded
    binary = next(n for n in m.components if n.startswith("Binary"))
    got, ref = standin.component_outputs(model, toas, m, b, binary)
    assert np.abs(got - ref).max() <= 1e-13
    M, names = m.designmatrix(b)
    Mr, names_r, _ = model.designmatrix(toas)
    Mr = np.asarray(Mr)
    assert names == list(names_r)
    err = np.abs(M.numpy() - Mr).max(axis=0) / np.abs(Mr).max(axis=0)
    assert err.max() <= 1e-10


SMALL_PATHS = {"small_dd_fbx": "DD_FBX_SMALL_PATH",
               "small_bt_piecewise": "BT_PIECEWISE_SMALL_PATH"}


@pytest.mark.parametrize("key", ["postfit", "auto"])
@pytest.mark.parametrize("which", list(SMALL_PATHS))
def test_small_slice_end_to_end(which, key):
    """The committed small stand-in end to end against the reference
    outputs in its snapshot: residuals 1e-10 s; the GLS fit's and
    ``Fitter.auto``'s chi2 1e-6 rel, values 1e-2 sigma, uncertainties 1e-6
    rel; ``Fitter.auto``'s class, converged flag and steps."""
    from pint_torch import bridge
    from pint_torch.fitter import Fitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.residuals import Residuals

    path = getattr(bridge, SMALL_PATHS[which])
    meta, ref = bridge.read_snapshot(path)
    rr = meta["reference"]
    assert rr["settings"] == getattr(
        standin, which.upper() + "_SETTINGS")
    m, b = bridge.load_snapshot(path, device="cpu")
    r = Residuals(b, m).time_resids.numpy()
    assert np.abs(r - ref["ref/time_resids"]).max() <= 1e-10
    f = GLSFitter(b, m.copy()) if key == "postfit" else Fitter.auto(b, m)
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


def test_small_black_widow_grid_matches_the_reference():
    """A small black-widow slice (80 TOAs, ELL1 on FB0..FB3): the WLS fit
    and the 3 x 3 FB0 x FB1 grid at ``niter=4`` through K6 and K4's orbit
    input, against the reference's: chi2 surface 1e-6 rel, same argmin."""
    from pint_torch.bridge import load_snapshot
    from pint_torch.fitter import WLSFitter
    from pint_torch.grid import grid_chisq

    model, toas = standin.make_standin(SMALL_BW, full=False)
    snap = standin.export_wls_snapshot(model, toas, SMALL_BW, chunk=9)
    m, b = load_snapshot(snap, device="cpu")
    f = WLSFitter(b, m)
    f.fit_toas(maxiter=SMALL_BW["fit_maxiter"])
    axes = (snap["ref/grid_fb0"], snap["ref/grid_fb1"])
    c2, _ = grid_chisq(f, ("FB0", "FB1"), axes, niter=4, chunk=9)
    ref = snap["ref/grid_chi2"]
    assert np.abs(c2 / ref - 1).max() <= 1e-6
    assert np.nanargmin(c2) == np.nanargmin(ref)
