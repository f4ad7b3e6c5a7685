"""Reverse mode through the hand kernels, on the CPU.

Each kernel's :class:`torch.autograd.Function` saves its local partials P
at the forward and its ``backward`` contracts the output cotangent with
them (:mod:`pint_torch.kernels.dual`); on CPU tensors the plain twin
computes P.  Held here:

* each Function's ``backward`` (a seeded cotangent through
  ``torch.autograd.grad``, inputs broadcast along the batch where the
  wrappers allow it) within 1e-10 rel of the same cotangent contracted
  with ``torch.func.jacrev`` of its twin: K1; K2 in its five modes (DD,
  BT, DDGR, DDK with its per-TOA inputs, BTX with its per-TOA a1) and on
  orbit inputs; K4's ELL1, ELL1k, ELL1H exact and harmonic and on orbit
  inputs; K6's FBX and waves forms; K7 with windows;
* K6's and K7's against ``jax.grad`` of the reference's orbits and
  geometry (K2's and K4's in ``test_torch_backward_ref.py``).

The batched lnposterior's gradient through them is held in
``test_torch_posterior_grad.py``.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import jacrev

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import test_torch_ell1h as e1h  # noqa: E402
import test_torch_orbits as orb  # noqa: E402

from pint_torch.kernels import binary_orbits as K6  # noqa: E402
from pint_torch.kernels import dd_binary as K2  # noqa: E402
from pint_torch.kernels import ell1_binary as K4  # noqa: E402
from pint_torch.kernels import solar_wind_pl as K7  # noqa: E402
from pint_torch.kernels import spin_phase as K1  # noqa: E402

pytestmark = pytest.mark.torch

F64 = torch.float64
#: backward against the cotangent-contracted jacrev of the twin
REV_BAR = 1e-10


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def _check_vjp(fn, twin, args, seed=0):
    """``fn``'s backward (a seeded cotangent per output) against ``jacrev``
    of ``twin`` contracted with it, for every tensor argument, within
    :data:`REV_BAR` of the largest |term|."""
    rng = np.random.default_rng(seed)
    args = [a.clone().requires_grad_(True) for a in args]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [_t(rng.standard_normal(o.shape)) for o in outs]
    got = torch.autograd.grad(outs, args, cots, allow_unused=True)
    for i, a in enumerate(args):
        J = jacrev(twin, argnums=i)(*[x.detach() for x in args])
        J = J if isinstance(J, tuple) else (J,)
        want = sum((c.reshape(c.shape + (1,) * a.ndim) * j).reshape(
            -1, *a.shape).sum(0) for c, j in zip(cots, J))
        scale = sum((c.abs().reshape(c.shape + (1,) * a.ndim) * j.abs())
                    .reshape(-1, *a.shape).sum(0) for c, j in zip(cots, J))
        g = torch.zeros_like(a) if got[i] is None else got[i]
        assert g.shape == a.shape
        err = (g - want).abs()
        assert bool((err <= REV_BAR * scale.max().clamp(min=1e-300)).all()), \
            (i, float(err.max()), float(scale.max()))


# -- K1 ---------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 3])
def test_spin_phase_backward_matches_jacrev_of_the_twin(S):
    rng = np.random.default_rng(21 + S)
    B, N = 3, 40
    th = _t(np.round(rng.uniform(-2.0**34, 2.0**34, N)))
    tl = _t(rng.uniform(-1e-6, 1e-6, N))
    pe = _t(np.stack([55000.0 + rng.uniform(-100, 100, B),
                      rng.uniform(-1e-12, 1e-12, B)], axis=1))
    dl = _t(rng.uniform(-500.0, 500.0, (B, N)))
    F = _t(np.array([[300.0, -1e-14, 1e-25][:S]]))   # shared by the batch

    def fn(pe, dl, F):
        return K1.spin_phase(th, tl, 55000.0, pe, dl, F)[1]

    def twin(pe, dl, F):
        return K1.spin_phase_reference(th, tl, 55000.0, pe, dl, F,
                                       partials=False)[1]

    _check_vjp(fn, twin, [pe, dl, F], seed=S)


# -- K2 ---------------------------------------------------------------------
def _k2_row(mode, seed, B=3, N=30):
    rng = np.random.default_rng(seed)
    base = dict(PB=5.741, PBDOT=-3e-12, XPBDOT=1e-13, A1=3.37, A1DOT=2e-14,
                ECC=0.3, EDOT=1e-17, OM=87.0, OMDOT=0.02, M2=0.3, SINI=0.97,
                GAMMA=2e-5, DR=3e-6, DTH=-1e-6, A0=2e-7, B0=-1e-7)
    names = K2.DDGR_PARAMS if mode == K2.DDGR else K2.DD_PARAMS
    if mode == K2.DDGR:
        # B1913+16's row as ``ddgr_row`` derives it
        base.update(PB=0.322997448918, A1=2.341776, ECC=0.617, K=1.0376e-5,
                    M2S=6.8415e-6, AR=3.19428, GAMMA=4.3018e-3)
    p = np.array([[base[k] * (1 + 1e-4 * rng.standard_normal())
                   for k in names] for _ in range(B)])
    tt0 = rng.uniform(-3e8, 3e8, (B, N))
    toa = None
    if mode == K2.DDK:
        toa = [_t(rng.uniform(-1e-6, 1e-6, (B, N))),
               _t(rng.uniform(-1e-6, 1e-6, (B, N))),
               _t(rng.uniform(0.9, 0.99, (B, N)))]
    elif mode == K2.BTX:
        toa = [_t(3.37 + rng.uniform(-1e-3, 1e-3, (B, N)))]
    return _t(tt0), _t(p), toa


def _orbit_inputs(tt0, p):
    """Orbits and pbprime (B, N) as K6 would hand them: PB's orbit count
    with a small quadratic term, pbprime PB in seconds with a slope."""
    pb = p[:, :1] * 86400.0
    return [tt0 / pb + 1e-3 * (tt0 / 3e8) ** 2, pb * (1.0 + 1e-9 * tt0
                                                    / 3e8)]


@pytest.mark.parametrize("orbit", [False, True], ids=["pb", "orbit"])
@pytest.mark.parametrize("mode", [K2.DD, K2.BT, K2.DDGR, K2.DDK, K2.BTX],
                         ids=["DD", "BT", "DDGR", "DDK", "BTX"])
def test_dd_binary_backward_matches_jacrev_of_the_twin(mode, orbit):
    tt0, p, toa = _k2_row(mode, 31 + mode)
    n_toa = len(toa or ())
    extra = []
    if orbit:
        extra = _orbit_inputs(tt0, p)

    def split(args):
        t, pp, *rest = args
        return t, pp, tuple(rest[:n_toa]) or None, \
            tuple(rest[n_toa:]) or None

    def fn(*args):
        t, pp, x, o = split(args)
        return K2.dd_binary(t, pp, mode, x, o)

    def twin(*args):
        t, pp, x, o = split(args)
        return K2.dd_binary_reference(t, pp, False, mode, x, o)[0]

    _check_vjp(fn, twin, [tt0, p[:1]] + list(toa or ()) + extra,
               seed=mode)


# -- K4 ---------------------------------------------------------------------
K4_FORMS = {"ELL1": (K4.ELL1, False), "ELL1k": (K4.ELL1K, False),
            "ELL1H_exact": (K4.ELL1H_EXACT, False),
            "ELL1H_harmonic": (K4.ELL1H_HARMONIC, True)}


def _k4_inputs(form, seed):
    mode, use_h4 = K4_FORMS[form]
    if mode in (K4.ELL1H_EXACT, K4.ELL1H_HARMONIC):
        t, P = e1h._orbits(seed, use_h4, B=3, N=40)
        return _t(t), _t(P), mode, use_h4
    rng = np.random.default_rng(seed)
    base = dict(PB=1.5334, PBDOT=1e-12, XPBDOT=2e-13, A1=1.898,
                A1DOT=1e-14, EPS1=3e-3, EPS2=-5e-3, EPS1DOT=1e-16,
                EPS2DOT=-2e-16, OMDOT=1.7, LNEDOT=2e-4, M2=0.21, SINI=0.998)
    P = np.array([[base[k] * (1 + 1e-3 * rng.standard_normal())
                   for k in K4.ELL1_PARAMS] for _ in range(3)])
    return _t(rng.uniform(-2e8, 2e8, (3, 40))), _t(P), mode, use_h4


@pytest.mark.parametrize("orbit", [False, True], ids=["pb", "orbit"])
@pytest.mark.parametrize("form", list(K4_FORMS))
def test_ell1_binary_backward_matches_jacrev_of_the_twin(form, orbit):
    tt, P, mode, use_h4 = _k4_inputs(form, 61 + len(form))
    extra = []
    if orbit:
        extra = _orbit_inputs(tt, P)

    def fn(t, p, *o):
        return K4.ell1_binary(t, p, mode, 7, use_h4, tuple(o) or None)

    def twin(t, p, *o):
        return K4.ell1_binary_reference(t, p, mode, False, 7, use_h4,
                                        tuple(o) or None)[0]

    _check_vjp(fn, twin, [tt, P] + extra, seed=len(form))


# -- K6, K7 -----------------------------------------------------------------
@pytest.mark.parametrize("which", list(orb.FORMS))
def test_binary_orbits_backward_matches_twin_and_reference(which):
    """Both outputs' cotangents through K6's backward against ``jacrev``
    of the twin, and against ``jax.grad`` of the reference's orbits."""
    form, nfb, nw = orb.FORMS[which]
    names, vals = orb._coef(form, nfb, nw, seed=9)
    t, off = orb._tt0(9, 50), 98.25
    tt = _t(t)[None].expand(2, -1).clone()
    c = _t(vals)[None]

    def fn(tt, c):
        return K6.binary_orbits(tt, c, form, nfb, nw, off)

    def twin(tt, c):
        o, p, _ = K6.binary_orbits_reference(tt, c, form, nfb, nw, off,
                                             False)
        return o, p

    _check_vjp(fn, twin, [tt, c], seed=nfb + nw)
    rng = np.random.default_rng(10)
    go, gb = rng.standard_normal(t.shape), rng.standard_normal(t.shape)

    def loss(cv, tv):
        o, p = orb._ref(names, cv, tv, form, nfb, nw, off)
        return jnp.sum(go * o) + jnp.sum(gb * p)

    wc, wt = jax.grad(loss, argnums=(0, 1))(jnp.asarray(vals),
                                            jnp.asarray(t))
    cr = c.clone().requires_grad_(True)
    tr = _t(t)[None].requires_grad_(True)
    o, p = fn(tr, cr)
    gc, gt = torch.autograd.grad((o * _t(go)).sum() + (p * _t(gb)).sum(),
                                 [cr, tr])
    wc, wt = np.asarray(wc), np.asarray(wt)
    assert np.all(np.abs(gc[0].numpy() - wc) <= 1e-10 * np.abs(wc).max())
    assert np.all(np.abs(gt[0].numpy() - wt) <= 1e-10 * np.abs(wt).max())


def test_solar_wind_backward_matches_twin_and_reference():
    """K7's backward with per-window indices (TOAs outside every window)
    against ``jacrev`` of the twin; with one window against ``jax.grad``
    of the reference's geometry in theta and p (through I_inf)."""
    from pint_tpu.models.solar_wind import solar_wind_geometry_pl

    rng = np.random.default_rng(12)
    N = 60
    r = _t(np.linspace(490.0, 510.0, N))
    th = _t(np.radians(rng.uniform(5.0, 175.0, (2, N))))
    p = _t([[2.0, 2.5, 3.1]])
    win = torch.tensor(rng.integers(-1, 3, N))

    def fn(th, p):
        return K7.solar_wind_pl(r, th, p, K7.sw_i_inf(p), win)

    def twin(th, p):
        return K7._twin(r, th, p, K7.sw_i_inf(p), win, False)[0]

    _check_vjp(fn, twin, [th, p], seed=3)
    g = rng.standard_normal(N)
    wth, wp = jax.grad(lambda t, q: jnp.sum(g * solar_wind_geometry_pl(
        jnp.asarray(r.numpy()), t, q)), argnums=(0, 1))(
        jnp.asarray(th[0].numpy()), 2.5)
    tr = th[:1].clone().requires_grad_(True)
    pr = _t([[2.5]]).requires_grad_(True)
    out = K7.solar_wind_pl(r, tr, pr, K7.sw_i_inf(pr))
    gth, gp = torch.autograd.grad((out * _t(g)[None]).sum(), [tr, pr])
    wth = np.asarray(wth)
    assert np.all(np.abs(gth[0].numpy() - wth) <= 1e-10 * np.abs(wth).max())
    assert abs(float(gp) - float(wp)) <= 1e-10 * abs(float(wp))
