"""Reverse mode through K2 against the reference's engines, on the CPU:
the components' delay (the rows, DDS's, DDH's and DDGR's
reparameterizations and DDK's corrections in torch, as the components
build them, then the kernel's twin) under ``torch.autograd.grad`` against
``jax.grad`` of the reference's engine, each gradient within 1e-10 of its
sum of |terms| (the terms from ``jax.jacfwd``); BTX's per-TOA a1 against
``bt_delay`` with A1 per TOA.  K4's (ELL1, ELL1k, ELL1H) are in
``test_torch_backward_ref_ell1.py``, the Functions' own ``backward``
against ``jacrev`` of their twins in ``test_torch_backward.py``.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import test_torch_backward as tb  # noqa: E402
import test_torch_ddfamily as ddf  # noqa: E402

from pint_torch.kernels import dd_binary as K2  # noqa: E402

pytestmark = pytest.mark.torch

_t = tb._t
_k2_row = tb._k2_row


def _ref_grad(fn, pv, t, g):
    """jax.grad of sum(g * fn(pv, t)) in (pv, t)."""
    def loss(pv, t):
        return jnp.sum(g * fn(pv, t))
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in pv.items()}, jnp.asarray(t))


@pytest.mark.parametrize("model", ["BT", "DD", "DDS", "DDH", "DDGR", "DDK"])
def test_dd_family_gradient_matches_reference_jax_grad(model):
    """The components' delay (the row and DDK's corrections in torch, then
    K2) under ``torch.autograd.grad`` against ``jax.grad`` of the
    reference's engine, each gradient within 1e-10 of its sum of |terms|
    (the terms from ``jax.jacfwd``)."""
    pv, t = ddf._orbit(model, 0.617, seed=41 + len(model))
    sky = ddf._sky(13) if model == "DDK" else None
    g = np.random.default_rng(5).standard_normal(t.shape)
    fn = ddf._ref_fn(model, sky)
    want_p, want_t = _ref_grad(fn, pv, t, g)
    names = list(pv)
    J = np.asarray(jax.jit(jax.jacfwd(lambda x: fn(
        {n: x[i] for i, n in enumerate(names)}, jnp.asarray(t))))(
        jnp.asarray([pv[n] for n in names])))
    scale = np.abs(g) @ np.abs(J)
    vals = {n: _t([[pv[n]]]).requires_grad_(True) for n in names}
    tt0 = _t(t)[None].requires_grad_(True)
    d = ddf._port_delay(model, vals, tt0, sky)
    got = torch.autograd.grad((d * _t(g)[None]).sum(),
                              [vals[n] for n in names] + [tt0])
    for i, n in enumerate(names):
        assert abs(float(got[i]) - float(want_p[n])) <= 1e-10 * scale[i], n
    Jt = np.asarray(jax.jit(lambda s: jax.jvp(lambda s: fn(
        {k: jnp.asarray(v) for k, v in pv.items()}, s), (s,),
        (jnp.ones_like(s),))[1])(jnp.asarray(t)))
    assert np.all(np.abs(got[-1][0].numpy() - np.asarray(want_t))
                  <= 1e-10 * np.abs(g * Jt).max())


def test_btx_gradient_matches_reference_jax_grad():
    """BTX: K2's per-TOA a1 against ``bt_delay`` with A1 per TOA."""
    tt0, p, (a1,) = _k2_row(K2.BTX, 51, B=1)
    g = np.random.default_rng(6).standard_normal(tt0.shape)
    pv = {k: float(p[0, i]) for i, k in enumerate(K2.DD_PARAMS)
          if k in ddf.READS["BT"]}
    pv["A1"] = a1[0].numpy()
    from pint_tpu.models.binary import engines as eng

    want_p, want_t = _ref_grad(eng.bt_delay, pv, tt0[0].numpy(), g[0])
    a1r = a1.clone().requires_grad_(True)
    pr = p.clone().requires_grad_(True)
    tr = tt0.clone().requires_grad_(True)
    d = K2.dd_binary(tr, pr, K2.BTX, (a1r,))
    ga, gp, gt = torch.autograd.grad((d * _t(g)).sum(), [a1r, pr, tr])
    assert np.allclose(ga[0].numpy(), np.asarray(want_p["A1"]), rtol=1e-10,
                       atol=1e-10 * np.abs(np.asarray(want_p["A1"])).max())
    for i, k in enumerate(K2.DD_PARAMS):
        if k in pv and k != "A1":
            w = float(want_p[k])
            assert abs(float(gp[0, i]) - w) <= 1e-9 * max(abs(w), 1e-300), k
    assert np.allclose(gt[0].numpy(), np.asarray(want_t), rtol=1e-10,
                       atol=1e-10 * np.abs(np.asarray(want_t)).max())
