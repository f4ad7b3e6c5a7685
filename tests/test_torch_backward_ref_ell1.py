"""Reverse mode through K4 against the reference's engines, on the CPU:
K4's delay under ``torch.autograd.grad`` against ``jax.grad`` of the
reference's ``ell1_delay``, ``ell1k_delay`` or ``ell1h_delay`` (exact, and
harmonic with stigma from H4/H3) per row, each gradient within 1e-10 of
its sum of |terms| (the terms from ``jax.jacfwd``), the entries a form
does not read exactly 0.
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
import test_torch_backward_ref as tr  # noqa: E402
import test_torch_ell1h as e1h  # noqa: E402

from pint_torch.kernels import ell1_binary as K4  # noqa: E402

pytestmark = pytest.mark.torch

_t = tb._t
_k4_inputs = tb._k4_inputs
_ref_grad = tr._ref_grad
K4_FORMS = tb.K4_FORMS


@pytest.mark.parametrize("form", list(K4_FORMS))
def test_ell1_family_gradient_matches_reference_jax_grad(form):
    """K4's backward against ``jax.grad`` of the reference's ``ell1_delay``,
    ``ell1k_delay`` or ``ell1h_delay`` per row, within 1e-10 of each
    gradient's sum of |terms|."""
    from pint_tpu.models.binary import engines as eng

    tt, P, mode, use_h4 = _k4_inputs(form, 71 + len(form))
    g = np.random.default_rng(7).standard_normal(tt.shape)
    names = K4.ELL1H_PARAMS if mode in (K4.ELL1H_EXACT,
                                        K4.ELL1H_HARMONIC) \
        else K4.ELL1_PARAMS
    if mode in (K4.ELL1H_EXACT, K4.ELL1H_HARMONIC):
        ref = e1h._ref("exact" if mode == K4.ELL1H_EXACT
                       else "harmonic-h4", 7)
        unread = ("OMDOT", "LNEDOT", "STIGMA" if use_h4 else "H4")
    else:
        fn = eng.ell1k_delay if mode == K4.ELL1K else eng.ell1_delay
        ref = fn
        unread = () if mode == K4.ELL1K else ("OMDOT", "LNEDOT")
    pr = P.clone().requires_grad_(True)
    tr = tt.clone().requires_grad_(True)
    d = K4.ell1_binary(tr, pr, mode, 7, use_h4)
    gp, gt = torch.autograd.grad((d * _t(g)).sum(), [pr, tr])
    for b in range(P.shape[0]):
        pv = {n: float(P[b, i]) for i, n in enumerate(names)
              if n not in unread}
        want_p, want_t = _ref_grad(ref, pv, tt[b].numpy(), g[b])
        keys = list(pv)
        J = np.asarray(jax.jit(jax.jacfwd(lambda x: ref(
            {n: x[i] for i, n in enumerate(keys)}, jnp.asarray(
                tt[b].numpy()))))(jnp.asarray([pv[n] for n in keys])))
        scale = np.abs(g[b]) @ np.abs(J)
        for i, n in enumerate(names):
            if n in unread:
                assert float(gp[b, i]) == 0.0, n
                continue
            j = keys.index(n)
            assert abs(float(gp[b, i]) - float(want_p[n])) \
                <= 1e-10 * max(scale[j], 1e-300), n
        wt = np.asarray(want_t)
        assert np.abs(gt[b].numpy() - wt).max() <= 1e-10 * np.abs(wt).max()
