"""K12 ``hd_cross_grad``'s plain version on the CPU, on small_catalog (16
pulsars, 3 GWB modes: R = 96) at the ingest state on the reference's
residuals: against ``jax.grad`` of the reference's batched
``_joint_kernel`` at the 48 stored likelihood points (stored by
``tests/test_torch_snapshot.py --settings small_catalog --amortized`` as
``ref/amortized/k12_grad``), within 1e-8 x max(1, |ref|); the joint
likelihood's tensor entry point ``lnlike_fn`` carrying the same gradient
through K10's backward; exactly 0.0 at zero amplitude.  The kernel itself
is held against this plain version on the card by ``chip_smoke.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import test_torch_amortized_catalog as tc  # noqa: E402

pytestmark = pytest.mark.torch

F64 = torch.float64
P = tc.P


@pytest.fixture(scope="module")
def cat():
    return tc.catalog_vi()


def test_k12_plain_version_is_jax_grad_of_the_joint_kernel(cat):
    from pint_torch.kernels.hd_cross_lnlike import hd_cross_grad

    _, jl, _, ref = cat
    pts = ref["ref/catalog/likelihood/points"]
    want = ref[P + "k12_grad"]
    assert pts.shape == want.shape == (48, 2)
    got = hd_cross_grad(jl.G, jl.u, torch.tensor(pts[:, 0]),
                        torch.tensor(pts[:, 1]), jl._freqs_t,
                        jl.Tspan).numpy()
    assert np.all(np.abs(got - want) <= 1e-8 * np.maximum(1.0,
                                                          np.abs(want)))
    x = torch.tensor(pts, requires_grad=True)
    (g,) = torch.autograd.grad(jl.lnlike_fn()(x).sum(), x)
    assert torch.equal(g, torch.as_tensor(got))
    zero = hd_cross_grad(jl.G, jl.u,
                         torch.tensor([-np.inf, -np.inf], dtype=F64),
                         torch.tensor([13.0 / 3.0, 2.0], dtype=F64),
                         jl._freqs_t, jl.Tspan)
    assert bool((zero == 0.0).all())
