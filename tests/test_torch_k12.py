"""K12 ``hd_cross_grad``'s plain version on the CPU, on small_catalog (16
pulsars, 3 GWB modes: R = 96) at the ingest state on the reference's
residuals: against ``jax.grad`` of the reference's batched
``_joint_kernel`` at the 48 stored likelihood points (stored by
``tests/test_torch_snapshot.py --settings small_catalog --amortized`` as
``ref/amortized/k12_grad``), within 1e-8 x max(1, |ref|); the joint
likelihood's tensor entry point ``lnlike_fn`` carrying the same gradient
through K10's backward; exactly 0.0 at zero amplitude.

Value and gradient from one factor: ``hd_cross_value_and_grad``'s plain
version gives K10's plain value bitwise and the gradient above; through
``_CrossTerm`` a forward and backward on CPU tensors run
``factor_columns`` once (none more in the backward), and without a
gradient the forward is K10's alone.  The kernels' left-looking inverse
(row blocks of NB, every earlier row's products in ascending order over
column tiles, then the in-block triangle and the pivot) emulated in plain
torch gives the plain version's gradient bitwise.  The kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``.
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


def test_value_and_gradient_come_from_one_factor(cat):
    """The twin's value is K10's plain value bitwise and its gradient the
    plain gradient above; ``_CrossTerm`` on CPU tensors factors once a
    forward-and-backward, and not at all in the backward."""
    from pint_torch.kernels import hd_cross_lnlike as K10

    _, jl, _, ref = cat
    pts = torch.tensor(ref["ref/catalog/likelihood/points"][:12])
    la, ga = pts[:, 0].contiguous(), pts[:, 1].contiguous()
    args = (jl.G, jl.u, la, ga, jl._freqs_t, jl.Tspan)
    v, g = K10.hd_cross_value_and_grad_reference(*args)
    assert torch.equal(v, K10.hd_cross_lnlike_reference(*args))
    v2, g2 = K10.hd_cross_value_and_grad(*args)
    assert torch.equal(v2, v) and torch.equal(g2, g)
    assert torch.equal(K10.hd_cross_grad(*args), g)
    calls, orig = [], K10.factor_columns

    def counted(*a):
        calls.append("factor")
        return orig(*a)

    K10.factor_columns = counted
    try:
        x = pts.clone().requires_grad_(True)
        out = K10.hd_cross_lnlike(jl.G, jl.u, x[:, 0], x[:, 1], jl._freqs_t,
                                  jl.Tspan)
        assert calls == ["factor"]
        (gx,) = torch.autograd.grad(out.sum(), x)
        assert calls == ["factor"]
        with torch.no_grad():
            K10.hd_cross_lnlike(*args)
        assert calls == ["factor", "factor"]
    finally:
        K10.factor_columns = orig
    assert torch.equal(out.detach(), v)
    assert torch.equal(gx, g)


def _left_looking_inverse(L, piv, nb, tile):
    """The kernels' inverse order in plain torch: for each row block of
    ``nb`` rows and each column tile of ``tile`` columns, every earlier row
    j >= the tile's first column subtracted in ascending j (a zero product
    where j is below the column), then the in-block rows and the pivot."""
    B, R = piv.shape
    X = torch.zeros((B, R, R), dtype=F64)
    for i0 in range(0, R, nb):
        i1 = min(R, i0 + nb)
        for c0 in range(0, i1, tile):
            c1 = min(c0 + tile, i1)
            acc = torch.zeros((B, i1 - i0, c1 - c0), dtype=F64)
            for j in range(c0, i0):
                acc = acc - L[:, i0:i1, j:j + 1] * X[:, j:j + 1, c0:c1]
            for r in range(i1 - i0):
                i = i0 + r
                x = acc[:, r, :].clone()
                for c in range(c0, c1):
                    if c == i:
                        x[:, c - c0] = 1.0
                    elif c > i:
                        x[:, c - c0] = 0.0
                for jj in range(i0, i):
                    x = x - L[:, i, jj:jj + 1] * X[:, jj, c0:c1]
                X[:, i, c0:c1] = x / piv[:, i:i + 1]
    return X


@pytest.mark.parametrize("nb,tile", [(8, 8), (8, 16), (5, 5)],
                         ids=["square", "wide", "ragged"])
def test_left_looking_order_is_the_plain_versions_bitwise(nb, tile):
    """The inverse's left-looking blocked order, at small blocks and a
    ragged last block, gives the plain version's L^-1 and gradient
    bitwise: each entry receives the same rounded products in ascending
    j, then its division."""
    from pint_torch.kernels import hd_cross_lnlike as K10

    rng = np.random.default_rng(22)
    A = rng.normal(size=(40, 24))
    G = torch.as_tensor(A.T @ A * 1e14)
    u = torch.as_tensor(rng.normal(size=24) * 1e7)
    f = torch.tensor([1.0 / 3e8, 2.0 / 3e8, 3.0 / 3e8], dtype=F64)
    la = torch.tensor([-14.0, -13.2, -14.6], dtype=F64)
    ga = torch.tensor([4.33, 3.1, 5.0], dtype=F64)
    R = G.shape[0]
    L = torch.zeros((3, R, R), dtype=F64)
    piv = torch.zeros((3, R), dtype=F64)
    z = torch.zeros((3, R), dtype=F64)
    for j, (p, col) in enumerate(K10.factor_columns(G, u, la, ga, f, 3e8)):
        piv[:, j], L[:, j + 1:, j], z[:, j] = p, col[:, :-1], col[:, -1]
    X = _left_looking_inverse(L, piv, nb, tile)
    # the plain version's X, as _grad_from_factor forms it
    Xp = torch.eye(R, dtype=F64).repeat(3, 1, 1)
    for j in range(R):
        Xp[:, j, :j + 1] = Xp[:, j, :j + 1] / piv[:, j:j + 1]
        Xp[:, j + 1:, :j + 1] -= L[:, j + 1:, j:j + 1] * Xp[:, j:j + 1,
                                                             :j + 1]
    assert torch.equal(X, Xp)
    assert torch.equal(K10._grad_from_factor(L, piv, z, f),
                       K10.hd_cross_grad_reference(G, u, la, ga, f, 3e8))
