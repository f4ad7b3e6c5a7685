"""K11's backward (``pint_torch/kernels/compensated_matmul.py``, through its
plain twin) against ``jax.vjp`` of the reference's ``_matmul_jnp``
(``pint_tpu/precision/compensated.py:163``) on the CPU, in all eight
(compute dtype, accumulation) modes.

* both cotangents bitwise the reference's in every mode but float32
  ``native``, on the flow's coupling shapes ((64, in) @ (in, 32) and
  (64, 32) @ (32, out)), off-tile shapes, a batched ``a`` with a shared
  ``b`` (its ``db`` one contraction over the batch and rows), equal batch
  axes and 1-D operands: the float64 sums of the cotangent's products
  round to the compute dtype, so the order of those sums (the twin's is
  the kernel's, one product at a time) does not reach the result here;
* float32 ``native`` sums float32 products in float32, in an order XLA's
  CPU dot does not expose (neither a sequential sum, fused or not, nor
  numpy's order repeats it): held at the forward's standing ``native``
  bar, ``2 C 2^-24 (|x| @ |y|)`` over the contraction C of each product;
* ``precision.matmul`` under a reduced spec records
  ``CompensatedMatmul`` when an operand requires grad, and its gradient
  is the backward's bitwise; a broadcast ``b`` batch is refused.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

pytestmark = pytest.mark.torch

MODES = [(ct, acc) for ct in ("float32", "bfloat16")
         for acc in ("native", "f64", "two_sum", "two_prod")]
#: the flow's coupling products at n_samples 64 (ell1's 5 free
#: parameters split 2/3 over hidden 32), off-tile, batched and 1-D
SHAPES = [((64, 2), (2, 32)), ((64, 32), (32, 3)), ((64, 3), (3, 32)),
          ((7, 37), (37, 5)), ((3, 9, 40), (40, 4)),
          ((2, 5, 19), (2, 19, 6)), ((29,), (29, 4)), ((6, 29), (29,))]


def _operands(sa, sb, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(sa) * np.exp(rng.uniform(-3, 3, sa))
    b = rng.standard_normal(sb) * np.exp(rng.uniform(-3, 3, sb))
    g = rng.standard_normal(np.broadcast_shapes(
        (np.zeros(sa) @ np.zeros(sb)).shape))
    return a, b, g


def _reference_vjp(a, b, g, ct, acc):
    import jax
    import jax.numpy as jnp
    from pint_tpu.precision.compensated import _matmul_jnp
    from pint_tpu.precision.policy import SegmentSpec

    spec = SegmentSpec("flow.coupling", compute_dtype=ct, accumulation=acc)
    _, fn = jax.vjp(lambda x, y: _matmul_jnp(x, y, spec, 8),
                    jnp.asarray(a), jnp.asarray(b))
    return tuple(np.asarray(x) for x in fn(jnp.asarray(g)))


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"{m[0]}-{m[1]}")
def test_backward_twin_matches_jax_vjp(mode, shapes):
    from pint_torch.kernels.compensated_matmul import \
        compensated_matmul_backward

    ct, acc = mode
    a, b, g = _operands(*shapes, seed=len(shapes[0]) * 11 + shapes[0][-1])
    ra, rb = _reference_vjp(a, b, g, ct, acc)
    pa, pb = (x.numpy() for x in compensated_matmul_backward(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(g), ct,
        acc))
    assert pa.shape == ra.shape == a.shape and pb.shape == rb.shape == b.shape
    if (ct, acc) != ("float32", "native"):
        assert np.array_equal(pa, ra) and np.array_equal(pb, rb)
        return
    # float32 native: the rounded operands' float32 sums, any order
    a2 = a[None, :] if a.ndim == 1 else a
    b2 = b[:, None] if b.ndim == 1 else b
    g2 = g.reshape(*a2.shape[:-2], a2.shape[-2], b2.shape[-1])
    gc, ac, bc = (np.abs(x.astype(np.float32).astype(np.float64))
                  for x in (g2, a2, b2))
    n = b2.shape[-1]
    bar_a = 2.0 * n * 2.0 ** -24 * (gc @ np.swapaxes(bc, -1, -2))
    terms_b = np.swapaxes(ac, -1, -2) @ gc
    rows = a2.shape[-2]
    if b2.ndim == 2 and a2.ndim > 2:
        terms_b = terms_b.reshape(-1, *terms_b.shape[-2:]).sum(axis=0)
        rows = int(np.prod(a2.shape[:-1]))
    bar_b = 2.0 * rows * 2.0 ** -24 * terms_b
    assert np.all(np.abs(pa - ra) <= bar_a.reshape(pa.shape))
    assert np.all(np.abs(pb - rb) <= bar_b.reshape(pb.shape))


@pytest.mark.parametrize("mode", MODES, ids=lambda m: f"{m[0]}-{m[1]}")
def test_policy_matmul_gradient_is_the_backwards(mode):
    from pint_torch import precision as P
    from pint_torch.kernels import compensated_matmul as K11

    ct, acc = mode
    a, b, g = _operands((64, 3), (3, 32), seed=4)
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    spec = P.SegmentSpec(segment="flow.coupling", compute_dtype=ct,
                         accumulation=acc)
    out = P.matmul(ta, tb, spec)
    assert out.grad_fn is not None \
        and type(out.grad_fn).__name__ == "CompensatedMatmulBackward"
    with torch.no_grad():
        assert torch.equal(out, K11.compensated_matmul(ta, tb, ct, acc))
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    wa, wb = K11.compensated_matmul_backward(ta.detach(), tb.detach(),
                                             torch.from_numpy(g), ct, acc)
    assert torch.equal(ga, wa) and torch.equal(gb, wb)
    # without grad the forward alone, as before
    with torch.no_grad():
        assert P.matmul(ta, tb, spec).grad_fn is None


def test_broadcast_b_batch_is_refused():
    from pint_torch.kernels.compensated_matmul import \
        compensated_matmul_backward

    a = torch.ones((4, 3), dtype=torch.float64)
    b = torch.ones((2, 3, 5), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="broadcasts b"):
        compensated_matmul_backward(a, b, torch.ones((2, 4, 5),
                                                     dtype=torch.float64),
                                    "float32", "f64")
