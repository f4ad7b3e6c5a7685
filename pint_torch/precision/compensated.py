"""Compensated-accumulation primitives of the precision segments (port of
``pint_tpu/precision/compensated.py``).

The consumers call these in place of a bare ``a @ b`` or ``.to(dtype)``:
the operands round to the segment's compute dtype once and the product
re-enters float64 through the spec's accumulation mode (``native``,
``f64``, ``two_sum``, ``two_prod``; :mod:`pint_torch.precision.policy`).
On tensors a reduced :func:`matmul` is kernel K11
(:mod:`pint_torch.kernels.compensated_matmul`): on the card the hand
kernel, on the CPU its plain twin.  Given numpy operands the same
semantics run on the host through the twin, as the reference's
``_matmul_np`` runs them in numpy.

The float64 default spec short-circuits to the plain ``a @ b`` --
bit-identical by construction, which is what lets every consumer route
through this module unconditionally.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch.exceptions import UsageError
from pint_torch.kernels.compensated_matmul import (CompensatedMatmul,
                                                   compensated_matmul)
from pint_torch.kernels.compensated_matmul import \
    fold_partials as two_sum_accumulate
from pint_torch.kernels.compensated_matmul import round_to, split_bounds
from pint_torch.precision.policy import COMPUTE_DTYPES, SegmentSpec

__all__ = ["downcast", "promote_f64", "matmul", "two_sum_accumulate",
           "DEFAULT_SPLIT"]

#: default number of contraction-axis blocks of ``two_sum`` accumulation
DEFAULT_SPLIT = 8


def downcast(x, compute_dtype: str):
    """``x`` rounded to ``compute_dtype``; a ``float64`` request is the
    identity.  A tensor comes back in that dtype (bfloat16 through float32,
    rounded twice as the reference's astype rounds it); a numpy array as
    float32 holding the rounded values (numpy has no bfloat16)."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise UsageError(f"downcast target {compute_dtype!r} not in "
                         f"{COMPUTE_DTYPES}")
    if compute_dtype == "float64":
        return x
    if isinstance(x, np.ndarray):
        return round_to(torch.from_numpy(np.asarray(x, dtype=np.float64)),
                        compute_dtype).to(torch.float32).numpy()
    return round_to(x, compute_dtype)


def promote_f64(x):
    """Segment-boundary upcast back to float64 (numpy or tensor)."""
    if isinstance(x, np.ndarray):
        return x.astype(np.float64)
    return x.to(F64)


def _split_slices(k: int, split: int):
    """The reference's static contraction-axis blocks: ``split``
    near-equal slices of range(k) (fewer when k is small)."""
    b = split_bounds(k, split)
    return [slice(lo, hi) for lo, hi in zip(b[:-1], b[1:])]


def matmul(a, b, spec: Optional[SegmentSpec] = None,
           split: int = DEFAULT_SPLIT):
    """Policy matmul: ``a @ b`` computed under ``spec``.

    ``spec=None`` or a float64 spec is EXACTLY ``a @ b`` (the same op, the
    same bits, no K11 launch).  A reduced spec rounds the operands to the
    compute dtype once and re-enters float64 through the spec's
    accumulation: kernel K11 on CUDA tensors, its plain twin on CPU tensors
    and on numpy operands (returned as numpy).  Where autograd records
    (an operand that requires grad), the product is
    :class:`~pint_torch.kernels.compensated_matmul.CompensatedMatmul`, whose
    backward is K11's backward kernel (its twin on the CPU): the gradient
    ``jax.vjp`` of the reference's reduced matmul gives."""
    if spec is None or not spec.reduced:
        return a @ b
    host = isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
    if host:
        a = torch.from_numpy(np.asarray(a, dtype=np.float64))
        b = torch.from_numpy(np.asarray(b, dtype=np.float64))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        dev = b.device if isinstance(a, np.ndarray) else a.device
        a = torch.as_tensor(a, dtype=F64, device=dev)
        b = torch.as_tensor(b, dtype=F64, device=dev)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return CompensatedMatmul.apply(a, b, spec.compute_dtype,
                                       spec.accumulation, split)
    out = compensated_matmul(a, b, spec.compute_dtype, spec.accumulation,
                             split)
    return out.numpy() if host else out
