"""K11 ``compensated_matmul``: a float64 matrix product from operands rounded
to a reduced compute dtype, re-entering float64 by an accumulation mode.

Replaces ``pint_tpu/precision/compensated.py:163`` ``_matmul_jnp`` with its
operand split (``:152`` ``_dd_split_jnp``) and fold (``:121``
``two_sum_accumulate``): the reduced-precision matmul of the precision
layer's segments (:func:`pint_torch.precision.matmul`).  ``a`` is
``(..., m, k)`` or ``(k,)``, ``b`` ``(..., k, n)`` or ``(k,)``, both float64,
batch axes broadcast as ``torch.matmul`` broadcasts them; the result is
float64 of ``torch.matmul``'s shape.  ``compute_dtype`` is ``"float32"`` or
``"bfloat16"``; ``accumulation`` one of :data:`ACCUMULATIONS`:

* ``native``: products and sum in float32, the sum rounded to the compute
  dtype and widened;
* ``f64``: the rounded operands' exact products summed in float64;
* ``two_sum``: float64 partials over the blocks of :func:`split_bounds`
  (the reference's ``_split_slices(k, split)``), folded in block order by
  :func:`fold_partials`;
* ``two_prod``: the operands split into reduced ``hi + lo`` pairs, the
  float64 sums ``hi@hi``, ``hi@lo``, ``lo@hi`` folded in that order.

On a CUDA tensor this launches ``csrc/compensated_matmul.cu`` on PyTorch's
current stream, so a CUDA-graph capture holds it: the float64-accumulated
modes on the float64 tensor cores after a pass that rounds (and splits)
each operand once into scratch (:func:`_copies`), native bfloat16 on the
bfloat16 tensor cores, native float32 on the CUDA cores; ``two_sum`` folds
each block's partial as the block ends; where the output tiles cannot
fill the card, a split of the contraction with a second pass that sums
(or folds) the parts in order.  All scratch is allocated here; a failed
build or launch raises.  On a CPU tensor it runs
:func:`compensated_matmul_reference`, the plain version, which follows the
reference's arithmetic step by step: the casts, ``torch.matmul`` in
float64 of the rounded parts for each block or pass, and the fold.

The backward (:class:`CompensatedMatmul`, an ``autograd.Function``; the
reference differentiates ``_matmul_jnp`` with ``jax.vjp`` inside
``amortized/train.py:103``'s ``value_and_grad``) is a second kernel of the
same source, ``compensated_matmul_bwd``, which computes both cotangents in
one launch, with :func:`compensated_matmul_backward_reference` its plain
version: the jaxpr of ``jax.vjp`` operation for operation (the roundings
to the compute dtype and its additions in their order), each float64 or
float32 sum taken one product at a time in ascending contraction index in
kernel and twin alike, so the two agree bitwise.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from pint_torch import F64
from pint_torch.exceptions import UsageError
from pint_torch.kernels import _build

__all__ = ["compensated_matmul", "compensated_matmul_reference",
           "compensated_matmul_backward",
           "compensated_matmul_backward_reference", "CompensatedMatmul",
           "split_bounds", "round_to", "fold_partials", "two_sum",
           "launch_counts", "REPLACES", "REPLACES_BWD", "KERNELS",
           "BWD_KERNELS", "ACCUMULATIONS", "MAX_BLOCKS"]

NAME = "compensated_matmul"
REPLACES = "pint_tpu/precision/compensated.py:163"
ACCUMULATIONS = ("native", "f64", "two_sum", "two_prod")
_MODE = {acc: i for i, acc in enumerate(ACCUMULATIONS)}
_CT = {"float32": (0, "f32"), "bfloat16": (1, "bf16")}
#: the ``__global__`` instantiations, by (accumulation, compute dtype)
KERNELS = {(acc, ct): f"compensated_matmul_{acc}_{short}"
           for acc in ACCUMULATIONS for ct, (_, short) in _CT.items()}
#: the backward's instantiations, by (accumulation, compute dtype)
BWD_KERNELS = {(acc, ct): f"compensated_matmul_bwd_{acc}_{short}"
               for acc in ACCUMULATIONS for ct, (_, short) in _CT.items()}
#: what the backward replaces: ``jax.vjp`` of ``_matmul_jnp`` under the
#: amortized training step's ``value_and_grad``
REPLACES_BWD = "pint_tpu/amortized/train.py:103"
launch_counts = dict.fromkeys(list(KERNELS.values())
                              + list(BWD_KERNELS.values()), 0)
#: the most contraction blocks a two_sum launch takes (the kernel's
#: by-value boundary table)
MAX_BLOCKS = 256


class _Bounds(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("b", ctypes.c_int * (MAX_BLOCKS + 1))]


def split_bounds(k: int, split: int) -> List[int]:
    """The contraction-block boundaries of the reference's
    ``_split_slices(k, split)``: ``split`` near-equal blocks of ``range(k)``
    (fewer when ``k`` is small), empty blocks dropped; ``[0, ..., k]``."""
    n = max(1, min(int(split), int(k)))
    bounds = np.linspace(0, k, n + 1).astype(int)
    out = [int(bounds[0])]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            out.append(int(hi))
    return out


def round_to(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and held in that dtype: float64 to
    float32 by round to nearest even, to bfloat16 through float32 (twice
    rounded, as the reference's astype and the kernel do)."""
    if compute_dtype == "float32":
        return x.to(torch.float32)
    if compute_dtype == "bfloat16":
        return x.to(torch.float32).to(torch.bfloat16)
    raise UsageError(f"compensated_matmul: compute dtype {compute_dtype!r} "
                     "is neither float32 nor bfloat16")


def two_sum(a, b):
    """Knuth's branch-free two_sum: ``(s, e)`` with ``s + e == a + b``."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fold_partials(partials):
    """The reference's ``two_sum_accumulate``: ``hi + lo`` of the partials
    carried as a compensated (hi, lo) pair, in order."""
    partials = list(partials)
    if not partials:
        raise UsageError("two_sum_accumulate needs at least one partial")
    hi = partials[0]
    lo = None
    for p in partials[1:]:
        hi, e = two_sum(hi, p)
        lo = e if lo is None else lo + e
    return hi if lo is None else hi + lo


def compensated_matmul_reference(a, b, compute_dtype: str, accumulation: str,
                                 split: int = 8):
    """Plain PyTorch version of K11 (the reference's ``_matmul_jnp`` step by
    step)."""
    _check_modes(compute_dtype, accumulation)
    if accumulation == "two_prod":
        ah = round_to(a, compute_dtype)
        al = round_to(a - ah.to(F64), compute_dtype)
        bh = round_to(b, compute_dtype)
        bl = round_to(b - bh.to(F64), compute_dtype)
        ah64, al64, bh64, bl64 = (t.to(F64) for t in (ah, al, bh, bl))
        return fold_partials([torch.matmul(ah64, bh64),
                              torch.matmul(ah64, bl64),
                              torch.matmul(al64, bh64)])
    al = round_to(a, compute_dtype)
    bl = round_to(b, compute_dtype)
    if accumulation == "native":
        prod = torch.matmul(al.to(torch.float32), bl.to(torch.float32))
        return round_to(prod, compute_dtype).to(F64) \
            if compute_dtype == "bfloat16" else prod.to(F64)
    a64, b64 = al.to(F64), bl.to(F64)
    if accumulation == "f64":
        return torch.matmul(a64, b64)
    bounds = split_bounds(a.shape[-1], split)
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        bb = b64[lo:hi] if b64.ndim == 1 else b64[..., lo:hi, :]
        parts.append(torch.matmul(a64[..., lo:hi], bb))
    return fold_partials(parts)


def _check_modes(compute_dtype, accumulation):
    if compute_dtype not in _CT:
        raise UsageError(f"compensated_matmul: compute dtype "
                         f"{compute_dtype!r} is neither float32 nor bfloat16")
    if accumulation not in _MODE:
        raise UsageError(f"compensated_matmul: accumulation "
                         f"{accumulation!r} not in {ACCUMULATIONS}")


def _lib():
    lib = _build.load(NAME)
    if lib.compensated_matmul_launch.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.compensated_matmul_launch.argtypes = [
            vp, ll, ll, ll, vp, ll, ll, ll, vp, vp, vp, vp, vp, vp, ci, ci,
            ci, ci, ci, ci, ci, _Bounds, vp]
        lib.compensated_matmul_launch.restype = ci
        lib.compensated_matmul_splits.argtypes = [ci] * 7
        lib.compensated_matmul_splits.restype = ci
        lib.compensated_matmul_init.restype = ci
        _build.check(NAME, lib.compensated_matmul_init())
        lib.compensated_matmul_bwd_launch.argtypes = [
            vp, ll, ll, ll, vp, ll, ll, ll, vp, ll, ll, ll, vp, vp, ci, ci,
            ci, ci, ci, ci, vp]
        lib.compensated_matmul_bwd_launch.restype = ci
    return lib


#: the source's padding of the float64 tensor-core modes' rounded copies:
#: rows of A to PAD_M, the contraction to TK, columns of B to PAD_N
_PAD_M, _PAD_K, _PAD_N = 64, 16, 64


def _copies(a3, b3, accumulation):
    """Scratch for the rounded copies the float64 tensor-core modes make of
    ``a3`` and ``b3`` (hi, and lo under two_prod; one copy of an operand
    shared by the batch): ``(tensors, (ahi, alo, bhi, blo))``, the
    pointers for the launch and the tensors to hold until it is queued;
    null pointers under native."""
    if accumulation == "native":
        return (), (None,) * 4
    B, m, k = a3.shape
    n = b3.shape[-1]

    def up(x, p):
        return -(-x // p) * p

    mp, kp, np_ = up(m, _PAD_M), up(k, _PAD_K), up(n, _PAD_N)
    ba = 1 if B == 1 or a3.stride(0) == 0 else B
    bb = 1 if B == 1 or b3.stride(0) == 0 else B
    two = accumulation == "two_prod"
    a_t = torch.empty((2 if two else 1, ba, mp, kp), dtype=F64,
                      device=a3.device)
    b_t = torch.empty((2 if two else 1, bb, kp, np_), dtype=F64,
                      device=a3.device)
    return (a_t, b_t), (_build.ptr(a_t[0]), _build.ptr(a_t[1]) if two
                        else None, _build.ptr(b_t[0]),
                        _build.ptr(b_t[1]) if two else None)


def _launch(a3, b3, compute_dtype, accumulation, bounds):
    """The kernel on 3-D operands ``a3`` (B, m, k), ``b3`` (B, k, n) of any
    strides: (B, m, n)."""
    B, m, k = a3.shape
    n = b3.shape[-1]
    out = torch.empty((B, m, n), dtype=F64, device=a3.device)
    if B == 0 or m == 0 or n == 0:
        return out
    if accumulation != "two_sum":
        bounds = [0, k]
    nparts = len(bounds) - 1
    if nparts > MAX_BLOCKS:
        raise UsageError(f"compensated_matmul: {nparts} two_sum blocks, "
                         f"more than the kernel's {MAX_BLOCKS}")
    bd = _Bounds()
    bd.n = nparts
    for i, v in enumerate(bounds):
        bd.b[i] = v
    ct, _ = _CT[compute_dtype]
    mode = _MODE[accumulation]
    lib = _lib()
    splits = lib.compensated_matmul_splits(B, m, n, k, mode, ct, nparts)
    # split-K's parts: (splits x (2 under two_prod), B, m, n), here so that
    # a CUDA-graph capture holds them
    part = out if splits == 1 else torch.empty(
        (splits * (2 if accumulation == "two_prod" else 1), B, m, n),
        dtype=F64, device=a3.device)
    held, copies = _copies(a3, b3, accumulation)
    rc = lib.compensated_matmul_launch(
        _build.ptr(a3), *a3.stride(), _build.ptr(b3), *b3.stride(),
        _build.ptr(out), _build.ptr(part), *copies, B, m, n, k, mode, ct,
        splits, bd, _build.stream_of(a3))
    del held
    launch_counts[KERNELS[(accumulation, compute_dtype)]] += 1
    _build.check(NAME, rc)
    return out


def compensated_matmul(a, b, compute_dtype: str, accumulation: str,
                       split: int = 8):
    """K11: ``a @ b`` under ``(compute_dtype, accumulation)`` (see the module
    docstring)."""
    _check_modes(compute_dtype, accumulation)
    if a.dtype != F64 or b.dtype != F64 or a.device != b.device \
            or a.ndim < 1 or b.ndim < 1 or a.shape[-1] != \
            (b.shape[0] if b.ndim == 1 else b.shape[-2]):
        raise ValueError(
            f"compensated_matmul: a {tuple(a.shape)} {a.dtype}, b "
            f"{tuple(b.shape)} {b.dtype}; want float64 (..., m, k) or (k,) "
            "and (..., k, n) or (k,) on one device")
    k = a.shape[-1]
    bounds = split_bounds(k, split)
    if accumulation == "two_sum" and len(bounds) < 2:
        raise UsageError("two_sum_accumulate needs at least one partial")
    if a.device.type == "cpu":
        return compensated_matmul_reference(a, b, compute_dtype,
                                            accumulation, split)
    if not a.is_cuda:
        raise ValueError(f"compensated_matmul: no kernel for device "
                         f"{a.device}")
    a2 = a[None, :] if a.ndim == 1 else a
    b2 = b[:, None] if b.ndim == 1 else b
    batch = torch.broadcast_shapes(a2.shape[:-2], b2.shape[:-2])
    m, n = a2.shape[-2], b2.shape[-1]
    a3 = a2.expand(*batch, m, k).reshape(-1, m, k)
    b3 = b2.expand(*batch, k, n).reshape(-1, k, n)
    out = _launch(a3, b3, compute_dtype, accumulation, bounds)
    out = out.reshape(*batch, m, n)
    if b.ndim == 1:
        out = out[..., 0]
    if a.ndim == 1:
        out = out[..., 0, :] if b.ndim > 1 else out[..., 0]
    return out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------
def _seq_matmul(x, y):
    """``x (B, M, C) @ y (B, C, N)`` in ``x``'s dtype with each sum taken
    one product at a time in ascending ``C``, from 0: the kernel's order."""
    B, M, C = x.shape
    acc = torch.zeros((B, M, y.shape[-1]), dtype=x.dtype, device=x.device)
    for c in range(C):
        acc = acc + x[:, :, c:c + 1] * y[:, c:c + 1, :]
    return acc


def _ct_add(x, y, compute_dtype):
    """A compute-dtype addition: float32, rounded to bfloat16 under
    bfloat16 (values held in float32)."""
    return round_to(x + y, compute_dtype).to(torch.float32)


def _fold_pair(hi, lo, compute_dtype):
    """The ``two_prod`` cotangent from its hi and lo operands' float64
    sums: ``f64(H) + f64(ct((L + H) - H))``."""
    h = round_to(hi, compute_dtype).to(torch.float32)
    lo = round_to(lo, compute_dtype).to(torch.float32)
    s = _ct_add(_ct_add(lo, h, compute_dtype), -h, compute_dtype)
    return h.to(F64) + s.to(F64)


def compensated_matmul_backward_reference(a3, b3, g3, compute_dtype: str,
                                          accumulation: str):
    """Plain PyTorch version of K11's backward on 3-D operands ``a3`` (B,
    m, k), ``b3`` (B, k, n) and the cotangent ``g3`` (B, m, n), all float64:
    ``(da (B, m, k), db (B, k, n))``, float64 (see the kernel's source)."""
    _check_modes(compute_dtype, accumulation)
    at, bt = a3.transpose(1, 2), b3.transpose(1, 2)
    f32 = torch.float32
    if accumulation == "native":
        gc = round_to(g3, compute_dtype).to(f32)
        da = _seq_matmul(gc, round_to(bt, compute_dtype).to(f32))
        db = _seq_matmul(round_to(at, compute_dtype).to(f32), gc)
        return (round_to(da, compute_dtype).to(F64),
                round_to(db, compute_dtype).to(F64))
    if accumulation != "two_prod":
        da = _seq_matmul(g3, round_to(bt, compute_dtype).to(F64))
        db = _seq_matmul(round_to(at, compute_dtype).to(F64), g3)
        return (round_to(da, compute_dtype).to(F64),
                round_to(db, compute_dtype).to(F64))

    def split(x):
        hi = round_to(x, compute_dtype)
        return hi.to(F64), round_to(x - hi.to(F64), compute_dtype).to(F64)

    ah, al = split(at)
    bh, bl = split(bt)
    da = _fold_pair(_seq_matmul(g3, bh), _seq_matmul(g3, bl), compute_dtype)
    db = _fold_pair(_seq_matmul(ah, g3), _seq_matmul(al, g3), compute_dtype)
    return da, db


def _launch_backward(a3, b3, g3, compute_dtype, accumulation):
    """The backward kernel on 3-D operands of any strides: (da, db)."""
    B, m, k = a3.shape
    n = b3.shape[-1]
    da = torch.empty((B, m, k), dtype=F64, device=a3.device)
    db = torch.empty((B, k, n), dtype=F64, device=a3.device)
    if B == 0 or k == 0 or (m == 0 and n == 0):
        return da, db
    ct, _ = _CT[compute_dtype]
    rc = _lib().compensated_matmul_bwd_launch(
        _build.ptr(a3), *a3.stride(), _build.ptr(b3), *b3.stride(),
        _build.ptr(g3), *g3.stride(), _build.ptr(da), _build.ptr(db), B, m,
        k, n, _MODE[accumulation], ct, _build.stream_of(a3))
    launch_counts[BWD_KERNELS[(accumulation, compute_dtype)]] += 1
    _build.check(NAME, rc)
    return da, db


def _backward_3d(a3, b3, g3, compute_dtype, accumulation):
    if a3.device.type == "cpu":
        return compensated_matmul_backward_reference(a3, b3, g3,
                                                     compute_dtype,
                                                     accumulation)
    if not a3.is_cuda:
        raise ValueError(f"compensated_matmul_backward: no kernel for "
                         f"device {a3.device}")
    return _launch_backward(a3, b3, g3, compute_dtype, accumulation)


def compensated_matmul_backward(a, b, g, compute_dtype: str,
                                accumulation: str):
    """K11's backward: ``(da, db)``, the cotangents of ``a @ b`` under
    ``(compute_dtype, accumulation)`` at the output cotangent ``g``, as the
    reference's ``jax.vjp`` computes them.  ``a`` (m, k) or (k,) and ``b``
    (k, n) or (k,); or both with the same batch axes; or ``a`` batched and
    ``b`` 2-D, where ``a``'s batch folds into its rows so that ``db`` is
    one contraction over them, rounded once as the reference's is.  Other
    broadcasts raise: no caller differentiates them."""
    _check_modes(compute_dtype, accumulation)
    a2 = a[None, :] if a.ndim == 1 else a
    b2 = b[:, None] if b.ndim == 1 else b
    m, k, n = a2.shape[-2], a2.shape[-1], b2.shape[-1]
    lead = a2.shape[:-2]
    if b2.ndim > 2 and lead != b2.shape[:-2]:
        raise NotImplementedError(
            f"compensated_matmul_backward: a {tuple(a.shape)} @ b "
            f"{tuple(b.shape)} broadcasts b's batch; only a shared 2-D b or "
            "equal batch axes are differentiated")
    g2 = g.reshape(*lead, m, n)
    if b2.ndim == 2:
        da3, db3 = _backward_3d(a2.reshape(1, -1, k), b2[None],
                                g2.reshape(1, -1, n), compute_dtype,
                                accumulation)
        da, db = da3.reshape(*lead, m, k), db3[0]
    else:
        da3, db3 = _backward_3d(a2.reshape(-1, m, k), b2.reshape(-1, k, n),
                                g2.reshape(-1, m, n), compute_dtype,
                                accumulation)
        da, db = da3.reshape(*lead, m, k), db3.reshape(*lead, k, n)
    return da.reshape(a.shape), db.reshape(b.shape)


class CompensatedMatmul(torch.autograd.Function):
    """``a @ b`` under a reduced spec with K11's backward: forward
    :func:`compensated_matmul`, backward
    :func:`compensated_matmul_backward` (the kernel on the card, its twin
    on the CPU)."""

    @staticmethod
    def forward(ctx, a, b, compute_dtype, accumulation, split):
        ctx.save_for_backward(a, b)
        ctx.modes = (compute_dtype, accumulation)
        return compensated_matmul(a, b, compute_dtype, accumulation, split)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = compensated_matmul_backward(a, b, g.contiguous(),
                                             *ctx.modes)
        return (da if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None, None, None, None)
