"""K9 ``chol_rank_update``: the rank-k Cholesky up/downdate of a GLS
normal-equation factor, alone or fused with a streamed block's ingest.

Replaces ``pint_tpu/streaming/lowrank.py:55`` ``_rank_pass`` (a
``lax.scan`` over the rows of ``V`` inside a scan over the columns) and
``:115`` ``ingest_kernel``.  Two entry points:

* :func:`chol_rank_update` ``(L (K,K), V (k,K), sign) -> L'``, the factor
  of ``L L^T + sign V^T V`` by LINPACK's ``dchud``/``dchdd`` sweep, row by
  row, column by column;
* :func:`stream_ingest` ``(L, b, chi2, M (k,K), r, w, dx_since, sign) ->
  (L', b', chi2', ok, cond)``: ``r_now = r - M dx_since``, ``V = sqrt(w)
  M``, the sweep, ``b' = b + sign M^T (w r_now)``, ``chi2' = chi2 + sign
  sum(w r_now^2)``, ``ok`` (every entry finite and the diagonal positive)
  and the condition proxy ``(max|d| / max(min|d|, 1e-300))^2``, ``ok``
  and ``cond`` as 0-dim float64 tensors on the factor's device.

A zero row (a pad row up to a ladder rung) leaves the factor bitwise as it
is; a downdate of rows that were never in the factor poisons it with NaN
and ``ok`` comes back false, nothing raises.

On a CUDA tensor this launches ``csrc/chol_rank_update.cu`` (or raises):
one CTA a factor, the nonzero rows of ``V`` taken as a wavefront over the
factor's columns (row m at column t - m at step t: a pass of n rows
:func:`chain_steps` long, n + K - 1 steps, instead of n K), the factor in
shared memory while it fits (K <= 223 on an H100), else in a global
scratch.  On a CPU tensor it runs the plain PyTorch version,
:func:`chol_rank_update_reference` / :func:`stream_ingest_reference`, a
sweep row by row that rounds op for op as the kernel does (each entry's
updates in row order, each sum in the kernel's order), so the factor is
bitwise the kernel's.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["chol_rank_update", "stream_ingest", "chol_rank_update_reference",
           "stream_ingest_reference", "uses_smem", "pass_rows",
           "chain_steps", "launch_counts", "REPLACES", "KERNELS"]

NAME = "chol_rank_update"
REPLACES = "pint_tpu/streaming/lowrank.py:55"
#: the ``__global__`` instantiations, by (shared-memory factor, ingest)
KERNELS = {(True, False): "chol_rank_update_smem",
           (False, False): "chol_rank_update_global",
           (True, True): "stream_ingest_smem",
           (False, True): "stream_ingest_global"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)


def _sweep(L, V, sign: float):
    """The rank-k sweep on a copy of ``L`` (the reference's operations one
    for one); a zero row of ``V`` is skipped, which gives the same bits."""
    L = L.clone()
    K = L.shape[0]
    for row in range(V.shape[0]):
        x = V[row].clone()
        if not bool((x != 0).any()):
            continue
        for j in range(K):
            d, xj = L[j, j], x[j]
            rr = torch.sqrt(d * d + sign * xj * xj)
            c, s = rr / d, xj / d
            xi = x[j + 1:]
            col = (L[j + 1:, j] + (sign * s) * xi) / c
            L[j + 1:, j] = col
            x[j + 1:] = c * xi - s * col
            L[j, j] = rr
    return L


def _ok_cond(L):
    d = torch.diagonal(L)
    ok = torch.isfinite(L).all() & (d > 0).all()
    da = torch.abs(d)
    q = da.max() / torch.clamp(da.min(), min=1e-300)
    return ok.to(F64), q * q


def chol_rank_update_reference(L, V, sign: float):
    """Plain PyTorch version of :func:`chol_rank_update`."""
    return _sweep(L, V, float(sign))


def stream_ingest_reference(L, b, chi2, M, r, w, dx_since, sign: float):
    """Plain PyTorch version of :func:`stream_ingest`: the kernel's sums
    in its order (each row's dot product over ascending columns, each
    column's and chi2's over ascending rows)."""
    sign = float(sign)
    k, K = M.shape
    acc = torch.zeros(k, dtype=F64, device=M.device)
    for j in range(K):
        acc = acc + M[:, j] * dx_since[j]
    rnow = r - acc
    wr = w * rnow
    bacc = torch.zeros(K, dtype=F64, device=M.device)
    cacc = torch.zeros((), dtype=F64, device=M.device)
    for row in range(k):
        bacc = bacc + M[row] * wr[row]
        cacc = cacc + wr[row] * rnow[row]
    L2 = _sweep(L, torch.sqrt(w)[:, None] * M, sign)
    ok, cond = _ok_cond(L2)
    return L2, b + sign * bacc, chi2 + sign * cacc, ok, cond


def _lib():
    lib = _build.load(NAME)
    fn = lib.chol_rank_update_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_double, ci, ci,
                       ci, vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
        for f in (lib.chol_rank_update_uses_smem,
                  lib.chol_rank_update_pass_rows):
            f.argtypes = [ci]
            f.restype = ci
    return lib


def uses_smem(K: int) -> bool:
    """Whether the kernel works a K-column factor in shared memory on the
    current CUDA device."""
    return bool(_lib().chol_rank_update_uses_smem(int(K)))


def pass_rows(K: int) -> int:
    """Rows of ``V`` one wavefront pass of the kernel takes at K columns
    on the current CUDA device."""
    return int(_lib().chol_rank_update_pass_rows(int(K)))


def chain_steps(K: int, rows: int) -> int:
    """Dependent column steps of a kernel call on ``rows`` nonzero rows:
    each pass of n rows n + K - 1."""
    n = pass_rows(K)
    full, rest = divmod(int(rows), n)
    return full * (n + K - 1) + (rest + K - 1 if rest else 0)


def _launch(L, V, sign, ingest=None):
    K, k = L.shape[0], V.shape[0]
    dev = L.device
    L2 = torch.empty((K, K), dtype=F64, device=dev)
    okc = torch.empty(2, dtype=F64, device=dev)
    p = _build.ptr
    if ingest is None:
        w = r = dx = b = chi2 = b2 = chi22 = rnow = None
    else:
        b, chi2, r, w, dx = ingest
        b2 = torch.empty(K, dtype=F64, device=dev)
        chi22 = torch.empty((), dtype=F64, device=dev)
        rnow = torch.empty(max(k, 1), dtype=F64, device=dev)
    args = [None if t is None else p(t)
            for t in (w, r, dx, b, chi2)]
    outs = [None if t is None else p(t) for t in (b2, chi22, rnow)]
    lib = _lib()
    smem = uses_smem(K)
    # the working factor and the pass's rows, where shared memory cannot
    # hold the factor
    work = [None, None] if smem else [
        torch.empty(K * (K + 1) // 2, dtype=F64, device=dev),
        torch.empty((pass_rows(K), K), dtype=F64, device=dev)]
    rc = lib.chol_rank_update_launch(
        p(L), p(V), *args, float(sign), K, k, int(ingest is not None),
        *(None if t is None else p(t) for t in work), p(L2), *outs, p(okc),
        _build.stream_of(L))
    launch_counts[KERNELS[(smem, ingest is not None)]] += 1
    _build.check(NAME, rc)
    if ingest is None:
        return L2
    return L2, b2, chi22, okc[0], okc[1]


def _checked(name, L, mats, vecs, sign):
    ts = (L,) + mats + vecs
    K = L.shape[0] if L.ndim == 2 else -1
    if sign not in (1.0, -1.0) \
            or any(t.dtype != F64 or t.device != L.device for t in ts) \
            or L.ndim != 2 or L.shape[1] != K or K < 1 \
            or any(m.ndim != 2 or m.shape[1] != K for m in mats):
        raise ValueError(
            f"{name}: L {tuple(L.shape)}, "
            f"{[tuple(t.shape) for t in mats + vecs]}, sign {sign!r}; want "
            "float64 (K,K), (k,K) and vectors on one device, sign +1 or -1")
    if L.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {L.device}")


def chol_rank_update(L, V, sign: float):
    """K9: the factor of ``L L^T + sign V^T V`` (module docstring)."""
    sign = float(sign)
    _checked("chol_rank_update", L, (V,), (), sign)
    L, V = L.contiguous(), V.contiguous()
    if L.is_cuda:
        return _launch(L, V, sign)
    return chol_rank_update_reference(L, V, sign)


def stream_ingest(L, b, chi2, M, r, w, dx_since, sign: float):
    """K9 fused with a block's ingest: ``(L', b', chi2', ok, cond)``
    (module docstring)."""
    sign = float(sign)
    k, K = M.shape if M.ndim == 2 else (-1, -1)
    _checked("stream_ingest", L, (M,), (b, chi2, r, w, dx_since), sign)
    if b.shape != (K,) or dx_since.shape != (K,) or r.shape != (k,) \
            or w.shape != (k,) or chi2.numel() != 1:
        raise ValueError(
            f"stream_ingest: b {tuple(b.shape)}, chi2 {tuple(chi2.shape)}, "
            f"r {tuple(r.shape)}, w {tuple(w.shape)}, dx_since "
            f"{tuple(dx_since.shape)} for M {tuple(M.shape)}")
    L, M = L.contiguous(), M.contiguous()
    vecs = tuple(t.contiguous() for t in (b, chi2.reshape(()), r, w,
                                          dx_since))
    if L.is_cuda:
        return _launch(L, M, sign, vecs)
    return stream_ingest_reference(L, vecs[0], vecs[1], M, vecs[2], vecs[3],
                                   vecs[4], sign)
