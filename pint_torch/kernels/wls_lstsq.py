"""K5 ``wls_lstsq``: per-point minimum-norm least squares with singular
values, for the WLS grid's Gauss-Newton steps.

Replaces the solve of the reference WLS grid's ``chi2_point.gn_step``
(``pint_tpu/grid.py:309-321``), for a batch of P points at once::

    norms = ||Aw[:, j]||, 0 -> 1
    x, sv = lstsq(Aw / norms, rw)      (jnp.linalg.lstsq, rcond None)

``lstsq`` is the SVD pseudo-inverse with the cutoff ``rcond = eps *
max(N, k)``: singular values kept where ``s > 0`` and ``s >= rcond *
s[0]``, the rest dropped (a zero column's direction gets 0).  Inputs
``Aw`` (P, N, k) and ``rw`` (P, N), float64; returns ``(x (P, k), sv
(P, k) in descending order, norms (P, k))``.  A point with any
non-finite input gets NaN ``x`` and ``sv``, which the caller turns into
ladder rung -1, as the reference's ``all(isfinite(sv))`` does.  The
solve is never differentiated, so there is no autograd wrapper.

On a CUDA tensor this launches ``csrc/wls_lstsq.cu`` (or raises): one
block per point, Householder QR of the normalized matrix in a workspace
this wrapper allocates (the inputs are left untouched), then a one-sided
Jacobi SVD of the k x k triangle, in shared memory while it fits (k <= 119
on an H100), else in a second workspace.  A point whose Jacobi sweeps do
not converge within :data:`MAX_SWEEPS` gets NaN ``x`` and ``sv``.  On a
CPU tensor it runs :func:`wls_lstsq_reference`, the reference's own
algorithm (``torch.linalg.svd``, then the same mask and products); the
two agree to rounding, not bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["wls_lstsq", "wls_lstsq_reference", "launch_counts", "REPLACES",
           "KERNELS", "MAX_SWEEPS", "SMEM_MAX_K"]

NAME = "wls_lstsq"
REPLACES = "pint_tpu/grid.py:314"
#: the ``__global__`` of ``csrc/wls_lstsq.cu``
KERNELS = {None: "wls_lstsq"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)

#: Jacobi sweeps after which a point that still rotates is poisoned
MAX_SWEEPS = 30
#: the largest k whose R and V (2 k^2 doubles) stay in shared memory
SMEM_MAX_K = 119

_EPS = torch.finfo(F64).eps


def wls_lstsq_reference(Aw, rw):
    """Plain PyTorch version of K5: the reference's normalized SVD
    least squares, point by point (batched)."""
    P, N, k = Aw.shape
    norms = torch.sqrt(torch.sum(Aw * Aw, dim=1))
    norms = torch.where(norms == 0, 1.0, norms)
    bad = ~(torch.isfinite(Aw).all(dim=(1, 2)) & torch.isfinite(rw).all(dim=1))
    An = torch.where(bad[:, None, None], 0.0, Aw / norms[:, None, :])
    U, s, Vh = torch.linalg.svd(An, full_matrices=False)
    rcond = _EPS * max(N, k)
    mask = (s > 0) & (s >= rcond * s[:, :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    uTb = (U.transpose(1, 2) @ torch.where(bad[:, None], 0.0, rw)[:, :, None])
    x = (Vh.transpose(1, 2) @ (s_inv[:, :, None] * uTb))[..., 0]
    nan = torch.full_like(x, float("nan"))
    return (torch.where(bad[:, None], nan, x),
            torch.where(bad[:, None], nan, s), norms)


def _lib():
    lib = _build.load(NAME)
    fn = lib.wls_lstsq_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(Aw, rw):
    """``(x, sv, norms, sweeps)``: ``sweeps`` (P,) int32 counts the Jacobi
    sweeps each point ran (the last one rotates nothing)."""
    P, N, k = Aw.shape
    dev = Aw.device
    work = torch.empty((P, k, N), dtype=F64, device=dev)
    rwork = torch.empty((P, N), dtype=F64, device=dev)
    rv = torch.empty((P, 2, k, k), dtype=F64, device=dev) \
        if k > SMEM_MAX_K else None
    x = torch.empty((P, k), dtype=F64, device=dev)
    sv = torch.empty((P, k), dtype=F64, device=dev)
    norms = torch.empty((P, k), dtype=F64, device=dev)
    sweeps = torch.empty((P,), dtype=torch.int32, device=dev)
    rc = _lib().wls_lstsq_launch(
        _build.ptr(Aw), _build.ptr(rw), P, N, k, _build.ptr(work),
        _build.ptr(rwork), _build.ptr(rv) if rv is not None else None,
        _build.ptr(x), _build.ptr(sv), _build.ptr(norms), _build.ptr(sweeps),
        _build.stream_of(Aw))
    launch_counts[KERNELS[None]] += 1
    _build.check(NAME, rc)
    return x, sv, norms, sweeps


def wls_lstsq(Aw, rw):
    """K5 (see the module docstring): ``(x, sv, norms)``."""
    if Aw.dtype != F64 or rw.dtype != F64 or Aw.device != rw.device \
            or Aw.ndim != 3 or rw.shape != Aw.shape[:2] or Aw.shape[2] < 1:
        raise ValueError(
            f"wls_lstsq: Aw {tuple(Aw.shape)} {Aw.dtype} on {Aw.device}, rw "
            f"{tuple(rw.shape)} {rw.dtype} on {rw.device}; want float64 "
            "(P,N,k) and (P,N) on one device")
    if Aw.is_cuda:
        return _launch(Aw.contiguous(), rw.contiguous())[:3]
    if Aw.device.type != "cpu":
        raise ValueError(f"wls_lstsq: no kernel for device {Aw.device}")
    return wls_lstsq_reference(Aw, rw)
