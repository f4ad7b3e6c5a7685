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

On a CUDA tensor this launches ``csrc/wls_lstsq.cu`` (or raises).  For
k up to the source's ``wls_lstsq_tiled_max_k()`` (111 on an H100) the
tiled kernels run: ``wls_tsqr_fold``, one block per point, reads the
point's row-major matrix once, in tiles of 128 rows copied into shared
memory, and folds them into a running triangle of ``[Aw | rw]`` by a
Householder QR blocked 8 reflectors at a time, its trailing updates on the
float64 tensor cores.  ``wls_tsqr_svd`` scales the triangle's columns by
``1 / norms`` and runs a one-sided Jacobi SVD of its transpose in shared
memory, then the mask and ``x``.  Besides its outputs this wrapper
allocates only the points' triangles, sums of squares and NaN flags: ``P
(k (k + 1) + k + 1)`` doubles, 16 MB at P = 256, k = 88.  Above that k
the triangle and a tile no longer fit a block's shared memory and
``wls_lstsq_global``, the untiled kernel, runs: one block per point,
Householder QR of the normalized matrix in a transposed ``(P, k, N)``
workspace (``P k N`` doubles), the Jacobi's R and V in shared memory up
to ``SMEM_MAX_K`` (119), else in a second workspace.  :func:`design`
reads these limits, the tile, WY block and Jacobi settings and the sweep
cap from the built library.  A point whose Jacobi sweeps do not converge
within ``MAX_SWEEPS`` gets NaN ``x`` and ``sv``.  Each tiled kernel has
its plain version (:func:`fold_reference`, :func:`svd_reference`).  On a
CPU tensor the wrapper runs :func:`wls_lstsq_reference`, the reference's
own algorithm (``torch.linalg.svd``, then the same mask and products);
kernels and twin agree to rounding, not bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["wls_lstsq", "wls_lstsq_reference", "fold_reference",
           "svd_reference", "design", "launch_counts", "REPLACES",
           "KERNELS"]

NAME = "wls_lstsq"
REPLACES = "pint_tpu/grid.py:314"
#: the ``__global__``s of ``csrc/wls_lstsq.cu``: the tiled path's fold and
#: SVD, and the global-workspace kernel past the tiled path's k
KERNELS = {"fold": "wls_tsqr_fold", "svd": "wls_tsqr_svd",
           "global": "wls_lstsq_global"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)

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


def fold_reference(Aw, rw):
    """Plain PyTorch version of ``wls_tsqr_fold``, laid out as its
    workspace (P, k (k + 1) + k + 1): rows 0..k-1 of the R of ``[Aw | rw]``
    (zero rows past its rank; each row's sign is the algorithm's to choose,
    so compare rows up to sign), the column sums of squares of ``Aw`` and
    the NaN flag."""
    P, N, k = Aw.shape
    aug = torch.cat([Aw, rw[:, :, None]], dim=2)
    bad = ~torch.isfinite(aug).all(dim=(1, 2))
    R = torch.linalg.qr(torch.where(bad[:, None, None], 0.0, aug),
                        mode="r").R[:, :k]
    tri = torch.zeros((P, k, k + 1), dtype=F64, device=Aw.device)
    tri[:, :R.shape[1]] = R
    return torch.cat([tri.reshape(P, -1), (Aw * Aw).sum(dim=1),
                      bad.to(F64)[:, None]], dim=1)


def svd_reference(ws, N, k):
    """Plain PyTorch version of ``wls_tsqr_svd`` on the fold's workspace:
    its triangles' columns scaled by the norms, then the reference's SVD
    least squares on the k x k triangle; ``(x, sv, norms)``."""
    P = ws.shape[0]
    nt = k * (k + 1)
    norms = torch.sqrt(ws[:, nt:-1])
    norms = torch.where(norms == 0, 1.0, norms)
    bad = ws[:, -1] != 0
    R = ws[:, :nt].reshape(P, k, k + 1)
    U, s, Vh = torch.linalg.svd(torch.where(
        bad[:, None, None], 0.0, R[:, :, :k] / norms[:, None, :]))
    rcond = _EPS * max(N, k)
    mask = (s > 0) & (s >= rcond * s[:, :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    uTc = U.transpose(1, 2) @ torch.where(bad[:, None, None], 0.0,
                                          R[:, :, k:])
    x = (Vh.transpose(1, 2) @ (s_inv[:, :, None] * uTc))[..., 0]
    nan = torch.full_like(x, float("nan"))
    return (torch.where(bad[:, None], nan, x),
            torch.where(bad[:, None], nan, s), norms)


def _lib():
    lib = _build.load(NAME)
    fn = lib.wls_lstsq_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, ci, vp]
        fn.restype = ci
        g = lib.wls_lstsq_global_launch
        g.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        g.restype = ci
        lib.wls_lstsq_ws_doubles.argtypes = [ci]
        lib.wls_lstsq_ws_doubles.restype = ci
        lib.wls_lstsq_design.restype = ctypes.c_char_p
    return lib


@functools.cache
def design() -> dict:
    """The built kernels' design, from the library (``wls_lstsq_design``):
    ``TILE`` rows a tile, ``NB`` reflectors a WY block, ``ACC`` sums a
    slice, ``JG`` lanes a Jacobi pair, ``FOLD_THREADS``, ``SVD_THREADS``,
    ``SVD_BLOCKS`` an SM, ``MAX_SWEEPS``, ``TILED_MAX_K`` (the largest k
    the tiled path takes) and ``SMEM_MAX_K`` (the largest k whose R and V
    the global kernel keeps in shared memory).  Builds the kernel."""
    words = _lib().wls_lstsq_design().decode().split()
    return {n: int(v) for n, v in (w.split("=") for w in words)}


def _launch(Aw, rw):
    """``(x, sv, norms, sweeps)``: ``sweeps`` (P,) int32 counts the Jacobi
    sweeps each point ran (the last one rotates nothing)."""
    if Aw.shape[2] > design()["TILED_MAX_K"]:
        return _launch_global(Aw, rw)
    return _launch_svd(_launch_fold(Aw, rw), Aw.shape[1], Aw.shape[2])


def _launch_fold(Aw, rw):
    """``wls_tsqr_fold``: the workspace (P, k (k + 1) + k + 1) of the
    points' triangles (rows 0..k-1 of ``[Aw | rw]``'s R), column sums of
    squares and NaN flags."""
    P, N, k = Aw.shape
    lib = _lib()
    ws = torch.empty((P, lib.wls_lstsq_ws_doubles(k)), dtype=F64,
                     device=Aw.device)
    rc = lib.wls_lstsq_launch(
        _build.ptr(Aw), _build.ptr(rw), P, N, k, _build.ptr(ws), None, None,
        None, None, 1, _build.stream_of(Aw))
    launch_counts[KERNELS["fold"]] += 1
    _build.check(NAME, rc)
    return ws


def _launch_svd(ws, N, k):
    """``wls_tsqr_svd`` on the fold's workspace: ``(x, sv, norms,
    sweeps)``."""
    P = ws.shape[0]
    dev = ws.device
    x = torch.empty((P, k), dtype=F64, device=dev)
    sv = torch.empty((P, k), dtype=F64, device=dev)
    norms = torch.empty((P, k), dtype=F64, device=dev)
    sweeps = torch.empty((P,), dtype=torch.int32, device=dev)
    rc = _lib().wls_lstsq_launch(
        None, None, P, N, k, _build.ptr(ws), _build.ptr(x), _build.ptr(sv),
        _build.ptr(norms), _build.ptr(sweeps), 2, _build.stream_of(ws))
    launch_counts[KERNELS["svd"]] += 1
    _build.check(NAME, rc)
    return x, sv, norms, sweeps


def _launch_global(Aw, rw):
    """``wls_lstsq_global``, for k past the tiled path's."""
    P, N, k = Aw.shape
    dev = Aw.device
    x = torch.empty((P, k), dtype=F64, device=dev)
    sv = torch.empty((P, k), dtype=F64, device=dev)
    norms = torch.empty((P, k), dtype=F64, device=dev)
    sweeps = torch.empty((P,), dtype=torch.int32, device=dev)
    work = torch.empty((P, k, N), dtype=F64, device=dev)
    rwork = torch.empty((P, N), dtype=F64, device=dev)
    rv = torch.empty((P, 2, k, k), dtype=F64, device=dev) \
        if k > design()["SMEM_MAX_K"] else None
    rc = _lib().wls_lstsq_global_launch(
        _build.ptr(Aw), _build.ptr(rw), P, N, k, _build.ptr(work),
        _build.ptr(rwork), _build.ptr(rv) if rv is not None else None,
        _build.ptr(x), _build.ptr(sv), _build.ptr(norms), _build.ptr(sweeps),
        _build.stream_of(Aw))
    launch_counts[KERNELS["global"]] += 1
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
