"""K3 ``schur_cholesky_solve``: per-point diag-normalized Cholesky solve.

Replaces the tail of the reference grid's ``chi2_point.gn_step``
(``pint_tpu/grid.py:737-765``, CPU branch) for a batch of points:

    an  = sqrt(max(diag(Ar), 1e-300))
    Arn = Ar / (an an^T) + ridge I
    L   = cholesky(Arn);  x = cho_solve(L, rhs / an) / an
    ok  = all(isfinite(x));  x = where(ok, x, NaN)
    cond = (max diag L / max(min diag L, 1e-300))^2

A non-positive (or NaN) pivot fails the point: x NaN, ok False, cond NaN,
as the reference's NaN-filled factor gives.  Inputs ``Ar`` (B, nt, nt) and
``rhs`` (B, nt), float64, nt <= 128; returns ``(x, ok, cond)``.  The solve is
never differentiated, so there is no autograd wrapper.

On a CUDA tensor this launches ``csrc/schur_cholesky_solve.cu`` (or raises);
on a CPU tensor it runs :func:`schur_cholesky_solve_reference`, whose loops
round in the kernel's order.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["schur_cholesky_solve", "schur_cholesky_solve_reference",
           "launch_counts", "REPLACES", "MAX_NT"]

NAME = "schur_cholesky_solve"
REPLACES = "pint_tpu/grid.py:737"
#: one thread per row and the whole matrix in shared memory; a larger
#: system raises ValueError (the reference takes any nt)
MAX_NT = 128
launch_counts = {NAME: 0}


def schur_cholesky_solve_reference(Ar, rhs, ridge: float):
    """Plain PyTorch version of K3: right-looking loops whose every entry
    sees the same rounding sequence as the kernel's left-looking one."""
    B, nt, _ = Ar.shape
    d = torch.diagonal(Ar, dim1=-2, dim2=-1)
    an = torch.sqrt(torch.where(d < 1e-300, 1e-300, d))
    A = Ar / (an.unsqueeze(-1) * an.unsqueeze(-2))
    idx = torch.arange(nt, device=Ar.device)
    A[:, idx, idx] = A[:, idx, idx] + ridge
    bad = torch.zeros(B, dtype=torch.bool, device=Ar.device)
    for j in range(nt):
        s = A[:, j, j]
        bad = bad | ~(s > 0.0)
        ljj = torch.sqrt(s)
        A[:, j, j] = ljj
        col = A[:, j + 1:, j] / ljj.unsqueeze(-1)
        A[:, j + 1:, j] = col
        A[:, j + 1:, j + 1:] = A[:, j + 1:, j + 1:] \
            - col.unsqueeze(-1) * col.unsqueeze(-2)
    y = rhs / an
    for k in range(nt):
        y[:, k] = y[:, k] / A[:, k, k]
        y[:, k + 1:] = y[:, k + 1:] - A[:, k + 1:, k] * y[:, k:k + 1]
    for k in range(nt - 1, -1, -1):
        y[:, k] = y[:, k] / A[:, k, k]
        y[:, :k] = y[:, :k] - A[:, k, :k] * y[:, k:k + 1]
    x = y / an
    ok = ~bad & torch.isfinite(x).all(dim=-1)
    x = torch.where(ok.unsqueeze(-1), x, torch.nan)
    dL = torch.diagonal(A, dim1=-2, dim2=-1)
    dmin = dL.min(dim=-1).values
    r = dL.max(dim=-1).values / torch.where(dmin < 1e-300, 1e-300, dmin)
    nan_diag = torch.isnan(dL).any(dim=-1)
    cond = torch.where(bad | nan_diag, torch.nan, r * r)
    return x, ok, cond


def _lib():
    lib = _build.load(NAME)
    fn = lib.schur_cholesky_solve_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_double, ci, ci, vp, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(Ar, rhs, ridge):
    B, nt, _ = Ar.shape
    x = torch.empty((B, nt), dtype=F64, device=Ar.device)
    ok = torch.empty((B,), dtype=torch.bool, device=Ar.device)
    cond = torch.empty((B,), dtype=F64, device=Ar.device)
    rc = _lib().schur_cholesky_solve_launch(
        _build.ptr(Ar), _build.ptr(rhs), float(ridge), B, nt, _build.ptr(x),
        _build.ptr(ok), _build.ptr(cond), _build.stream_of(Ar))
    launch_counts[NAME] += 1
    _build.check(NAME, rc)
    return x, ok, cond


def schur_cholesky_solve(Ar, rhs, ridge: float):
    """K3: ``(x, ok, cond)`` per point (see the module docstring)."""
    if Ar.dtype != F64 or rhs.dtype != F64 or Ar.device != rhs.device \
            or Ar.ndim != 3 or Ar.shape[1] != Ar.shape[2] \
            or rhs.shape != Ar.shape[:2] or not 1 <= Ar.shape[1] <= MAX_NT:
        raise ValueError(
            f"schur_cholesky_solve: Ar {tuple(Ar.shape)} {Ar.dtype}, rhs "
            f"{tuple(rhs.shape)} {rhs.dtype}; want float64 (B,nt,nt) and "
            f"(B,nt) on one device with nt <= {MAX_NT}")
    Ar, rhs = Ar.contiguous(), rhs.contiguous()
    if Ar.is_cuda:
        return _launch(Ar, rhs, ridge)
    if Ar.device.type != "cpu":
        raise ValueError(f"schur_cholesky_solve: no kernel for {Ar.device}")
    return schur_cholesky_solve_reference(Ar.clone(), rhs.clone(), ridge)
