"""Hardened solve ladder: Cholesky -> jittered Cholesky -> (caller's SVD)
(port of ``pint_tpu/runtime/solve.py:41-187``), on float64 tensors of any
device."""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["SolveDiagnostics", "JITTER_LADDER", "LADDER_RUNGS", "SVD_RUNG",
           "NonFiniteSystemError", "SingularMatrixError", "hardened_cholesky",
           "solve_normal_cholesky", "ladder_cholesky_solve"]

#: relative diagonal loading per host rung (times the mean diagonal)
JITTER_LADDER = (0.0, 1e-12, 1e-9, 1e-6)
#: on-device Cholesky rungs (base ridge x 1e3 per rung)
LADDER_RUNGS = 3
#: level reported when the eigendecomposition rung was used
SVD_RUNG = LADDER_RUNGS


class NonFiniteSystemError(ValueError):
    """NaN/inf in a linear system: refusing to solve."""


class SingularMatrixError(ValueError):
    """Cholesky failed at every jitter rung; escalate to SVD."""


@dataclass(frozen=True)
class SolveDiagnostics:
    method: str        #: "cholesky" | "cholesky-jitter" | "svd"
    jitter: float
    attempts: int
    condition: float


def _require_finite(name: str, *tensors) -> None:
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise NonFiniteSystemError(
                f"{name}: non-finite entries in the linear system")


def hardened_cholesky(A, name: str = "normal matrix", ladder=JITTER_LADDER):
    """``(L, jitter, attempts)`` with escalating diagonal loading; raises
    :class:`NonFiniteSystemError` on NaN/inf input and
    :class:`SingularMatrixError` when every rung fails."""
    _require_finite(name, A)
    d = torch.diagonal(A)
    scale = float(d.mean()) if d.numel() else 1.0
    if not (scale > 0 and scale < float("inf")):
        scale = 1.0
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    for i, rel in enumerate(ladder):
        jitter = rel * scale
        Aj = A if jitter == 0.0 else A + jitter * eye
        L, info = torch.linalg.cholesky_ex(Aj)
        if int(info) == 0 and bool(torch.isfinite(L).all()):
            return L, jitter, i + 1
    raise SingularMatrixError(
        f"{name}: Cholesky failed at every jitter level "
        f"(max loading {ladder[-1] * scale:.3e}); escalate to SVD")


def solve_normal_cholesky(mtcm, mtcy, name: str = "normal equations",
                          ladder=JITTER_LADDER):
    """``(xvar, xhat, diagnostics)`` for ``mtcm x = mtcy``."""
    _require_finite(name, mtcy)
    L, jitter, attempts = hardened_cholesky(mtcm, name=name, ladder=ladder)
    xhat = torch.cholesky_solve(mtcy[:, None], L)[:, 0]
    eye = torch.eye(len(mtcy), dtype=L.dtype, device=L.device)
    xvar = torch.cholesky_solve(eye, L)
    d = torch.diagonal(L)
    cond = float((d.max() / torch.clamp(d.min(), min=1e-300)) ** 2)
    return xvar, xhat, SolveDiagnostics(
        method="cholesky" if jitter == 0.0 else "cholesky-jitter",
        jitter=float(jitter), attempts=attempts, condition=cond)


def ladder_cholesky_solve(A, rhs, base_ridge: float):
    """Device-side ladder with no host decision: rung i factors
    ``A + base_ridge * 1e3**i * I``, the last rung is an eigenvalue-clipped
    pseudo-inverse; returns ``(x, level, ridge, cond)`` (NaN x and level -1
    for non-finite input)."""
    nt = A.shape[-1]
    eye = torch.eye(nt, dtype=A.dtype, device=A.device)
    finite_in = torch.isfinite(A).all() & torch.isfinite(rhs).all()
    A_safe = torch.where(finite_in, A, eye)
    b_safe = torch.where(finite_in, rhs, torch.zeros_like(rhs))
    lam, Q = torch.linalg.eigh(A_safe)
    alam = torch.abs(lam)
    lmax = torch.max(alam)
    keep = lam > 1e-13 * lmax
    lam_inv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
    x = Q @ (lam_inv * (Q.T @ b_safe))
    level = torch.tensor(SVD_RUNG, device=A.device)
    ridge = torch.zeros((), dtype=A.dtype, device=A.device)
    cond = lmax / torch.clamp(torch.min(alam), min=1e-300)
    for i in reversed(range(LADDER_RUNGS)):
        r = base_ridge * (1e3 ** i)
        L, info = torch.linalg.cholesky_ex(A_safe + r * eye)
        xi = torch.cholesky_solve(b_safe[:, None], L)[:, 0]
        ok = (info == 0) & torch.isfinite(L).all() & torch.isfinite(xi).all()
        x = torch.where(ok, xi, x)
        level = torch.where(ok, torch.tensor(i, device=A.device), level)
        ridge = torch.where(ok, torch.tensor(r, dtype=A.dtype,
                                             device=A.device), ridge)
    x = torch.where(finite_in, x, torch.nan)
    level = torch.where(finite_in, level, torch.tensor(-1, device=A.device))
    cond = torch.where(finite_in, cond, torch.nan)
    return x, level, ridge, cond
