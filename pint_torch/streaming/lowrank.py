"""Rank-k Cholesky up/downdates of the GLS normal-equation factor (port of
``pint_tpu/streaming/lowrank.py``).

An append of ``k`` TOAs perturbs the Woodbury-form normal matrix by a
rank-k term, ``A' = A +- V^T V`` with ``V`` the block's weighted design
rows; the LINPACK ``dchud``/``dchdd`` sweep rewrites the held factor in
``O(k K^2)`` instead of refactoring.  The sweep, and the fused block
ingest, are K9 (:mod:`pint_torch.kernels.chol_rank_update`): a zero row is
an exact no-op, so padding a block up to its ladder rung is exact.

A downdate of rows that were never in the factor, or a near-singular
update, drives a diagonal through zero: the factor is poisoned with NaN
and the guard (:func:`apply_rank_update`, :func:`refusal_reason`) reports
``ok=False`` with the measured condition proxy against
``CONDITION_LIMIT``, so that the caller refactors; nothing raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from pint_torch import F64
from pint_torch.fitter import UsageError
from pint_torch.kernels import chol_rank_update as K9

__all__ = ["DEFAULT_BLOCK_BUCKETS", "CONDITION_LIMIT", "FactorUpdate",
           "rank_kernel", "ingest_kernel", "chol_update", "chol_downdate",
           "apply_rank_update", "factor_condition", "refusal_reason"]

#: append-block-size ladder (rows per rank-k dispatch); past the top the
#: serving ladder's doubling rule applies
DEFAULT_BLOCK_BUCKETS = (4, 16, 64, 256)

#: condition proxy (Cholesky-diagonal ratio squared) above which an
#: updated factor is not trusted
CONDITION_LIMIT = 1e13


def _sign(sign: float) -> float:
    if sign not in (1.0, -1.0):
        raise UsageError(f"rank kernel sign must be +1.0 or -1.0, "
                         f"got {sign!r}")
    return float(sign)


def rank_kernel(sign: float):
    """The rank-k factor sweep for ``sign`` (+1 update, -1 downdate):
    ``(L (K,K), V (k,K)) -> L'``, K9's :func:`chol_rank_update`."""
    s = _sign(sign)
    return lambda L, V: K9.chol_rank_update(L, V, s)


def ingest_kernel(sign: float):
    """The block-ingest kernel for ``sign``: ``(L, b, chi2, M (k,K), r, w,
    dx_since (K,)) -> (L', b', chi2', ok, cond)``, K9's
    :func:`stream_ingest` (residuals advanced in-kernel, ``ok`` and the
    condition proxy as 0-dim device tensors)."""
    s = _sign(sign)
    return lambda L, b, chi2, M, r, w, dx: K9.stream_ingest(
        L, b, chi2, M, r, w, dx, s)


def _rows(V, L):
    V = torch.as_tensor(V, dtype=F64, device=L.device)
    return V.reshape(1, -1) if V.ndim == 1 else V


def chol_update(L, V):
    """Factor of ``L L^T + V^T V`` by the rank-k sweep."""
    return rank_kernel(1.0)(L, _rows(V, L))


def chol_downdate(L, V):
    """Factor of ``L L^T - V^T V``, NaN-poisoned when the downdate leaves
    a non-PD system (the caller's guard decides)."""
    return rank_kernel(-1.0)(L, _rows(V, L))


def factor_condition(L) -> float:
    """Cholesky-diagonal condition proxy ``(dmax/dmin)^2``."""
    d = torch.abs(torch.diagonal(L))
    if d.numel() == 0 or not bool(torch.isfinite(d).all()):
        return float("inf")
    return float((d.max() / torch.clamp(d.min(), min=1e-300)) ** 2)


def refusal_reason(finite_ok: bool, cond: float, cond_limit: float,
                   downdate: bool) -> Optional[str]:
    """The one guard-refusal classifier (None: the update stands), shared
    by :func:`apply_rank_update` and the stream cache's ingest; the
    reference's reason strings."""
    if not finite_ok:
        return ("non-finite/non-PD updated factor "
                + ("(downdate left a non-PD system)" if downdate
                   else "(singular update)"))
    if cond > cond_limit:
        return (f"condition proxy {cond:.3e} past the "
                f"{cond_limit:.0e} guard")
    return None


@dataclass(frozen=True)
class FactorUpdate:
    """Outcome of one guarded rank-k factor update."""

    L: torch.Tensor        #: the updated factor (valid only when ``ok``)
    ok: bool               #: finite, positive-diagonal, under the bar
    condition: float       #: measured condition proxy of the result
    reason: str = ""       #: why the guard refused (empty when ``ok``)


def apply_rank_update(L, V, downdate: bool = False,
                      cond_limit: float = CONDITION_LIMIT) -> FactorUpdate:
    """One guarded rank-k up/downdate: the sweep, then its measurement; a
    non-finite or non-positive-diagonal factor or a condition proxy past
    ``cond_limit`` comes back ``ok=False`` with the reason (never
    raises on a bad factor)."""
    V = _rows(V, L)
    if V.shape[1] != L.shape[0]:
        raise UsageError(
            f"rank-k block has {V.shape[1]} columns for a "
            f"{L.shape[0]}-column factor")
    L2 = chol_downdate(L, V) if downdate else chol_update(L, V)
    d = torch.diagonal(L2)
    finite_ok = bool(torch.isfinite(L2).all() and (d > 0).all())
    cond = factor_condition(L2) if finite_ok else float("inf")
    reason = refusal_reason(finite_ok, cond, cond_limit, downdate)
    return FactorUpdate(L=L2, ok=reason is None, condition=cond,
                        reason=reason or "")
