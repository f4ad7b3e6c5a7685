"""Outlier-robust reweighting for WLS fits: IRLS with a Huber psi (port of
``pint_tpu/integrity/robust.py``).

The Huber M-estimator keeps the quadratic loss for whitened residuals
inside ``k`` sigma and switches to linear loss outside, which in IRLS form
is a per-TOA weight ``w = min(1, k/|z|)`` on the *variance* (sigma_eff =
sigma / sqrt(w)).  ``k = 1.345`` gives 95% asymptotic efficiency under a
clean Gaussian.  The reweighting loop runs on the host around the fitters'
solve step (:meth:`pint_torch.fitter.Fitter._run_irls`).
"""

from __future__ import annotations

import torch

__all__ = ["HUBER_K", "huber_weights", "irls_converged", "median"]

#: 95%-efficiency Huber tuning constant
HUBER_K = 1.345


def median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median of a 1-D tensor: the mean of the two middle values
    for an even count (``torch.median`` returns the lower one)."""
    s, _ = torch.sort(x)
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) / 2.0


def huber_weights(whitened: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    """Per-TOA Huber IRLS weights from whitened residuals ``z = r/sigma``:
    1 for |z| <= k, ``k/|z|`` beyond; 0 for a non-finite residual (the row
    cannot vote at all)."""
    z = torch.abs(whitened)
    out = z > k
    w = torch.where(out, torch.full_like(z, k) / torch.where(out, z, 1.0),
                    1.0)
    return torch.where(torch.isfinite(z), w, 0.0)


def irls_converged(w_old: torch.Tensor, w_new: torch.Tensor,
                   tol: float = 1e-3) -> bool:
    """True when the weight vector has stopped moving (max abs change)."""
    if w_new.numel() == 0:
        return True
    return float(torch.max(torch.abs(w_new - w_old))) < tol
