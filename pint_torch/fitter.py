"""Fitter base (port of the pieces of ``pint_tpu/fitter.py:42-120,495-518``
that the GLS fitter calls)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from pint_torch.residuals import Residuals

__all__ = ["Fitter"]


class Fitter:
    """Holds a copy of the model, the TOA batch, residuals and fit
    products."""

    def __init__(self, batch, model):
        self.batch = batch
        self.model_init = model
        self.model = model.copy()
        self.resids = Residuals(batch, self.model)
        self.method = "base"
        self.converged = False
        self.errors: Dict[str, float] = {}
        self.covariance: Optional[np.ndarray] = None
        self.fitted_params: List[str] = []
        self.solve_diagnostics = None
        self.chi2: Optional[float] = None

    def update_resids(self) -> Residuals:
        self.resids = Residuals(self.batch, self.model)
        return self.resids

    def fit_toas(self, maxiter: int = 1, **kw) -> float:
        raise NotImplementedError
