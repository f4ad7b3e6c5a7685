"""Hellings-Downs overlap-reduction geometry for pulsar arrays (host copy of
``pint_tpu/catalog/crosscorr.py:36-99``).

The cross-pulsar signature of an isotropic gravitational-wave background is
a covariance between pulsar pairs that depends only on their angular
separation, the Hellings & Downs (1983) curve:

    zeta(gamma) = 3/2 x ln x - x/4 + 1/2,   x = (1 - cos gamma) / 2

for two distinct pulsars, with ``zeta -> 1/2`` as ``gamma -> 0``; the
array's overlap matrix carries ``1.0`` on its diagonal (Earth term plus
pulsar term).  Everything here is host numpy, built once per catalog; the
Cholesky factor goes through the port's hardened jitter ladder
(:func:`pint_torch.runtime.solve.hardened_cholesky`) on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pint_torch.fitter import UsageError

__all__ = ["hd_curve", "pulsar_directions", "angular_separations",
           "hd_matrix", "hd_cholesky"]


def hd_curve(gamma):
    """Hellings-Downs overlap-reduction value for angular separation(s)
    ``gamma`` [rad] between two distinct pulsars (scalar in, float out;
    array in, array out); ``x ln x`` is continued to 0 at coincidence, so
    ``hd_curve(0.0) == 0.5``."""
    g = np.asarray(gamma, dtype=np.float64)
    x = (1.0 - np.cos(g)) / 2.0
    xlnx = x * np.log(np.where(x > 0.0, x, 1.0))
    out = 1.5 * xlnx - 0.25 * x + 0.5
    return float(out) if np.ndim(gamma) == 0 else out


def pulsar_directions(models: Sequence) -> np.ndarray:
    """``(n_pulsars, 3)`` ICRS unit vectors of a catalog's timing models
    (:meth:`pint_torch.models.timing_model.TimingModel.psr_direction`)."""
    if not len(models):
        raise UsageError("pulsar_directions needs at least one model")
    return np.stack([np.asarray(m.psr_direction(), dtype=np.float64)
                     for m in models])


def angular_separations(directions: np.ndarray) -> np.ndarray:
    """``(n, n)`` pairwise angular separations [rad] of unit vectors (zero
    diagonal)."""
    d = np.asarray(directions, dtype=np.float64)
    if d.ndim != 2 or d.shape[1] != 3:
        raise UsageError(
            f"directions must be (n, 3) unit vectors, got {d.shape}")
    norms = np.sqrt(np.sum(d * d, axis=1))
    if not np.allclose(norms, 1.0, atol=1e-6):
        raise UsageError("directions are not unit vectors "
                         f"(|v| spans [{norms.min():g}, {norms.max():g}])")
    cosg = np.clip(d @ d.T, -1.0, 1.0)
    np.fill_diagonal(cosg, 1.0)
    return np.arccos(cosg)


def hd_matrix(directions: np.ndarray, auto: float = 1.0) -> np.ndarray:
    """The array's ``(n, n)`` Hellings-Downs overlap matrix: the curve off
    the diagonal, ``auto`` on it (1.0: Earth term plus pulsar term)."""
    gamma = angular_separations(directions)
    orf = hd_curve(gamma)
    np.fill_diagonal(orf, float(auto))
    return orf


def hd_cholesky(directions: np.ndarray, auto: float = 1.0) -> np.ndarray:
    """Lower-triangular Cholesky factor of :func:`hd_matrix` through the
    hardened jitter ladder (ladder exhaustion raises
    :class:`~pint_torch.runtime.solve.SingularMatrixError`)."""
    import torch

    from pint_torch.runtime.solve import hardened_cholesky

    L, _, _ = hardened_cholesky(
        torch.as_tensor(hd_matrix(directions, auto=auto),
                        dtype=torch.float64),
        name="Hellings-Downs overlap matrix")
    return np.asarray(L.numpy(), dtype=np.float64)
