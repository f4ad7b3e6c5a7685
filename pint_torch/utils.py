"""Numerical utilities of the slice (port of ``pint_tpu/utils.py:90-111,
114-140,153-260,290-297,357-364,439-462``): design-matrix normalization,
the linear-column probe and the Woodbury / Sherman-Morrison chi2 kernels,
on float64 tensors; the F-test, the ELL1 validity check, the Taylor series
and the host layer's position/velocity pair and file helpers, host numpy
and scipy."""

from __future__ import annotations

import contextlib
import hashlib
import math
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = ["normalize_designmatrix", "woodbury_dot", "sherman_morrison_dot",
           "weighted_mean", "linearity_probe_steps",
           "classify_linear_columns", "FTest", "ELL1_check",
           "taylor_horner", "PosVel", "open_or_use", "compute_hash"]


class PosVel(NamedTuple):
    """A position and velocity pair with provenance labels (reference
    ``utils.py:114``): ``pos``/``vel`` (..., 3) host arrays in the caller's
    units (the host layer uses km and km/s); ``obj``/``origin`` name the
    vector's ends, and addition composes frames: (obj=B, origin=A) +
    (obj=C, origin=B) = (obj=C, origin=A)."""

    pos: np.ndarray
    vel: np.ndarray
    obj: str = ""
    origin: str = ""

    def __add__(self, other: "PosVel") -> "PosVel":
        obj, origin = self.obj, self.origin
        if self.obj and other.origin == self.obj:
            obj, origin = other.obj, self.origin
        elif other.obj and self.origin == other.obj:
            obj, origin = self.obj, other.origin
        return PosVel(self.pos + other.pos, self.vel + other.vel, obj, origin)

    def __sub__(self, other: "PosVel") -> "PosVel":
        return PosVel(self.pos - other.pos, self.vel - other.vel, self.obj,
                      other.obj or self.origin)

    def __neg__(self) -> "PosVel":
        return PosVel(-self.pos, -self.vel, self.origin, self.obj)


@contextlib.contextmanager
def open_or_use(f, mode: str = "r"):
    """Open a path, or pass a file-like object straight through."""
    if isinstance(f, (str, bytes, Path)):
        with open(f, mode) as fh:
            yield fh
    else:
        yield f


def compute_hash(filename) -> bytes:
    """SHA-256 digest of a file's contents, for change detection."""
    h = hashlib.sha256()
    with open_or_use(filename, "rb") as f:
        while block := f.read(128 * h.block_size):
            h.update(block)
    return h.digest()


def _sum_along(x, axis):
    """The sum along ``axis``, its slices added one at a time in index
    order (XLA's order on the CPU for a short axis)."""
    s = x.select(axis, 0)
    for i in range(1, x.shape[axis]):
        s = s + x.select(axis, i)
    return s


def weighted_mean(arr, weights, axis=None):
    """Weighted mean and its error, over every element or along ``axis``
    (reference ``utils.py:143``)."""
    if axis is None:
        w = weights / torch.sum(weights)
        return torch.sum(arr * w), torch.sqrt(1.0 / torch.sum(weights))
    wsum = _sum_along(weights, axis)
    w = weights / wsum.unsqueeze(axis)
    return _sum_along(arr * w, axis), torch.sqrt(1.0 / wsum)


def linearity_probe_steps(J0: np.ndarray) -> np.ndarray:
    """Per-parameter steps moving the phase ~1e-3 cycles RMS; zero columns
    get an infinite envelope."""
    col_rms = np.linalg.norm(J0, axis=0) / np.sqrt(max(J0.shape[0], 1))
    dp = 1e-3 / np.maximum(col_rms, 1e-300)
    dp[col_rms == 0] = np.inf
    return dp


def classify_linear_columns(J0: np.ndarray, J1: np.ndarray) -> np.ndarray:
    """Indices of the columns that moved (relative change > 1e-7) between
    two Jacobians; a non-finite column counts as moved."""
    dcol = np.linalg.norm(J1 - J0, axis=0)
    ncol = np.linalg.norm(J0, axis=0)
    moved = dcol > 1e-7 * (ncol + 1e-300)
    moved |= ~np.isfinite(dcol)
    return np.nonzero(moved)[0]


def normalize_designmatrix(M, params=None):
    """Unit-L2-norm columns: (M / norms, norms), zero columns keep norm 1;
    ``params`` is accepted and unused, as the reference's."""
    norms = torch.sqrt(torch.sum(M * M, dim=0))
    safe = torch.where(norms == 0, 1.0, norms)
    return M / safe, safe


def woodbury_dot(Ndiag, U, Phidiag, x, y):
    """x^T C^-1 y and logdet(C) for C = diag(N) + U diag(Phi) U^T, in the
    scaled-basis form (V = U sqrt(Phi), Sigma = I + V^T N^-1 V) that never
    evaluates 1/Phi or log(Phi)."""
    V = U * torch.sqrt(Phidiag)[None, :]
    Ninv_x = x / Ndiag
    Ninv_y = y / Ndiag
    Vt_Ninv_x = V.T @ Ninv_x
    Vt_Ninv_y = V.T @ Ninv_y
    Sigma = torch.eye(V.shape[1], dtype=V.dtype, device=V.device) \
        + V.T @ (V / Ndiag[:, None])
    cf = torch.linalg.cholesky(Sigma)
    z = torch.linalg.solve_triangular(cf, Vt_Ninv_y[:, None], upper=False)[:, 0]
    zx = torch.linalg.solve_triangular(cf, Vt_Ninv_x[:, None], upper=False)[:, 0]
    dot = x @ Ninv_y - zx @ z
    logdet = torch.sum(torch.log(Ndiag)) \
        + 2.0 * torch.sum(torch.log(torch.diagonal(cf)))
    return dot, logdet


def sherman_morrison_dot(Ndiag, U, weights, x, y):
    """x^T C^-1 y and logdet(C) for an ECORR-only covariance with disjoint
    0/1 basis columns."""
    Ninv_x = x / Ndiag
    Ninv_y = y / Ndiag
    dot = torch.sum(x * Ninv_y)
    logdet = torch.sum(torch.log(Ndiag))
    ux = U.T @ Ninv_x
    uy = U.T @ Ninv_y
    uu = torch.sum(U * U / Ndiag[:, None], dim=0)
    denom = 1.0 + weights * uu
    dot = dot - torch.sum(weights * ux * uy / denom)
    logdet = logdet + torch.sum(torch.log(denom))
    return dot, logdet


def FTest(chi2_1, dof_1, chi2_2, dof_2) -> float:
    """Probability that the improvement of the dof_2 < dof_1 model is by
    chance (reference ``utils.py:247``): small means the extra parameters
    are significant; 1.0 where chi2 or dof does not fall."""
    from scipy.stats import f as fdist

    delta_chi2 = chi2_1 - chi2_2
    delta_dof = dof_1 - dof_2
    if delta_chi2 <= 0 or delta_dof <= 0 or dof_2 <= 0:
        return 1.0
    F = (delta_chi2 / delta_dof) / (chi2_2 / dof_2)
    return float(fdist.sf(F, delta_dof, dof_2))


def ELL1_check(A1_ls: float, E: float, TRES_us: float, NTOA: int,
               outstring: bool = True):
    """Is the ELL1 small-eccentricity approximation valid: asini/c * ecc^4
    << TRES / sqrt(NTOA) (reference ``utils.py:439``)?  ``A1_ls`` in
    light-seconds, ``TRES_us`` in microseconds; the report, or a bool with
    ``outstring=False``."""
    lhs_us = float(A1_ls) * float(E) ** 4 * 1e6
    rhs_us = float(TRES_us) / math.sqrt(NTOA)
    if outstring:
        s = (
            "Checking applicability of ELL1 model -- \n"
            "    Condition is asini/c * ecc**4 << timing precision / "
            "sqrt(# TOAs) to use ELL1\n"
            f"    asini/c * ecc**4    = {lhs_us:.3g} us\n"
            f"    TRES / sqrt(# TOAs) = {rhs_us:.3g} us\n"
        )
    if lhs_us * 50.0 < rhs_us:
        return s + "    Should be fine.\n" if outstring else True
    if lhs_us * 5.0 < rhs_us:
        return s + "    Should be OK, but not optimal.\n" if outstring else True
    return (s + "    *** WARNING*** Should probably use BT or DD instead!\n"
            if outstring else False)


def taylor_horner(x, coeffs: Sequence) -> np.ndarray:
    """sum_i coeffs[i] x^i / i! by Horner's method, host float64
    (reference ``utils.py:90``)."""
    x = np.asarray(x, dtype=np.float64)
    result = np.zeros_like(x)
    for i, c in reversed(list(enumerate(coeffs))):
        result = result * x + float(c) / math.factorial(i)
    return result
