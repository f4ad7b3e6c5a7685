"""FFTFIT: template-matching phase shift between pulse profiles (port of
``pint_tpu/fftfit.py``).

An FFT reimplementation of the Taylor (1992) FFTFIT algorithm the
reference imports from PRESTO's Fortran (reference
``scripts/event_optimize.py:119-133``): given a data profile and a
template profile, find the phase shift tau (and scale b) minimizing

    chi2(b, tau) = sum_k |D_k - b T_k e^{-2 pi i k tau}|^2

over the nonzero harmonics.  The coarse solution comes from the
zero-padded cross-spectrum (circular cross-correlation); Newton iterations
on d(chi2)/d(tau) refine it to machine precision.  Returns the shift in
[0, 1) cycles and a 1-sigma uncertainty from the chi2 curvature with the
noise level estimated from the data profile's high harmonics.

The three FFTs (of the profile, of the template, and the inverse of the
padded cross-spectrum) are ``torch.fft`` calls on ``device`` (default
``"cuda"``, as every entry point of the port; ``device="cpu"`` runs them
on the host), where the reference calls ``jnp.fft``; a profile has a few
hundred bins, and the Newton refinement stays in numpy as in the
reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pint_torch import F64, resolve_device

__all__ = ["fftfit_full", "fftfit_basic"]


def _harmonic_sums(D, T, tau, ks):
    """C(tau) = sum Re[D_k conj(T_k) e^{2 pi i k tau}] and derivatives."""
    rot = np.exp(2j * np.pi * ks * tau)
    prod = D * np.conj(T) * rot
    c0 = np.sum(prod.real)
    c1 = np.sum((2j * np.pi * ks * prod).real)
    c2 = np.sum(((2j * np.pi * ks) ** 2 * prod).real)
    return c0, c1, c2


def _rfft(x: np.ndarray, dev) -> np.ndarray:
    return torch.fft.rfft(torch.as_tensor(x, dtype=F64, device=dev)) \
        .cpu().numpy()


def fftfit_full(template: np.ndarray, profile: np.ndarray,
                nharm: int = 0, device=None
                ) -> Tuple[float, float, float, float]:
    """(shift, eshift, scale, escale): profile ~ scale * template(phi - shift).

    ``nharm`` limits the harmonics used (0 = all up to Nyquist).  The shift
    sign convention matches rotating the template by +shift to align with
    the data.
    """
    dev = resolve_device(device)
    template = np.asarray(template, dtype=np.float64)
    profile = np.asarray(profile, dtype=np.float64)
    if template.shape != profile.shape:
        raise ValueError("template and profile must have the same length")
    n = len(profile)
    D = _rfft(profile, dev)
    T = _rfft(template, dev)
    kmax = len(D) - 1 if nharm in (0, None) else min(nharm, len(D) - 1)
    ks = np.arange(1, kmax + 1)
    Dk, Tk = D[1:kmax + 1], T[1:kmax + 1]

    # coarse: circular cross-correlation on a 16x zero-padded grid
    pad = 16
    cross = np.zeros(n * pad // 2 + 1, dtype=complex)
    cross[1:kmax + 1] = Dk * np.conj(Tk)
    cc = torch.fft.irfft(torch.as_tensor(cross, device=dev), n * pad) \
        .cpu().numpy()
    tau = float(np.argmax(cc)) / (n * pad)

    # Newton refinement on C'(tau) = 0 (max of the correlation)
    for _ in range(30):
        _, c1, c2 = _harmonic_sums(Dk, Tk, tau, ks)
        if c2 == 0:
            break
        step = -c1 / c2
        tau += step
        if abs(step) < 1e-15:
            break
    tau %= 1.0

    c0, _, c2 = _harmonic_sums(Dk, Tk, tau, ks)
    tt = float(np.sum(np.abs(Tk) ** 2))
    b = c0 / tt  # ML scale at the best shift

    # noise from the top-quarter harmonics of the data (conservative when
    # the pulse occupies the low harmonics, as for smooth profiles)
    hi = D[1 + (3 * kmax) // 4:kmax + 1]
    sigma2 = float(np.mean(np.abs(hi) ** 2) / 2.0) if len(hi) else 1.0
    # curvature of chi2/2 in tau at the optimum is b * |C''| (C'' < 0 there)
    curv = abs(b * c2)
    eshift = float(np.sqrt(sigma2 / curv)) if curv > 0 else np.inf
    escale = float(np.sqrt(sigma2 / tt))
    return float(tau), eshift, float(b), escale


def fftfit_basic(template: np.ndarray, profile: np.ndarray,
                 device=None) -> float:
    """Shift only (cycles in [0, 1)); see :func:`fftfit_full`."""
    return fftfit_full(template, profile, device=device)[0]
