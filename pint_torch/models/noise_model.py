"""Noise components: EFAC/EQUAD scaling, ECORR and power-law red noise
(port of ``pint_tpu/models/noise_model.py:55-122,161-250,289-368,370-494``).

The (basis, weight) pairs depend only on TOA epochs and integer mode
counts, never on fitted timing parameters, so they are built once on the
host in numpy -- as in the reference -- and enter the GLS solves and the
Woodbury chi2 as constant device tensors.  Mask selections arrive as
per-TOA boolean masks (the reference's ``select_toa_mask`` resolved on the
host when the snapshot was taken).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pint_torch.models.timing_model import NoiseComponent

__all__ = ["ScaleToaError", "EcorrNoise", "PLRedNoise", "ecorr_epochs",
           "ecorr_quantization_matrix", "rednoise_freqs",
           "fourier_design_matrix", "powerlaw"]

DAY_S = 86400.0
#: 1/year in Hz
FYR = 1.0 / (365.25 * DAY_S)


def ecorr_epochs(t_s: np.ndarray, dt: float = 1.0,
                 nmin: int = 2) -> List[List[int]]:
    """Group TOAs (seconds) into epochs closer than ``dt`` seconds; keep
    groups of at least ``nmin`` members."""
    if len(t_s) == 0:
        return []
    isort = np.argsort(t_s)
    ref = t_s[isort[0]]
    groups: List[List[int]] = [[int(isort[0])]]
    for i in isort[1:]:
        if t_s[i] - ref < dt:
            groups[-1].append(int(i))
        else:
            ref = t_s[i]
            groups.append([int(i)])
    return [g for g in groups if len(g) >= nmin]


def ecorr_quantization_matrix(t_s: np.ndarray, dt: float = 1.0,
                              nmin: int = 2) -> np.ndarray:
    """(N, n_epoch) 0/1 matrix mapping TOAs to epochs."""
    groups = ecorr_epochs(t_s, dt=dt, nmin=nmin)
    U = np.zeros((len(t_s), len(groups)))
    for k, g in enumerate(groups):
        U[g, k] = 1.0
    return U


def rednoise_freqs(Tspan_s: float, n_lin: int, n_log: Optional[int] = None,
                   f_min_ratio: float = 1.0) -> np.ndarray:
    """``n_lin`` linear modes k/T, optionally preceded by ``n_log``
    log-spaced modes from ``f_min_ratio/T`` up to 1/T."""
    f_lin = np.arange(1, n_lin + 1) / Tspan_s
    if n_log is None or n_log <= 0:
        return f_lin
    f_min = f_min_ratio / Tspan_s
    f_log = np.logspace(np.log10(f_min), np.log10(1.0 / Tspan_s), n_log,
                        endpoint=False)
    return np.concatenate([f_log, f_lin])


def fourier_design_matrix(t_s: np.ndarray, f: np.ndarray) -> np.ndarray:
    """(N, 2 len(f)) alternating sin/cos columns."""
    arg = 2.0 * np.pi * t_s[:, None] * f[None, :]
    F = np.empty((len(t_s), 2 * len(f)))
    F[:, 0::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    return F


def powerlaw(f, A: float, gamma: float) -> np.ndarray:
    """P(f) = A^2/(12 pi^2) fyr^-3 (f/fyr)^-gamma."""
    x = np.asarray(f, float) / FYR
    return A**2 / 12.0 / np.pi**2 * FYR ** (-3.0) * x ** (-gamma)


def _tdb_seconds(batch) -> np.ndarray:
    return batch.tdb.hi.cpu().numpy() * DAY_S


def _masked(comp, prefix: str):
    """(name, value, mask) of the component's set ``PREFIX<n>`` masks, in
    index order."""
    model = comp._parent
    names = sorted((p for p in comp.params
                    if p.startswith(prefix) and p[len(prefix):].isdigit()),
                   key=lambda p: int(p[len(prefix):]))
    return [(n, model.params_table[n].value, comp.context["masks"][n])
            for n in names if model.params_table[n].value is not None]


class ScaleToaError(NoiseComponent):
    """sigma' = EFAC * sqrt(sigma^2 + EQUAD^2) per mask selection.
    Context: ``masks`` {parameter name: (N,) bool numpy}."""

    register = True
    category = "scale_toa_error"

    def scale_toa_sigma(self, model, batch, sigma_s: np.ndarray) -> np.ndarray:
        out = np.array(sigma_s, dtype=np.float64, copy=True)
        for _, v, m in _masked(self, "EQUAD"):
            out[m] = np.hypot(out[m], v * 1e-6)
        for _, v, m in _masked(self, "EFAC"):
            out[m] *= v
        return out


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise: quantization basis, weight ECORR^2.
    Context: ``masks`` {parameter name: (N,) bool numpy}."""

    register = True
    category = "ecorr_noise"
    introduces_correlated_errors = True

    def basis_weight_pair(self, model, batch) -> Tuple[np.ndarray, np.ndarray]:
        t = _tdb_seconds(batch)
        umats, weights = [], []
        for _, v, m in _masked(self, "ECORR"):
            idx = np.nonzero(m)[0]
            umats.append((idx, ecorr_quantization_matrix(t[idx])))
            weights.append((v * 1e-6) ** 2)
        nc = sum(u.shape[1] for _, u in umats)
        U = np.zeros((len(t), nc))
        w = np.zeros(nc)
        col = 0
        for (idx, um), wt in zip(umats, weights):
            nn = um.shape[1]
            U[idx, col:col + nn] = um
            w[col:col + nn] = wt
            col += nn
        return U, w


class PLRedNoise(NoiseComponent):
    """Achromatic power-law red noise (TNREDAMP/TNREDGAM/TNREDC).
    Config: ``amp``, ``gam``, ``n_lin``, ``n_log``, ``f_min_ratio``,
    ``tspan_s`` (None: the data span) -- the reference's ``get_plc_vals``
    resolved on the host."""

    register = True
    category = "pl_red_noise"
    introduces_correlated_errors = True

    def get_time_frequencies(self, batch):
        t = _tdb_seconds(batch)
        T = self.config.get("tspan_s")
        if T is None:
            T = float(np.max(t) - np.min(t))
        f = rednoise_freqs(T, int(self.config["n_lin"]),
                           n_log=self.config.get("n_log"),
                           f_min_ratio=float(self.config["f_min_ratio"]))
        return t, f

    def basis_weight_pair(self, model, batch) -> Tuple[np.ndarray, np.ndarray]:
        t, f = self.get_time_frequencies(batch)
        F = fourier_design_matrix(t, f)
        df = np.diff(np.concatenate([[0.0], f]))
        w = powerlaw(np.repeat(f, 2), self.config["amp"],
                     self.config["gam"]) * np.repeat(df, 2)
        return F, w
