"""Residuals: observed-minus-model phase and time, with the GLS chi2, the
Gaussian log-likelihood and the residual statistics (port of
``pint_tpu/residuals.py:22-334``).

Phase residuals are the model phase's fractional part ('nearest' pulse
tracking, plus the TOAs' added pulses) or, under 'use_pulse_numbers', its
integer part less the TOAs' pulse numbers plus its fraction -- the
absolute phase, TZR TOA subtracted, where the model has an AbsPhase --
minus their weighted mean unless a PhaseOffset fits the offset; time residuals divide by F0.  The chi2 is diagonal without
correlated noise; otherwise the Sherman-Morrison form for ECORR alone
with an explicit PhaseOffset, else the scaled-basis Woodbury form with the
overall offset marginalized.  The statistics (weighted rms, means, the
whitened residuals, the noise realizations a GLS fit leaves in
``noise_ampls``, the ECORR epoch averages) are float64 tensors on the
batch's device, or Python floats for scalars.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch.exceptions import UsageError
from pint_torch.utils import sherman_morrison_dot, weighted_mean, woodbury_dot

__all__ = ["Residuals"]


class Residuals:
    """Residuals of ``batch`` under ``model``; results are float64 tensors
    on the batch's device."""

    residual_type = "toa"
    unit = "s"
    #: {noise component: amplitudes} a GLS fit stored, or None
    noise_ampls = None

    def __init__(self, batch, model, subtract_mean: bool = True,
                 use_weighted_mean: bool = True,
                 track_mode: Optional[str] = None):
        """``batch`` a :class:`~pint_torch.toa.TOABatch` or host TOAs (the
        model's batch of them, :meth:`TimingModel.batch_for`);
        ``track_mode`` None is ``"use_pulse_numbers"`` where the TOAs carry
        pulse numbers, else ``"nearest"`` (reference
        ``residuals.py:33-36``)."""
        batch = model.batch_for(batch)
        if track_mode is None:
            track_mode = "use_pulse_numbers" \
                if batch.get_pulse_numbers() is not None else "nearest"
        self.track_mode = track_mode
        self.batch = batch
        self.model = model
        self.subtract_mean = subtract_mean \
            and "PhaseOffset" not in model.components
        self.use_weighted_mean = use_weighted_mean
        self._phase_resids = None
        self._time_resids = None

    def calc_phase_resids(self) -> torch.Tensor:
        """Residual phase in cycles."""
        abs_phase = "AbsPhase" in self.model.components
        ph = self.model.phase(self.batch, abs_phase=abs_phase)
        dpn = self.batch.delta_pulse_number
        if self.track_mode == "use_pulse_numbers":
            pn = self.batch.get_pulse_numbers()
            if pn is None:
                raise UsageError(
                    "track_mode=use_pulse_numbers but no pulse numbers")
            resids = (ph.int_ - pn + (0.0 if dpn is None else dpn)) \
                + ph.frac
        else:
            resids = ph.frac.clone()
            if dpn is not None:
                resids = resids + dpn
        if self.subtract_mean:
            err = self.batch.error_us
            if self.use_weighted_mean and not bool((err == 0).any()):
                mean, _ = weighted_mean(resids, 1.0 / (err * err))
            else:
                mean = torch.mean(resids)
            resids = resids - mean
        self._phase_resids = resids
        return resids

    @property
    def phase_resids(self) -> torch.Tensor:
        if self._phase_resids is None:
            self.calc_phase_resids()
        return self._phase_resids

    def calc_time_resids(self) -> torch.Tensor:
        """Residuals in seconds (phase / F0)."""
        self._time_resids = self.phase_resids / self.model.value("F0")
        return self._time_resids

    @property
    def time_resids(self) -> torch.Tensor:
        if self._time_resids is None:
            self.calc_time_resids()
        return self._time_resids

    @property
    def resids(self) -> torch.Tensor:
        return self.time_resids

    @property
    def resids_value(self) -> torch.Tensor:
        """The time residuals [s] (reference ``resids_value``)."""
        return self.time_resids

    def get_data_error(self, scaled: bool = True) -> torch.Tensor:
        """TOA uncertainties in seconds, EFAC/EQUAD-scaled unless
        ``scaled`` is False."""
        if not scaled:
            return self.batch.error_us * 1e-6
        return torch.as_tensor(self.model.scaled_toa_uncertainty(self.batch),
                               dtype=F64, device=self.batch.device)

    def update(self) -> "Residuals":
        """Forget the cached residuals: the next read re-evaluates the
        model."""
        self._phase_resids = None
        self._time_resids = None
        return self

    def _corr_basis_weight(self):
        U, w = self.model.noise_model_basis_weight(self.batch)
        return self.model.augment_basis_for_offset(U, w,
                                                   n=self.batch.ntoas)

    def calc_chi2(self) -> float:
        r = self.time_resids
        sigma = self.get_data_error()
        if bool((sigma == 0).any()):
            return float("inf")
        if not self.model.has_correlated_errors:
            return float(torch.sum((r / sigma) ** 2))
        dev = r.device
        ecorr_only = all(getattr(c, "is_ecorr", False)
                         for c in self.model.noise_components
                         if c.introduces_correlated_errors)
        if ecorr_only and "PhaseOffset" in self.model.components:
            U, w = self.model.noise_model_basis_weight(self.batch)
            dot_fn = sherman_morrison_dot
        else:
            U, w = self._corr_basis_weight()
            dot_fn = woodbury_dot
        dot, _ = dot_fn(sigma * sigma,
                        torch.as_tensor(U, dtype=F64, device=dev),
                        torch.as_tensor(w, dtype=F64, device=dev), r, r)
        return float(dot)

    @property
    def chi2(self) -> float:
        return self.calc_chi2()

    def lnlikelihood(self) -> float:
        """Gaussian log-likelihood with the noise log-determinant,
        -(chi2 + logdet C + n log 2 pi) / 2, C through the scaled-basis
        Woodbury form with the overall offset marginalized."""
        r = self.time_resids
        sigma = self.get_data_error()
        n = r.shape[0]
        if not self.model.has_correlated_errors:
            chi2 = torch.sum((r / sigma) ** 2)
            logdet = torch.sum(torch.log(sigma**2))
        else:
            U, w = self._corr_basis_weight()
            chi2, logdet = woodbury_dot(
                sigma**2, torch.as_tensor(U, dtype=F64, device=r.device),
                torch.as_tensor(w, dtype=F64, device=r.device), r, r)
        return float(-0.5 * (chi2 + logdet + n * math.log(2 * math.pi)))

    @property
    def dof(self) -> int:
        return self.batch.ntoas - len(self.model.free_params) \
            - int(self.subtract_mean)

    @property
    def reduced_chi2(self) -> float:
        return self.chi2 / self.dof

    @property
    def chi2_reduced(self) -> float:
        return self.reduced_chi2

    def _weighted(self, r) -> float:
        """Mean of ``r`` weighted by the unscaled TOA errors (plain where an
        error is 0)."""
        err = self.batch.error_us
        if bool((err == 0).any()):
            return float(torch.mean(r))
        mean, _ = weighted_mean(r, 1.0 / (err * err))
        return float(mean)

    def rms_weighted(self) -> float:
        """Weighted rms of the time residuals [s], weights from the
        unscaled errors (reference ``residuals.py:151``)."""
        err = self.get_data_error(scaled=False)
        r = self.time_resids
        if bool((err == 0).any()):
            return float(torch.sqrt(torch.mean(r**2)))
        w = 1.0 / err**2
        mean, _ = weighted_mean(r, w)
        return float(torch.sqrt(torch.sum(w * (r - mean) ** 2)
                                / torch.sum(w)))

    def calc_whitened_resids(self) -> torch.Tensor:
        """(r - the fit's correlated-noise realization) / scaled sigma
        (reference ``residuals.py:161``)."""
        r = self.time_resids
        nr = self.noise_resids()
        if nr:
            r = r - sum(nr.values())
        return r / self.get_data_error()

    def calc_phase_mean(self, weighted: bool = True) -> float:
        """Mean residual phase [cycles]."""
        r = self.phase_resids
        return self._weighted(r) if weighted else float(torch.mean(r))

    def calc_time_mean(self, calctype: str = "taylor",
                       weighted: bool = True) -> float:
        """Mean residual time [s], the phase over :meth:`get_PSR_freq`."""
        r = self.phase_resids / self.get_PSR_freq(calctype)
        return self._weighted(r) if weighted else float(torch.mean(r))

    def get_PSR_freq(self, calctype: str = "modelF0"):
        """The spin frequency [Hz]: F0 ('modelF0'), or the spindown's Taylor
        series at each TOA's emission time, TDB less the model's delay
        ('taylor' or 'numerical'; reference ``residuals.py:207``), a
        tensor on the batch's device."""
        calctype = calctype.lower()
        if calctype not in ("modelf0", "taylor", "numerical"):
            raise ValueError(f"Unknown calctype {calctype!r}")
        F0 = self.model.value("F0")
        sd = self.model.components.get("Spindown")
        if calctype == "modelf0" or sd is None:
            return F0
        terms = [self.model.value(f"F{i}")
                 for i in range(int(sd.config["num_spin_terms"]))]
        tdb = self.batch.tdb.hi + self.batch.tdb.lo
        dt = (tdb - self.model.epoch_value("PEPOCH")) * 86400.0 \
            - self.model.delay(self.batch)
        freq = torch.zeros_like(dt)
        fact = 1.0
        for i, f in enumerate(terms):
            if i > 0:
                fact *= i
            freq = freq + f * dt**i / fact
        return freq

    def d_lnlikelihood_d_param(self, param: str,
                               step: Optional[float] = None) -> float:
        """d lnlikelihood / d param by central difference (reference
        ``residuals.py:240``): the step 1e-3 of the parameter's uncertainty
        where it has one, else ``max(|value| step, step)`` with
        ``step``, else 1e-6 relative; at least 8 ulp of the value."""
        par = self.model[param]
        v0 = self.model.value(param)
        if step is None:
            sig = float(par.uncertainty or 0.0)
            h = 1e-3 * sig if sig > 0 else max(abs(v0) * 1e-6, 1e-6)
        else:
            h = max(abs(v0) * step, step)
        h = max(h, 8.0 * float(np.spacing(abs(v0))))
        vals = []
        for v in (v0 + h, v0 - h):
            par.value = v
            vals.append(Residuals(self.batch, self.model).lnlikelihood())
        par.value = v0
        return (vals[0] - vals[1]) / (2 * h)

    def noise_resids(self) -> dict:
        """{noise component: its realization [s]}, the amplitudes a GLS fit
        stored in ``noise_ampls`` through the component's basis; empty
        without them."""
        ampls = self.noise_ampls
        if not ampls:
            return {}
        dev = self.batch.device
        Us, _, dims = self.model.noise_basis_by_component(self.batch)
        out = {}
        for (comp, (_, size)), U in zip(dims.items(), Us):
            a = ampls.get(comp)
            a = torch.zeros(size, dtype=F64, device=dev) if a is None \
                else torch.as_tensor(a, dtype=F64, device=dev)
            out[comp] = torch.as_tensor(U, dtype=F64, device=dev) @ a
        return out

    def ecorr_average(self, use_noise_model: bool = True) -> dict:
        """Residuals averaged over the ECORR epochs (reference
        ``residuals.py:297``): ``mjds``, ``freqs``, ``time_resids``,
        ``noise_resids`` (per component), ``errors`` (with the ECORR
        variance under ``use_noise_model``), each per epoch on the batch's
        device, and ``indices``, the TOAs of each epoch."""
        ecorrs = [c for c in self.model.noise_components
                  if getattr(c, "is_ecorr", False)]
        if not ecorrs:
            raise ValueError("ECORR not present in noise model")
        dev = self.batch.device
        U_np, ecorr_err2 = ecorrs[0].basis_weight_pair(self.model,
                                                      self.batch)
        U = torch.as_tensor(U_np, dtype=F64, device=dev)
        ecorr_err2 = torch.as_tensor(ecorr_err2, dtype=F64, device=dev)
        err = self.get_data_error(scaled=use_noise_model)
        if not use_noise_model:
            ecorr_err2 = ecorr_err2 * 0.0
        wt = 1.0 / (err * err)
        a_norm = U.T @ wt

        def wtsum(x):
            return (U.T @ (wt * x)) / a_norm

        mjds = torch.as_tensor(self.batch.mjds, dtype=F64, device=dev)
        return {
            "mjds": wtsum(mjds),
            "freqs": wtsum(self.batch.freq),
            "time_resids": wtsum(self.time_resids),
            "noise_resids": {k: wtsum(v)
                             for k, v in self.noise_resids().items()},
            "errors": torch.sqrt(1.0 / a_norm + ecorr_err2),
            "indices": [list(np.nonzero(U_np[:, i])[0])
                        for i in range(U_np.shape[1])],
        }
