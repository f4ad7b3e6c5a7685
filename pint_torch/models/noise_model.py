"""Noise components: EFAC/EQUAD scaling, DMEFAC/DMEQUAD scaling of
wideband DM uncertainties, ECORR and the power-law Fourier processes --
achromatic red noise, DM noise, chromatic noise and solar-wind noise (port
of ``pint_tpu/models/noise_model.py:55-122,161-250,252-288,289-368,
370-569``).

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

from pint_torch.logging import log
from pint_torch.models.parameter import (floatParameter, intParameter,
                                         maskParameter)
from pint_torch.models.timing_model import NoiseComponent

__all__ = ["ScaleToaError", "ScaleDmError", "EcorrNoise", "PLRedNoise", "PLDMNoise",
           "PLChromNoise", "PLSWNoise", "ecorr_epochs",
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


def _powerlaw_psd(f, A, gamma):
    """P(f) = A^2/(12 pi^2) fyr^-3 (f/fyr)^-gamma, the factored form with no
    ~1e44 ``f**-gamma`` intermediate; ``f``, ``A`` and ``gamma`` may be
    numpy values or tensors (the noise likelihood's weights)."""
    x = f / FYR
    return A**2 / 12.0 / np.pi**2 * FYR ** (-3.0) * x ** (-gamma)


def powerlaw(f, A: float, gamma: float) -> np.ndarray:
    """:func:`_powerlaw_psd` on host numpy."""
    return _powerlaw_psd(np.asarray(f, float), A, gamma)


def _tdb_seconds(batch) -> np.ndarray:
    return batch.tdb.hi.cpu().numpy() * DAY_S


def _masked(comp, prefix: str, batch=None):
    """(name, value, mask) of the component's set ``PREFIX<n>`` masks, in
    index order: the masks of ``batch``'s own contexts where it carries
    them (a subset), else the component's."""
    model = comp._parent
    names = sorted((p for p in comp.params
                    if p.startswith(prefix) and p[len(prefix):].isdigit()),
                   key=lambda p: int(p[len(prefix):]))
    ctx = comp.context if batch is None else comp.build_context(batch)
    return [(n, model.params_table[n].value, ctx["masks"][n])
            for n in names if model.params_table[n].value is not None]


def _masks_of(comp, prefix: str) -> List[str]:
    """The component's ``PREFIX<n>`` parameter names in index order."""
    return sorted((p for p in comp.params
                   if p.startswith(prefix) and p[len(prefix):].isdigit()),
                  key=lambda p: int(p[len(prefix):]))


def _check_unique_selections(comp, prefix: str) -> None:
    """ValueError where two set ``PREFIX<n>`` masks select alike (the
    reference's EFAC/EQUAD/ECORR ``validate``)."""
    seen = []
    for p in _masks_of(comp, prefix):
        par = getattr(comp, p)
        if par.value is None:
            continue
        kv = (par.key, tuple(par.key_value))
        if kv in seen:
            raise ValueError(f"Duplicate {prefix} selection {kv}")
        seen.append(kv)


class ScaleToaError(NoiseComponent):
    """sigma' = EFAC * sqrt(sigma^2 + EQUAD^2) per mask selection.
    Context: ``masks`` {parameter name: (N,) bool numpy}."""

    register = True
    category = "scale_toa_error"

    def declare(self):
        self.add_param(maskParameter(
            "EFAC", index=1, units="", aliases=["T2EFAC", "TNEF"],
            description="Multiplier on TOA uncertainties"))
        self.add_param(maskParameter(
            "EQUAD", index=1, units="us", aliases=["T2EQUAD"],
            description="Error added in quadrature (us)"))
        self.add_param(maskParameter(
            "TNEQ", index=1, units="log10(s)",
            description="Quadrature error, log10(seconds)"))

    def setup(self):
        # each TNEQ becomes an EQUAD unless an EQUAD already selects the
        # same TOAs (reference ``noise_model.py:180-212``)
        pd = self._params_dict
        for tneq in _masks_of(self, "TNEQ"):
            tp = pd[tneq]
            if tp.value is None or tp.key is None:
                continue
            equad_sels = {(pd[e].key, tuple(pd[e].key_value))
                          for e in _masks_of(self, "EQUAD")
                          if pd[e].value is not None}
            if (tp.key, tuple(tp.key_value)) in equad_sels:
                log.warning(f"{tneq} {tp.key} {tp.key_value} is provided by "
                            "an EQUAD; using EQUAD")
                continue
            idx = tp.index
            while f"EQUAD{idx}" in pd and pd[f"EQUAD{idx}"].value is not None:
                idx += 1
            if f"EQUAD{idx}" not in pd:
                self.add_param(maskParameter("EQUAD", index=idx, units="us"))
            ep = pd[f"EQUAD{idx}"]
            ep.value = 10.0 ** tp.value * 1e6  # s -> us
            ep.key, ep.key_value = tp.key, list(tp.key_value)

    def validate(self):
        for prefix in ("EFAC", "EQUAD"):
            _check_unique_selections(self, prefix)

    def scale_toa_sigma(self, model, batch, sigma_s: np.ndarray) -> np.ndarray:
        out = np.array(sigma_s, dtype=np.float64, copy=True)
        for _, v, m in _masked(self, "EQUAD", batch):
            out[m] = np.hypot(out[m], v * 1e-6)
        for _, v, m in _masked(self, "EFAC", batch):
            out[m] *= v
        return out


class ScaleDmError(NoiseComponent):
    """sigma_dm' = DMEFAC * sqrt(sigma_dm^2 + DMEQUAD^2) per mask
    selection, all quadrature adds first (DMEQUAD in pc/cm^3): the wideband
    DM uncertainties.  Context: ``masks`` {parameter name: (N,) bool
    numpy}."""

    register = True
    category = "scale_dm_error"

    def declare(self):
        self.add_param(maskParameter(
            "DMEFAC", index=1, units="",
            description="Multiplier on DM uncertainties"))
        self.add_param(maskParameter(
            "DMEQUAD", index=1, units="pc/cm3",
            description="DM error added in quadrature"))

    def scale_dm_sigma(self, model, batch, sigma_dm: np.ndarray) -> np.ndarray:
        out = np.array(sigma_dm, dtype=np.float64, copy=True)
        for _, v, m in _masked(self, "DMEQUAD", batch):
            out[m] = np.hypot(out[m], v)
        for _, v, m in _masked(self, "DMEFAC", batch):
            out[m] *= v
        return out


class EcorrNoise(NoiseComponent):
    """Epoch-correlated white noise: quantization basis, weight ECORR^2.
    Context: ``masks`` {parameter name: (N,) bool numpy}."""

    register = True
    category = "ecorr_noise"
    introduces_correlated_errors = True
    is_ecorr = True

    def declare(self):
        self.add_param(maskParameter(
            "ECORR", index=1, units="us", aliases=["TNECORR"],
            description="Epoch-correlated error (us)"))

    def validate(self):
        _check_unique_selections(self, "ECORR")

    def basis_weight_pair(self, model, batch) -> Tuple[np.ndarray, np.ndarray]:
        t = _tdb_seconds(batch)
        umats, weights = [], []
        for _, v, m in _masked(self, "ECORR", batch):
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


#: the reference frequency of the chromatic noise bases [MHz]
_FREF_MHZ = 1400.0


def _bary_freq_mhz(model, toas) -> np.ndarray:
    """The TOAs' barycentric radio frequency [MHz] on the host, from the
    model's astrometry at its current values (reference
    ``noise_model.py:129``): the topocentric one without astrometry."""
    freq = np.asarray(toas.get_freqs(), dtype=np.float64)
    astro = next((c for c in model.components.values()
                  if hasattr(c, "barycentric_radio_freq")), None)
    if astro is None or toas.ssb_obs_vel_kms is None:
        return freq
    batch = toas.to_batch(device="cpu")
    return astro.barycentric_radio_freq(model.const_pv(), batch).numpy()


class _PLNoise(NoiseComponent):
    """A power-law Fourier process: sin/cos basis over the data span (or
    ``tspan_s``), power-law weights.  Config: ``amp``, ``gam``,
    ``n_lin``, ``n_log``, ``f_min_ratio``, ``tspan_s`` (None: the data
    span) -- the reference's ``get_plc_vals`` resolved on the host; a
    chromatic process's per-TOA basis scale is its context's ``scale``,
    built on the host with the snapshot.  The amplitude and index follow
    the parameters ``_plc`` names (log10 amplitude, index) where the table
    sets them, so a noise fit's new values reach the weights."""

    introduces_correlated_errors = True
    #: (log10 amplitude, spectral index) parameters
    _plc = ("", "")
    #: the parameter prefix (``TNRED``), its description's name and the
    #: default number of linear modes (reference ``noise_model.py:370``)
    _tn = ("", "", 30)
    #: whether the process has a TSPAN override parameter
    _has_tspan = True

    def declare(self):
        pre, what, _ = self._tn
        self.add_param(floatParameter(f"{pre}AMP", units="",
                                      description=f"log10 {what} amplitude"))
        self.add_param(floatParameter(f"{pre}GAM", units="",
                                      description=f"{what} spectral index"))
        self.add_param(intParameter(f"{pre}C",
                                    description=f"Number of {what} modes"))
        self.add_param(intParameter(
            f"{pre}FLOG", description="Number of log-spaced modes"))
        self.add_param(floatParameter(f"{pre}FLOG_FACTOR", units="",
                                      description="Log-spacing factor"))
        if self._has_tspan:
            self.add_param(floatParameter(
                f"{pre}TSPAN", units="year",
                description="Fundamental-period override"))

    def _plc_vals(self):
        """(amplitude, index, linear modes, log modes, lowest frequency
        ratio) of the parameters (reference ``get_plc_vals``)."""
        pre, _, default_c = self._tn
        n_lin = int(self._value(f"{pre}C") or default_c)
        nlog = self._value(f"{pre}FLOG")
        n_log = int(nlog) if nlog is not None else None
        fac = self._value(f"{pre}FLOG_FACTOR") or 2.0
        amp = 10.0 ** self._value(f"{pre}AMP")
        fmr = 1.0 / fac**n_log if n_log is not None else 1.0
        return amp, self._value(f"{pre}GAM"), n_lin, n_log, fmr

    def finish_config(self):
        amp, gam, n_lin, n_log, fmr = self._plc_vals()
        ts = self._value(f"{self._tn[0]}TSPAN") if self._has_tspan else None
        self.config.update(
            amp=float(amp), gam=float(gam), n_lin=int(n_lin), n_log=n_log,
            f_min_ratio=float(fmr),
            tspan_s=None if ts is None else float(ts) * 365.25 * 86400)

    def basis_scale(self, toas) -> Optional[np.ndarray]:
        """The per-TOA multiplier of the Fourier basis for host TOAs (the
        reference's ``_chromatic_scale``); None: achromatic."""
        return None

    def host_context(self, toas) -> dict:
        ctx = super().host_context(toas)
        scale = self.basis_scale(toas)
        if scale is not None:
            ctx["scale"] = np.asarray(scale, dtype=np.float64)
        return ctx

    def amp_gam(self):
        """(amplitude, spectral index) at the table's current values
        (reference ``get_plc_vals``), else the snapshot's."""
        table = self._parent.params_table
        amp_p, gam_p = (table.get(p) for p in self._plc)
        if amp_p is None or amp_p.value is None:
            return self.config["amp"], self.config["gam"]
        return 10.0 ** amp_p.value, gam_p.value

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
        scale = self.build_context(batch).get("scale")
        if scale is not None:
            F = F * np.asarray(scale, dtype=np.float64)[:, None]
        df = np.diff(np.concatenate([[0.0], f]))
        w = powerlaw(np.repeat(f, 2), *self.amp_gam()) * np.repeat(df, 2)
        return F, w


class PLRedNoise(_PLNoise):
    """Achromatic power-law red noise (TNREDAMP/TNREDGAM/TNREDC, or the
    tempo1 RNAMP/RNIDX where TNREDAMP is unset)."""

    register = True
    category = "pl_red_noise"
    _plc = ("TNREDAMP", "TNREDGAM")
    _tn = ("TNRED", "red-noise", 30)
    #: tempo1 RNAMP -> GW-convention amplitude divisor
    RN_FAC = (86400.0 * 365.24 * 1e6) / (2.0 * np.pi * np.sqrt(3.0))

    def declare(self):
        self.add_param(floatParameter(
            "RNAMP", units="",
            description="Red-noise amplitude (tempo1 convention)"))
        self.add_param(floatParameter(
            "RNIDX", units="", description="Red-noise spectral index (tempo1)"))
        super().declare()

    def _plc_vals(self):
        if self._value("TNREDAMP") is None and self._value("RNAMP") is not None:
            # tempo1 RNAMP -> GW-convention amplitude
            n_lin = int(self._value("TNREDC") or 30)
            nlog = self._value("TNREDFLOG")
            n_log = int(nlog) if nlog is not None else None
            facl = self._value("TNREDFLOG_FACTOR") or 2.0
            fmr = 1.0 / facl**n_log if n_log is not None else 1.0
            return (self._value("RNAMP") / self.RN_FAC,
                    -1.0 * self._value("RNIDX"), n_lin, n_log, fmr)
        return super()._plc_vals()

    def amp_gam(self):
        table = self._parent.params_table
        tn, rn = table.get("TNREDAMP"), table.get("RNAMP")
        if (tn is None or tn.value is None) and rn is not None \
                and rn.value is not None:
            return rn.value / self.RN_FAC, -1.0 * table["RNIDX"].value
        return super().amp_gam()


class PLDMNoise(_PLNoise):
    """Power-law DM noise (reference ``noise_model.py:495``): the basis
    scaled by (1400 MHz / f_bary)^2 (context ``scale``)."""

    register = True
    category = "pl_DM_noise"
    _plc = ("TNDMAMP", "TNDMGAM")
    _tn = ("TNDM", "DM-noise", 30)

    def basis_scale(self, toas):
        return (_FREF_MHZ / _bary_freq_mhz(self._parent, toas)) ** 2


class PLChromNoise(_PLNoise):
    """Power-law chromatic noise (reference ``noise_model.py:519``): the
    basis scaled by (1400 MHz / f_bary)^TNCHROMIDX (context ``scale``)."""

    register = True
    category = "pl_chrom_noise"
    _plc = ("TNCHROMAMP", "TNCHROMGAM")
    _tn = ("TNCHROM", "chromatic-noise", 30)

    def basis_scale(self, toas):
        alpha = float(self._value("TNCHROMIDX") or 4.0)
        return (_FREF_MHZ / _bary_freq_mhz(self._parent, toas)) ** alpha


class PLSWNoise(_PLNoise):
    """Power-law solar-wind density noise (reference
    ``noise_model.py:545-569``): the basis scaled by the solar-wind DM
    geometry at 1 cm^-3 times DMconst / f_bary^2 (context ``scale``)."""

    register = True
    category = "pl_sw_noise"
    _plc = ("TNSWAMP", "TNSWGAM")
    _tn = ("TNSW", "solar-wind-noise", 100)
    _has_tspan = False

    def basis_scale(self, toas):
        """The solar wind's DM geometry at 1 cm^-3 (its SWM and SWP) times
        DMconst / f_bary^2."""
        from pint_torch.models.dispersion_model import DMconst

        sw = self._parent.components.get("SolarWindDispersion")
        if sw is None:
            raise ValueError(
                "PLSWNoise requires a SolarWindDispersion component")
        geometry = sw.geometry(self._parent.const_pv(),
                               toas.to_batch(device="cpu")).numpy()
        freq = _bary_freq_mhz(self._parent, toas)
        return np.reshape(geometry, np.shape(freq)) * DMconst / freq**2
