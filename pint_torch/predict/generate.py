"""Batched polyco generation (port of ``pint_tpu/predict/generate.py``).

The host half follows :meth:`pint_torch.polycos.Polycos.generate_polycos`:
Chebyshev-spaced node epochs in every window, one pass of the host layer
(clock corrections, TDB, posvels) and one evaluation of the model's
absolute phase over all windows at once, each window's midpoint quantized
to the TEMPO text format's %.11f up front, and the ramp-removed target
``y = (phase - rphase) - 60 f0 dt`` at the scaled nodes ``x = dt / half``.

The device half fits every (pulsar, window) row in one launch of K14
(:mod:`pint_torch.kernels.polyco_fit`), the rows padded onto
:data:`DEFAULT_WINDOW_BUCKETS` (pad rows: the last window's nodes against
a zero target, which solve to zero).  The coefficients are rescaled to
TEMPO's per-minute powers on the host, so a :class:`PredictorSet`
round-trips through :class:`~pint_torch.polycos.PolycoEntry` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from pint_torch import F64, resolve_device
from pint_torch.exceptions import UsageError
from pint_torch.kernels.polyco_fit import polyco_fit
from pint_torch.logging import log
from pint_torch.polycos import MIN_PER_DAY, PolycoEntry, Polycos
from pint_torch.serving.batcher import bucket_of

__all__ = ["DEFAULT_WINDOW_BUCKETS", "FIT_RMS_WARN", "PredictorSet",
           "fit_windows", "node_targets", "window_tmids",
           "generate_predictors", "generate_predictor_sets"]

#: window-count ladder of the batched fit: a grid's rows pad up to the
#: nearest rung (the reference's executable-sharing ladder, kept so that
#: the port launches on the same shapes)
DEFAULT_WINDOW_BUCKETS = (4, 16, 64, 256)

#: the fit-quality bar [cycles rms over the nodes]: a window above it is
#: logged
FIT_RMS_WARN = 1e-8

_POOL = ("the warm pool (pool=) is ROADMAP queue A item 8, not ported "
         "yet")


def fit_windows(x: np.ndarray, y: np.ndarray, ncoeff: int, half: float,
                pool=None,
                window_buckets: Sequence[int] = DEFAULT_WINDOW_BUCKETS,
                device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Fit ``coeffs (W, ncoeff)`` (TEMPO per-minute powers) to targets
    ``y (W, nnode)`` at scaled nodes ``x (W, nnode)`` in one padded launch
    of K14 on ``device`` (default ``"cuda"``).  Returns ``(coeffs,
    rms_cycles)``, host numpy."""
    if pool is not None:
        raise NotImplementedError(f"fit_windows(pool=...): {_POOL}")
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.ndim != 2 or x.shape != y.shape:
        raise UsageError(
            f"fit_windows takes matching (W, nnode) node/target "
            f"arrays, got {x.shape} and {y.shape}")
    dev = resolve_device(device)
    W, nnode = x.shape
    Wb = bucket_of(W, tuple(window_buckets))
    xp = np.zeros((Wb, nnode))
    yp = np.zeros((Wb, nnode))
    xp[:W], yp[:W] = x, y
    if Wb > W:
        # pad rows reuse the last window's (nonsingular) node grid against
        # a zero target: they solve to zero and are sliced away below
        xp[W:] = x[-1]
    cx, rms = polyco_fit(torch.tensor(xp, dtype=F64, device=dev),
                         torch.tensor(yp, dtype=F64, device=dev), ncoeff)
    cx = cx.cpu().numpy()[:W]
    rms = rms.cpu().numpy()[:W]
    coeffs = cx / float(half) ** np.arange(ncoeff)
    for s in np.nonzero(rms > FIT_RMS_WARN)[0]:
        log.warning(f"predict window {int(s)}: fit rms "
                    f"{float(rms[s]):.2e} cycles")
    return coeffs, rms


# -- the host half: node epochs and ramp-removed targets --------------------

def window_tmids(mjd_start: float, mjd_end: float,
                 segLength: float) -> np.ndarray:
    """The window midpoints covering ``[mjd_start, mjd_end)``, each
    quantized to the TEMPO text format's %.11f up front."""
    if not mjd_end > mjd_start:
        raise UsageError(
            f"predictor grid needs mjd_end > mjd_start, got "
            f"[{mjd_start}, {mjd_end})")
    span_d = segLength / MIN_PER_DAY
    nseg = max(1, int(np.ceil((mjd_end - mjd_start) / span_d - 1e-9)))
    return np.array([round(mjd_start + s * span_d + span_d / 2, 11)
                     for s in range(nseg)])


def node_mjds(tmids: np.ndarray, segLength: float, ncoeff: int):
    """``(mjds (W, nnode), nnode)``: each window's Chebyshev nodes."""
    span_d = segLength / MIN_PER_DAY
    nnode = max(2 * ncoeff, ncoeff + 4)
    k = np.arange(nnode)
    cheb = np.cos(np.pi * (k + 0.5) / nnode)[::-1]  # (-1, 1)
    return tmids[:, None] + cheb[None, :] * (span_d / 2), nnode


def node_toas(model, mjds: np.ndarray, obs: str, obsFreq: float):
    """The host layer's TOAs at the node epochs ``mjds`` (flattened):
    clock corrections (zero at the barycentre), TDB and posvels with the
    model's ephemeris and planets."""
    from pint_torch.observatory import get_observatory
    from pint_torch.toa import TOAs

    obsname = get_observatory(obs).name
    flat = np.asarray(mjds, dtype=np.float64).ravel()
    n = len(flat)
    ts = TOAs(utc_mjd=np.asarray(flat, dtype=np.longdouble),
              error_us=np.ones(n), freq_mhz=np.full(n, obsFreq),
              obs=np.array([obsname] * n, dtype=object),
              flags=[{} for _ in range(n)])
    include_bipm = str(model["CLOCK"].value or "").upper() \
        .startswith("TT(BIPM")
    if obsname != "barycenter":
        ts.apply_clock_corrections(include_bipm=include_bipm)
    else:
        ts.clock_corr_s = np.zeros(n)
    ephem = model["EPHEM"].value or "DE440"
    ts.compute_TDBs(ephem=ephem)
    ts.compute_posvels(ephem=ephem,
                       planets=bool(model["PLANET_SHAPIRO"].value))
    return ts


def node_targets(model, tmids: np.ndarray, segLength: float,
                 ncoeff: int, obs: str, obsFreq: float) -> dict:
    """The host half of generation for one pulsar: the model's absolute
    phase at every window's nodes in one batch (TOAs made by the host
    layer, the phase on the model's device), then the ramp-removed
    targets.  Returns ``{x (W, nnode), y (W, nnode), rint (W,), rfrac
    (W,), f0, psrname, obsname}``."""
    tmids = np.asarray(tmids, dtype=np.float64)
    W = len(tmids)
    mjds, nnode = node_mjds(tmids, segLength, ncoeff)
    ts = node_toas(model, mjds, obs, obsFreq)
    ph = model.phase(ts, abs_phase="AbsPhase" in model.components)
    ph_int = ph.int_.cpu().numpy().reshape(W, nnode)
    ph_frac = ph.frac.cpu().numpy().reshape(W, nnode)
    f0 = float(model["F0"].value)
    dt_min = (mjds - tmids[:, None]) * MIN_PER_DAY
    imid = np.argmin(np.abs(dt_min), axis=1)
    rows = np.arange(W)
    rint = ph_int[rows, imid]
    rfrac = ph_frac[rows, imid]
    y = (ph_int - rint[:, None]) + (ph_frac - rfrac[:, None]) \
        - 60.0 * f0 * dt_min
    return {"x": dt_min / (segLength / 2.0), "y": y,
            "rint": rint, "rfrac": rfrac, "f0": f0,
            "psrname": str(model["PSR"].value or ""),
            "obsname": str(ts.obs[0])}


# -- the assembled predictor set --------------------------------------------

@dataclass
class PredictorSet:
    """One pulsar's predictor grid: the arrays a polyco file carries,
    window-major (convertible to a host :class:`~pint_torch.polycos.
    Polycos`)."""

    psrname: str
    obsname: str
    obsfreq: float
    segLength: float               #: window span, minutes
    ncoeff: int
    f0: float
    tmid: np.ndarray               #: (W,) window centers, MJD
    rphase_int: np.ndarray         #: (W,) reference phase, integer part
    rphase_frac: np.ndarray        #: (W,) reference phase, frac part
    coeffs: np.ndarray             #: (W, ncoeff) per-minute powers
    fit_rms: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def n_windows(self) -> int:
        return len(self.tmid)

    @property
    def tstart(self) -> np.ndarray:
        return self.tmid - self.segLength / (2 * MIN_PER_DAY)

    @property
    def tstop(self) -> np.ndarray:
        return self.tmid + self.segLength / (2 * MIN_PER_DAY)

    def to_polycos(self) -> Polycos:
        """The equivalent host :class:`~pint_torch.polycos.Polycos`."""
        return Polycos([
            PolycoEntry(float(self.tmid[s]), self.segLength,
                        int(self.rphase_int[s]),
                        float(self.rphase_frac[s]), self.f0,
                        self.ncoeff, self.coeffs[s], obs=self.obsname,
                        obsfreq=self.obsfreq, psrname=self.psrname)
            for s in range(self.n_windows)])


def generate_predictor_sets(
        models: Sequence, mjd_start: float, mjd_end: float, obs: str,
        segLength: float = 60.0, ncoeff: int = 12,
        obsFreq: float = 1400.0, pool=None,
        window_buckets: Sequence[int] = DEFAULT_WINDOW_BUCKETS,
        device=None) -> List[PredictorSet]:
    """Predictor grids for several pulsars over one epoch range: each
    model's phase at its node grids, then every (pulsar, window) row in
    one padded K14 launch on ``device`` (default ``"cuda"``)."""
    if not models:
        raise UsageError("generate_predictor_sets needs >= 1 model")
    if pool is not None:
        raise NotImplementedError(f"generate_predictor_sets(pool=...): "
                                  f"{_POOL}")
    dev = resolve_device(device)
    tmids = window_tmids(mjd_start, mjd_end, segLength)
    host = [node_targets(m, tmids, segLength, ncoeff, obs, obsFreq)
            for m in models]
    x = np.concatenate([h["x"] for h in host])
    y = np.concatenate([h["y"] for h in host])
    coeffs, rms = fit_windows(x, y, ncoeff, segLength / 2.0,
                              window_buckets=window_buckets, device=dev)
    W = len(tmids)
    out = []
    for i, h in enumerate(host):
        sl = slice(i * W, (i + 1) * W)
        out.append(PredictorSet(
            psrname=h["psrname"], obsname=h["obsname"],
            obsfreq=float(obsFreq), segLength=float(segLength),
            ncoeff=int(ncoeff), f0=h["f0"], tmid=tmids.copy(),
            rphase_int=h["rint"].copy(), rphase_frac=h["rfrac"].copy(),
            coeffs=coeffs[sl].copy(), fit_rms=rms[sl].copy()))
    return out


def generate_predictors(model, mjd_start: float, mjd_end: float,
                        obs: str, segLength: float = 60.0,
                        ncoeff: int = 12, obsFreq: float = 1400.0,
                        pool=None, device=None) -> PredictorSet:
    """One pulsar's grid (:func:`generate_predictor_sets`)."""
    return generate_predictor_sets(
        [model], mjd_start, mjd_end, obs, segLength=segLength,
        ncoeff=ncoeff, obsFreq=obsFreq, pool=pool, device=device)[0]
