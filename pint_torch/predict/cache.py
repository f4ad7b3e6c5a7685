"""Per-pulsar predictor caches, invalidated by span (port of
``pint_tpu/predict/cache.py``).

A :class:`PredictorCache` owns one pulsar's window grid over a fixed
epoch range and builds coefficients lazily, per window: a window is fitted
the first time a prediction needs it and again only after an invalidation
marks it stale.  :meth:`PredictorCache.invalidate_span` stales only the
windows whose validity spans an accepted append's epochs; a
quarantine-only batch moves no parameter, so nothing regenerates.
Windows the span does not cover keep their coefficients (the polyco
convention; ``regen_count`` makes the staleness auditable).

Identity follows the vkey scheme (:func:`pint_torch.grid._model_param_sig`
+ the TOA version + the window grid).  The reference's ``predictor_cache``
telemetry events are no-ops: the port collects no telemetry
(:func:`pint_torch.config.telemetry_mode`, ROADMAP queue A item 8).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from pint_torch import config, resolve_device
from pint_torch.exceptions import UsageError
from pint_torch.polycos import MIN_PER_DAY, Polycos
from pint_torch.predict.generate import (DEFAULT_WINDOW_BUCKETS,
                                         PredictorSet, fit_windows,
                                         node_targets, window_tmids)

__all__ = ["PredictorCache", "EDGE_TOL"]

#: boundary tolerance [days]: the midpoints' quantization can open
#: ~1e-11-day gaps at window edges, and a polynomial is valid that far
#: outside its span
EDGE_TOL = 1e-9


def _emit_event(name: str, **attrs) -> None:
    """The reference's predictor-cache telemetry event: nothing is
    recorded while the telemetry mode is ``off``, the only one the port
    has (any other raises, naming ROADMAP queue A item 8)."""
    config.telemetry_mode()


class PredictorCache:
    """One pulsar's predictor state over a fixed window grid.

    ``model`` is the live :class:`~pint_torch.models.timing_model.
    TimingModel` (for streaming, the object the engine's warm refits
    update in place); ``toas`` optionally ties the vkey to a TOA set's
    version counter; ``device`` (default ``"cuda"``) runs the fits and
    the door's evaluations."""

    def __init__(self, model, mjd_start: float, mjd_end: float,
                 obs: str = "@", segLength: float = 60.0,
                 ncoeff: int = 12, obsFreq: float = 1400.0,
                 toas=None, pool=None,
                 window_buckets: Sequence[int] = DEFAULT_WINDOW_BUCKETS,
                 device=None):
        from pint_torch.grid import _model_param_sig
        from pint_torch.observatory import get_observatory

        if int(ncoeff) < 2:
            raise UsageError(f"PredictorCache needs ncoeff >= 2, "
                             f"got {ncoeff}")
        if pool is not None:
            raise NotImplementedError(
                "PredictorCache(pool=...): the warm pool is ROADMAP queue A "
                "item 8, not ported yet")
        self.device = resolve_device(device)
        self.model = model
        self.mjd_start = float(mjd_start)
        self.mjd_end = float(mjd_end)
        self.obs = obs
        self.obsname = get_observatory(obs).name
        self.segLength = float(segLength)
        self.ncoeff = int(ncoeff)
        self.obsFreq = float(obsFreq)
        self.window_buckets = tuple(window_buckets)
        self._toas = toas
        self.pool = None
        self._tmid = window_tmids(self.mjd_start, self.mjd_end,
                                  self.segLength)
        W = len(self._tmid)
        half_d = self.segLength / (2 * MIN_PER_DAY)
        self._tstart = self._tmid - half_d
        self._tstop = self._tmid + half_d
        self._rint = np.zeros(W)
        self._rfrac = np.zeros(W)
        self._coeffs = np.zeros((W, self.ncoeff))
        self._rms = np.zeros(W)
        self._fresh = np.zeros(W, dtype=bool)
        #: per-window rebuild counter: an append regenerates only its span
        self.regen_count = np.zeros(W, dtype=np.int64)
        self.f0 = float(model["F0"].value)
        self._sig = _model_param_sig(model)
        self.hits = 0
        self.misses = 0
        self.invalidated = 0
        self.regenerated = 0

    # -- identity ------------------------------------------------------------

    @property
    def n_windows(self) -> int:
        return len(self._tmid)

    @property
    def nnode(self) -> int:
        return max(2 * self.ncoeff, self.ncoeff + 4)

    @property
    def grid_key(self) -> tuple:
        return (round(self.mjd_start, 11), round(self.mjd_end, 11),
                self.segLength, self.ncoeff, self.obsname, self.obsFreq)

    @property
    def vkey(self) -> tuple:
        """Parameter/mask signature + TOA version + window grid."""
        tv = (int(getattr(self._toas, "_version", 0)),
              _ntoas(self._toas)) if self._toas is not None else (0, 0)
        return (self._sig, tv, self.grid_key)

    def coverage(self) -> Tuple[float, float]:
        """The epoch range the grid answers for, [start, stop)."""
        return float(self._tstart[0]), float(self._tstop[-1])

    # -- dispatch ------------------------------------------------------------

    def window_of(self, t_mjd) -> np.ndarray:
        """Window index per time: half-open spans with EDGE_TOL at the
        grid's ends; a time outside coverage is refused."""
        t = np.atleast_1d(np.asarray(t_mjd, dtype=np.float64))
        idx = np.clip(np.searchsorted(self._tstart, t, side="right") - 1,
                      0, self.n_windows - 1)
        bad = (t < self._tstart[idx] - EDGE_TOL) \
            | (t > self._tstop[idx] + EDGE_TOL)
        if np.any(bad):
            lo, hi = self.coverage()
            raise UsageError(
                f"prediction epoch(s) {t[bad][:3]} outside this "
                f"predictor grid's coverage [{lo}, {hi})")
        return idx

    # -- invalidation --------------------------------------------------------

    def _adopt_model(self) -> None:
        from pint_torch.grid import _model_param_sig

        self._sig = _model_param_sig(self.model)
        self.f0 = float(self.model["F0"].value)

    def _check_sig(self) -> None:
        """A parameter or mask signature moved outside the streaming
        hook stales the whole grid."""
        from pint_torch.grid import _model_param_sig

        if _model_param_sig(self.model) != self._sig:
            self._adopt_model()
            self._mark_stale(np.nonzero(self._fresh)[0])

    def _mark_stale(self, idxs: np.ndarray) -> int:
        idxs = np.asarray(idxs, dtype=int)
        live = idxs[self._fresh[idxs]] if len(idxs) else idxs
        if len(live):
            self._fresh[live] = False
            self.invalidated += len(live)
            _emit_event("predictor_cache", kind="invalidate",
                        windows=int(len(live)), latency_ms=0.0)
        return int(len(live))

    def invalidate_all(self) -> int:
        """Stale every built window; returns the count."""
        self._adopt_model()
        return self._mark_stale(np.nonzero(self._fresh)[0])

    def invalidate_span(self, lo_mjd: float, hi_mjd: float) -> int:
        """The streaming hook: stale only the windows whose validity spans
        ``[lo_mjd, hi_mjd]`` and adopt the model's signature; returns the
        count."""
        self._adopt_model()
        hit = np.nonzero((self._tstart <= float(hi_mjd))
                         & (self._tstop >= float(lo_mjd))
                         & self._fresh)[0]
        return self._mark_stale(hit)

    # -- (re)generation ------------------------------------------------------

    def ensure(self, idxs) -> int:
        """Fit the stale or unbuilt windows among ``idxs`` in one padded
        K14 launch; returns the count."""
        idxs = np.unique(np.asarray(idxs, dtype=int))
        todo = idxs[~self._fresh[idxs]]
        if not len(todo):
            return 0
        host = node_targets(self.model, self._tmid[todo], self.segLength,
                            self.ncoeff, self.obs, self.obsFreq)
        coeffs, rms = fit_windows(
            host["x"], host["y"], self.ncoeff, self.segLength / 2.0,
            window_buckets=self.window_buckets, device=self.device)
        self._rint[todo] = host["rint"]
        self._rfrac[todo] = host["rfrac"]
        self._coeffs[todo] = coeffs
        self._rms[todo] = rms
        self._fresh[todo] = True
        self.regen_count[todo] += 1
        self.regenerated += len(todo)
        _emit_event("predictor_cache", kind="regenerate",
                    windows=int(len(todo)))
        return int(len(todo))

    def build(self) -> int:
        """Fit every stale window now (a prebuilt grid serves its first
        request all-hit)."""
        return self.ensure(np.arange(self.n_windows))

    # -- the gather the door dispatches through -------------------------------

    def gather(self, times_mjd) -> dict:
        """Per-time operands of the batched evaluation: windows fitted
        where needed (hits and misses counted per window) and
        ``dt/rfrac/rint/f0/coeffs`` gathered, host numpy."""
        t = np.atleast_1d(np.asarray(times_mjd, dtype=np.float64))
        self._check_sig()
        idx = self.window_of(t)
        needed = np.unique(idx)
        n_hit = int(np.count_nonzero(self._fresh[needed]))
        n_miss = int(len(needed) - n_hit)
        self.hits += n_hit
        self.misses += n_miss
        if n_miss:
            self.ensure(needed[~self._fresh[needed]])
        return {"dt": (t - self._tmid[idx]) * MIN_PER_DAY,
                "rfrac": self._rfrac[idx],
                "rint": self._rint[idx],
                "f0": np.full(len(t), self.f0),
                "coeffs": self._coeffs[idx],
                "windows": idx}

    def predict(self, times_mjd) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """Host prediction ``(phase_int, phase_frac, freq)`` by the Horner
        recurrence K13 runs, in numpy (the bitwise pin of K13's plain
        version)."""
        g = self.gather(times_mjd)
        dt, coeffs = g["dt"], g["coeffs"]
        poly = np.zeros_like(dt)
        dpoly = np.zeros_like(dt)
        for i in range(self.ncoeff - 1, 0, -1):
            poly = poly * dt + coeffs[:, i]
            dpoly = dpoly * dt + i * coeffs[:, i]
        poly = poly * dt + coeffs[:, 0]
        raw = g["rfrac"] + 60.0 * g["f0"] * dt + poly
        ip = np.floor(raw)
        return g["rint"] + ip, raw - ip, g["f0"] + dpoly / 60.0

    # -- export --------------------------------------------------------------

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"windows": int(self.n_windows),
                "hits": int(self.hits), "misses": int(self.misses),
                "invalidated": int(self.invalidated),
                "regenerated": int(self.regenerated),
                "hit_rate": (self.hits / total) if total else 0.0}

    def to_predictor_set(self) -> PredictorSet:
        """The built grid as a :class:`PredictorSet` (every window fitted
        first)."""
        self.build()
        return PredictorSet(
            psrname=str(self.model["PSR"].value or ""),
            obsname=self.obsname, obsfreq=self.obsFreq,
            segLength=self.segLength, ncoeff=self.ncoeff, f0=self.f0,
            tmid=self._tmid.copy(), rphase_int=self._rint.copy(),
            rphase_frac=self._rfrac.copy(),
            coeffs=self._coeffs.copy(), fit_rms=self._rms.copy())

    def to_polycos(self) -> Polycos:
        return self.to_predictor_set().to_polycos()


def _ntoas(toas) -> int:
    return int(toas.ntoas) if hasattr(toas, "ntoas") else len(toas)
