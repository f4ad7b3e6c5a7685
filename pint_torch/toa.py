"""The device-side TOA batch (port of ``pint_tpu/toa.py:120-149``, with
the wideband DM data of ``:520-545``, the photons' ``-weight`` flag, the
validate/quarantine gate of ``:314-391`` and ``merge_TOAs`` of ``:1292``).

Positions are in light-seconds and velocities in ls/s; ``tdb`` is the
double-double TDB MJD and ``tdb_s`` the seconds since ``tdb0`` (an integer
MJD near the data midpoint) as an exact host-built pair.  Host ingest
(par/tim parsing, clocks, TDB, ephemeris) is not part of this package yet:
batches come from a snapshot of the reference package's state
(:mod:`pint_torch.bridge`).

A subset (:meth:`TOABatch.select`) or a merge (:func:`merge_TOAs`) carries
each component's per-TOA context sliced or joined along the TOA axis
where that context is row-local, and re-derives ``tdb0`` and ``tdb_s`` as
the reference's ``to_batch`` does for its own subset.  The quarantine mask
of :meth:`TOABatch.validate` rides beside the batch in a holder that no
evaluation reads: a batch that keys a cache is never changed by it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch.dd import DD, two_prod, two_sum
from pint_torch.exceptions import TOAIntegrityError

__all__ = ["TOABatch", "merge_TOAs", "ROW_LOCAL_CONTEXTS",
           "TOAIntegrityError"]

DAY_S = 86400.0

#: the components whose per-TOA context a subset or merge slices or joins
#: along the TOA axis: DMX window membership and the JUMP and EFAC/EQUAD
#: mask selections (the noise masks are host numpy); the red-noise basis
#: needs no context once ``TNREDTSPAN`` pins its period
ROW_LOCAL_CONTEXTS = ("DispersionDMX", "PhaseJump", "DelayJump",
                      "ScaleToaError")

#: components that read nothing per TOA from their context beyond the
#: model's own (the TZR row): a subset leaves them out
_NOT_PER_TOA = ("AbsPhase",)


class _Quarantine:
    """The mutable validation state beside a frozen batch."""

    __slots__ = ("mask", "reasons", "last_validation", "applied_n")

    def __init__(self):
        self.mask = None
        self.reasons = None
        self.last_validation = None
        self.applied_n = None


def _set_dependent(model) -> Dict[str, str]:
    """The model's contexts that depend on the whole TOA set, by component:
    ECORR epochs and a Fourier basis whose period is the data span (no
    ``TN*TSPAN``)."""
    out = {}
    for name, comp in model.components.items():
        if getattr(comp, "is_ecorr", False):
            out[name] = "ECORR epochs"
        elif hasattr(comp, "get_time_frequencies") \
                and comp.config.get("tspan_s") is None:
            out[name] = "a basis over the data span"
    return out


def _slice_ctx(obj, keep, n):
    """A context's leaves sliced along their last (TOA) axis."""
    if isinstance(obj, dict):
        return {k: _slice_ctx(v, keep, n) for k, v in obj.items()}
    if obj.shape[-1] != n:
        raise NotImplementedError(
            f"a context of shape {tuple(obj.shape)} is not per TOA of {n}")
    if torch.is_tensor(obj):
        return obj[..., torch.as_tensor(np.flatnonzero(keep),
                                        device=obj.device)]
    return obj[..., keep]


def _join_ctx(parts):
    first = parts[0]
    if isinstance(first, dict):
        if any(not isinstance(p, dict) or p.keys() != first.keys()
               for p in parts):
            raise ValueError("merge_TOAs: the batches' contexts differ in "
                             "structure")
        return {k: _join_ctx([p[k] for p in parts]) for k in first}
    if torch.is_tensor(first):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def _rebased(tdb: DD):
    """(tdb0, tdb_s) as the reference's ``to_batch`` makes them: tdb0 the
    rounded mean of the float64 MJDs, tdb_s the exact seconds since it."""
    hi = tdb.hi.detach().cpu().numpy()
    lo = tdb.lo.detach().cpu().numpy()
    tdb0 = float(np.round(np.mean(hi))) if hi.size else 0.0
    s_hi, s_err = two_prod(hi - tdb0, DAY_S)
    s_hi, s_err2 = two_sum(s_hi, s_err + lo * DAY_S)
    dev = tdb.hi.device
    return tdb0, DD(torch.as_tensor(s_hi, dtype=F64, device=dev),
                    torch.as_tensor(s_err2, dtype=F64, device=dev))


@dataclass(frozen=True, eq=False)  # identity hash: batches key caches
class TOABatch:
    """Frozen TOA data as float64 tensors on one device."""

    tdb: DD                   # (N,) MJD, double-double
    tdb0: float               # reference MJD (integer-valued)
    tdb_s: DD                 # (N,) seconds since tdb0, exact pair
    freq: torch.Tensor        # (N,) MHz
    error_us: torch.Tensor    # (N,) microseconds
    ssb_obs_pos: torch.Tensor  # (N, 3) light-seconds
    ssb_obs_vel: torch.Tensor  # (N, 3) ls/s
    obs_sun_pos: torch.Tensor  # (N, 3) light-seconds
    planet_pos: Dict[str, torch.Tensor] = field(default_factory=dict)
    #: (N,) MJDs as float64 (the reference's ``toas.get_mjds()``), which the
    #: DMX masks and noise bases read on the host
    mjds: Optional[np.ndarray] = None
    #: the one-row batch of an absolute phase's TZR TOA
    tzr: bool = False
    #: (N,) wideband DM measurements and their uncertainties [pc/cm^3]
    #: (the reference's ``-pp_dm``/``-pp_dme`` flags), or None
    dm: Optional[torch.Tensor] = None
    dm_error: Optional[torch.Tensor] = None
    #: each component's context for these TOAs, by component name, where
    #: they are not the model's own TOAs (the TZR row); None: the
    #: components' own contexts apply
    contexts: Optional[dict] = None
    #: the solar-system ephemeris the TOAs were made with (the
    #: reference's ``toas.ephem``), or None
    ephem: Optional[str] = None
    #: (N,) photon weights (the reference's ``-weight`` flag, which the
    #: photon fitters read), or None
    weights: Optional[torch.Tensor] = None
    #: (N,) the sub-double part of each UTC MJD and each TOA's observatory
    #: (host numpy), which the duplicate check keys on, or None
    mjd_lo: Optional[np.ndarray] = None
    obs: Optional[np.ndarray] = None
    #: what the coverage checks read from the reference's host ingest:
    #: ``{"clock_end": {site: last corrected MJD or None}, "ephem_span":
    #: [lo, hi] or None}``, or None
    coverage: Optional[dict] = None
    _q: _Quarantine = field(default_factory=_Quarantine, init=False,
                            repr=False, compare=False)
    #: the reference's edit counter of its TOA set (``TOAs._version``, a
    #: vkey element of the tuning manifest's model-bound decisions): what
    #: the batch was made with, raised by :meth:`validate` as the
    #: reference's is
    _version: int = field(default=0, repr=False, compare=False)

    @property
    def ntoas(self) -> int:
        return self.freq.shape[0]

    @property
    def device(self) -> torch.device:
        return self.freq.device

    @property
    def wideband(self) -> bool:
        """Every TOA carries a wideband DM measurement."""
        return self.ntoas > 0 and self.dm is not None

    def tdb_seconds(self) -> DD:
        return self.tdb_s

    def to(self, device) -> "TOABatch":
        """A copy of the batch on ``device``."""
        return self._map(lambda x: x.to(device=device, dtype=F64),
                         lambda v: v.to(device) if torch.is_tensor(v) else v)

    def select(self, mask, model=None,
               standalone: bool = False) -> "TOABatch":
        """The batch of the TOAs where ``mask`` (N,) is true (the
        reference's ``toas[mask]``): every per-TOA tensor and host array
        sliced, each row-local context (:data:`ROW_LOCAL_CONTEXTS`) sliced
        along the TOA axis, ``tdb0``/``tdb_s`` re-derived as the
        reference's ``to_batch`` does, the quarantine mask carried.  A
        batch without contexts of its own takes ``model``'s (which it
        then needs); one that carries them (a subset or a merge) slices
        its own.  Contexts
        that depend on the whole set (ECORR epochs, a basis without
        ``TNREDTSPAN``) or that no rule slices are refused with
        ``NotImplementedError`` (ROADMAP queue A item 10) -- unless
        ``standalone``: the subset is then a TOA set of its own, evaluated
        by itself as the reference's ``toas[mask]`` handed to a fresh
        fitter is, so its ECORR epochs and data span are its own (the
        noise components derive both from the batch they are given) and
        those components' per-TOA masks slice along the TOA axis."""
        keep = np.asarray(mask, dtype=bool)
        if keep.shape != (self.ntoas,):
            raise ValueError(f"select: mask of shape {keep.shape} for "
                             f"{self.ntoas} TOAs")
        if self.contexts is not None:
            src = self.contexts
        elif model is None:
            raise ValueError("select: a batch without contexts of its own "
                             "takes its model's; pass the model")
        else:
            src = {n: c.context for n, c in model.components.items()
                   if c.context and n not in _NOT_PER_TOA}
        dep = {} if model is None else _set_dependent(model)
        if dep and not standalone:
            raise NotImplementedError(
                f"selecting TOAs whose contexts depend on the whole set "
                f"({', '.join(f'{n} ({r})' for n, r in dep.items())}) is "
                "ROADMAP queue A item 10")
        other = [n for n in src if n not in ROW_LOCAL_CONTEXTS
                 and not (standalone and n in dep)]
        if other:
            raise NotImplementedError(
                f"selecting TOAs whose components hold per-TOA contexts no "
                f"rule slices ({other}) is ROADMAP queue A item 10")
        n = self.ntoas
        idx = torch.as_tensor(np.flatnonzero(keep), device=self.device)
        out = self._map(lambda x: x.index_select(0, idx), None,
                        lambda a: a[keep])
        out = replace(out, contexts={k: _slice_ctx(v, keep, n)
                                     for k, v in src.items()})
        tdb0, tdb_s = _rebased(out.tdb)
        out = replace(out, tdb0=tdb0, tdb_s=tdb_s)
        q = self._q
        if q.mask is not None:
            out._q.mask = np.asarray(q.mask, dtype=bool)[keep]
            out._q.reasons = [list(q.reasons[i])
                              for i in np.flatnonzero(keep)]
        return out

    # -- validation and quarantine (reference ``toa.py:314-391``) ---------
    @property
    def quarantine_mask(self) -> Optional[np.ndarray]:
        return self._q.mask

    @property
    def quarantine_reasons(self) -> Optional[list]:
        return self._q.reasons

    def set_quarantine(self, mask, reasons=None) -> None:
        """Replace the quarantine mask (None: every row certified)."""
        self._q.mask = None if mask is None else np.asarray(mask, bool)
        self._q.reasons = None if mask is None else reasons

    @property
    def last_validation(self):
        """The report of the last :meth:`validate`, or None."""
        return self._q.last_validation

    def validate(self, policy: Optional[str] = None,
                 check_coverage: bool = True,
                 max_error_us: Optional[float] = None):
        """Run the TOA checks (:mod:`pint_torch.integrity.quarantine`).
        ``policy`` defaults to :func:`pint_torch.config.ingestion_policy`
        (``strict`` unless configured).  ``strict`` raises
        :class:`TOAIntegrityError` when anything is found; ``lenient``
        quarantines with a warning;
        ``collect`` quarantines silently.  The report carries the
        changed-row delta against the previously applied mask and rides
        on :attr:`last_validation`."""
        import warnings

        from pint_torch.config import ingestion_policy
        from pint_torch.integrity.quarantine import (ABSURD_ERROR_US,
                                                     row_delta,
                                                     run_toa_checks)

        policy = policy or ingestion_policy()
        if policy not in ("strict", "lenient", "collect"):
            raise ValueError(f"unknown ingestion policy {policy!r}")
        report = run_toa_checks(
            self, check_coverage=check_coverage,
            max_error_us=ABSURD_ERROR_US if max_error_us is None
            else max_error_us)
        q = self._q
        prev = q.mask
        if prev is None and q.applied_n is not None:
            prev = np.zeros(min(q.applied_n, self.ntoas), dtype=bool)
        report.delta = row_delta(prev, report.mask)
        q.last_validation = report
        if report and policy == "strict":
            raise TOAIntegrityError(
                "TOA validation failed under the strict ingestion policy:\n"
                f"{report.render()}", report=report)
        q.mask = report.mask if report else None
        q.reasons = report.reasons_by_row() if report else None
        q.applied_n = self.ntoas
        object.__setattr__(self, "_version", self._version + 1)
        if report and policy == "lenient":
            warnings.warn(report.render())
        return report

    @property
    def n_quarantined(self) -> int:
        m = self._q.mask
        return int(np.sum(m)) if m is not None else 0

    def certified(self, model=None, standalone: bool = False) -> "TOABatch":
        """The rows :meth:`validate` did not quarantine (``self`` when
        there are none); ``standalone`` as :meth:`select`'s."""
        m = self._q.mask
        if m is None or not np.any(m):
            return self
        return self.select(~np.asarray(m, dtype=bool), model,
                           standalone=standalone)

    def quarantined(self, model=None) -> "TOABatch":
        """The quarantined rows (for inspection and repair)."""
        m = self._q.mask
        if m is None:
            m = np.zeros(self.ntoas, dtype=bool)
        return self.select(np.asarray(m, dtype=bool), model)

    def _map(self, mv, ctx, host=None) -> "TOABatch":
        """A copy with ``mv`` applied to every per-TOA tensor, ``ctx`` to
        each context value (None: no contexts) and ``host`` to each per-TOA
        host array (None: kept)."""
        h = (lambda a: a) if host is None else \
            (lambda a: None if a is None else host(a))
        return TOABatch(
            tdb=DD(mv(self.tdb.hi), mv(self.tdb.lo)), tdb0=self.tdb0,
            tdb_s=DD(mv(self.tdb_s.hi), mv(self.tdb_s.lo)),
            freq=mv(self.freq), error_us=mv(self.error_us),
            ssb_obs_pos=mv(self.ssb_obs_pos), ssb_obs_vel=mv(self.ssb_obs_vel),
            obs_sun_pos=mv(self.obs_sun_pos),
            planet_pos={k: mv(v) for k, v in self.planet_pos.items()},
            mjds=h(self.mjds), tzr=self.tzr, ephem=self.ephem,
            mjd_lo=h(self.mjd_lo), obs=h(self.obs), coverage=self.coverage,
            dm=None if self.dm is None else mv(self.dm),
            dm_error=None if self.dm_error is None else mv(self.dm_error),
            weights=None if self.weights is None else mv(self.weights),
            contexts=None if self.contexts is None or ctx is None
            else {n: {k: ctx(v) for k, v in c.items()}
                  for n, c in self.contexts.items()})

    @classmethod
    def from_numpy(cls, arrays: dict, device, **kw) -> "TOABatch":
        """Build on ``device`` from host arrays keyed like the snapshot
        (``tdb_hi``, ``tdb_lo``, ``tdb0``, ``tdb_s_hi``, ``tdb_s_lo``,
        ``freq``, ``error_us``, ``ssb_obs_pos``, ``ssb_obs_vel``,
        ``obs_sun_pos``, ``planet_pos/<name>``, ``mjds``, for wideband
        TOAs ``dm`` and ``dm_error``, for weighted photons ``weight``, and
        where present ``mjd_lo`` and ``obs``); ``kw`` sets ``tzr``,
        ``contexts``, ``ephem`` and ``coverage``."""
        def t(name):
            return torch.tensor(np.asarray(arrays[name], dtype=np.float64),
                                dtype=F64, device=device)

        planets = {k.split("/", 1)[1]: t(k) for k in arrays
                   if k.startswith("planet_pos/")}
        return cls(tdb=DD(t("tdb_hi"), t("tdb_lo")),
                   tdb0=float(arrays["tdb0"]),
                   tdb_s=DD(t("tdb_s_hi"), t("tdb_s_lo")),
                   freq=t("freq"), error_us=t("error_us"),
                   ssb_obs_pos=t("ssb_obs_pos"), ssb_obs_vel=t("ssb_obs_vel"),
                   obs_sun_pos=t("obs_sun_pos"), planet_pos=planets,
                   mjds=np.asarray(arrays["mjds"], dtype=np.float64),
                   dm=t("dm") if "dm" in arrays else None,
                   dm_error=t("dm_error") if "dm_error" in arrays else None,
                   weights=t("weight") if "weight" in arrays else None,
                   mjd_lo=np.asarray(arrays["mjd_lo"], dtype=np.float64)
                   if "mjd_lo" in arrays else None,
                   obs=np.asarray(arrays["obs"]).astype(str)
                   if "obs" in arrays else None,
                   **kw)


def merge_TOAs(batches) -> TOABatch:
    """One batch of ``batches`` in order (the reference's ``merge_TOAs``,
    ``toa.py:1292``), all drawn from one snapshot: per-TOA tensors and host
    arrays joined, each component's context joined along the TOA axis
    (every batch carries its own, or none does), ``tdb0``/``tdb_s``
    re-derived as the reference's ``to_batch`` does, the quarantine masks
    joined (a batch without one contributes certified rows)."""
    batches = list(batches)
    if not batches:
        raise ValueError("merge_TOAs needs at least one batch")
    first = batches[0]
    has_ctx = [b.contexts is not None for b in batches]
    if any(has_ctx) and not all(has_ctx):
        raise ValueError("merge_TOAs: some batches carry their own "
                         "contexts and some do not; select each from its "
                         "model first")
    if any(b.device != first.device for b in batches):
        raise ValueError("merge_TOAs: batches on different devices")

    def cat(get):
        vals = [get(b) for b in batches]
        if any(v is None for v in vals):
            return None
        if torch.is_tensor(vals[0]):
            return torch.cat(vals, dim=0)
        return np.concatenate(vals)

    tdb = DD(cat(lambda b: b.tdb.hi), cat(lambda b: b.tdb.lo))
    tdb0, tdb_s = _rebased(tdb)
    planets = {k: cat(lambda b, k=k: b.planet_pos[k])
               for k in first.planet_pos
               if all(k in b.planet_pos for b in batches)}
    out = TOABatch(
        tdb=tdb, tdb0=tdb0, tdb_s=tdb_s, freq=cat(lambda b: b.freq),
        error_us=cat(lambda b: b.error_us),
        ssb_obs_pos=cat(lambda b: b.ssb_obs_pos),
        ssb_obs_vel=cat(lambda b: b.ssb_obs_vel),
        obs_sun_pos=cat(lambda b: b.obs_sun_pos), planet_pos=planets,
        mjds=cat(lambda b: b.mjds), tzr=False,
        dm=cat(lambda b: b.dm), dm_error=cat(lambda b: b.dm_error),
        contexts=_join_ctx([b.contexts for b in batches])
        if all(has_ctx) else None,
        ephem=first.ephem, weights=cat(lambda b: b.weights),
        mjd_lo=cat(lambda b: b.mjd_lo), obs=cat(lambda b: b.obs),
        coverage=first.coverage)
    if any(b.quarantine_mask is not None for b in batches):
        out._q.mask = np.concatenate([
            b.quarantine_mask if b.quarantine_mask is not None
            else np.zeros(b.ntoas, dtype=bool) for b in batches])
        out._q.reasons = [list(r) for b in batches for r in (
            b.quarantine_reasons if b.quarantine_reasons is not None
            else [[] for _ in range(b.ntoas)])]
    return out
