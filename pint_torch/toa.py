"""The TOA tables: the host table :class:`TOAs` and the device batch
:class:`TOABatch`.

:class:`TOAs` (port of ``pint_tpu/toa.py:53-1365``) is the host table,
read from tim files (:func:`get_TOAs`, whose MJD digits go through the C++
parser of :mod:`pint_torch.native`) or built from arrays
(:func:`get_TOAs_array`, :func:`make_single_toa`, :func:`get_TOAs_list`):
longdouble UTC MJDs, flags, the integrity gate (:meth:`TOAs.validate`),
the one-time pipeline ``apply_clock_corrections -> compute_TDBs ->
compute_posvels`` (both the longdouble and the (hi, lo) pair branch of the
TDBs), the tim writer, the hash-keyed pickles, and :meth:`TOAs.to_batch`,
which freezes it into a batch on the device with each component's context
for these TOAs when a model is given.

:class:`TOABatch` (port of ``pint_tpu/toa.py:120-149``, with the wideband
DM data of ``:520-545``, the photons' ``-weight`` flag, the
validate/quarantine gate of ``:314-391`` and ``merge_TOAs`` of ``:1292``)
keeps positions in light-seconds and velocities in ls/s; ``tdb`` is the
double-double TDB MJD and ``tdb_s`` the seconds since ``tdb0`` (an integer
MJD near the data midpoint) as an exact host-built pair.  Batches come
from the host table or from a snapshot of the reference package's state
(:mod:`pint_torch.bridge`).

A subset (:meth:`TOABatch.select`) or a merge (:func:`merge_TOAs`) carries
each component's per-TOA context sliced or joined along the TOA axis
where that context is row-local, and re-derives ``tdb0`` and ``tdb_s`` as
the reference's ``to_batch`` does for its own subset.  The quarantine mask
of :meth:`TOABatch.validate` rides beside the batch in a holder that no
evaluation reads: a batch that keys a cache is never changed by it.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import re
from collections.abc import MutableMapping
from dataclasses import dataclass, field, replace
from fractions import Fraction
from typing import Dict, List, Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch import c as C_M_S
from pint_torch.dd import DD, two_prod, two_sum, two_sum_np
from pint_torch.exceptions import (InvalidTOAError, PintPickleError,
                                   TimSyntaxError, TOAIntegrityError,
                                   UsageError)
from pint_torch.io.tim import RawTOA, format_toa_line, read_tim_file

__all__ = ["TOABatch", "TOAs", "TOA", "FlagDict", "merge_TOAs", "get_TOAs",
           "get_TOAs_list", "get_TOAs_array", "build_table",
           "make_single_toa", "select_toa_mask", "read_toa_file",
           "load_pickle", "save_pickle", "parse_decimal_strings",
           "ROW_LOCAL_CONTEXTS", "TOAIntegrityError"]

DAY_S = 86400.0
C_KM_S = C_M_S / 1e3

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
    #: (N,) the TOAs' pulse numbers and the added pulses (the reference's
    #: ``pulse_number`` / ``delta_pulse_number`` columns; ``-pn`` flags
    #: where every TOA carries one), float64 on the device, or None
    pulse_number: Optional[torch.Tensor] = None
    delta_pulse_number: Optional[torch.Tensor] = None
    #: the host :class:`TOAs` the batch was frozen from (a subset's
    #: rows), which the contexts of an edited model and the doctor's
    #: flag checks read; None for a batch made from a snapshot
    host: Optional["TOAs"] = field(default=None, repr=False, compare=False)
    #: what each component's context was built for: {component name: its
    #: signature (:meth:`TimingModel._context_signatures`), None where
    #: unknown}, or None (a snapshot's contexts)
    _ctx_sig: Optional[dict] = field(default=None, repr=False,
                                     compare=False)
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

    def select(self, mask, model=None) -> "TOABatch":
        """The batch of the TOAs where ``mask`` (N,) is true (the
        reference's ``toas[mask]``): every per-TOA tensor and host array
        sliced, ``tdb0``/``tdb_s`` re-derived as the reference's
        ``to_batch`` does, the pulse-number columns and the quarantine
        mask carried.  The subset is a TOA set of its own, as the
        reference's ``toas[mask]`` is.  Its contexts are the batch's own
        (or, for a batch without them, ``model``'s components'), each
        row-local one (:data:`ROW_LOCAL_CONTEXTS`) sliced along the TOA
        axis, with what each was built for; the contexts that depend on
        the whole set (ECORR epochs, a basis over the data span without
        ``TN*TSPAN``) are the noise components' masks sliced, from which
        they derive them for the subset; any other comes from ``model``'s
        context of the host subset (:meth:`TimingModel.host_contexts`),
        which only a batch frozen from host TOAs has."""
        keep = np.asarray(mask, dtype=bool)
        if keep.shape != (self.ntoas,):
            raise ValueError(f"select: mask of shape {keep.shape} for "
                             f"{self.ntoas} TOAs")
        host = None if self.host is None else self.host[keep]
        if self.contexts is not None:
            src, sig = self.contexts, self._ctx_sig
        elif model is None:
            raise ValueError("select: a batch without contexts of its "
                             "own takes its model's; pass the model")
        else:
            src = {n: c.context for n, c in model.components.items()
                   if c.context and n not in _NOT_PER_TOA}
            sig = {n: c.__dict__.get("_ctx_for")
                   for n, c in model.components.items()}
        dep = {} if model is None else _set_dependent(model)
        other = [n for n, v in src.items() if v and n not in dep
                 and n not in ROW_LOCAL_CONTEXTS]
        if other and (host is None or model is None):
            raise NotImplementedError(
                f"selecting TOAs whose components hold per-TOA contexts "
                f"no rule slices ({other}) needs the batch's host TOAs "
                "(TOAs.to_batch) and the model")
        contexts = {k: _slice_ctx(v, keep, self.ntoas)
                    for k, v in src.items() if k not in other}
        if other:
            fresh = model.host_contexts(host, device=self.device)
            contexts.update((n, fresh[n]) for n in other)
            sig = dict(sig or {})
            sig.update((n, model._component_signature(n)) for n in other)
        idx = torch.as_tensor(np.flatnonzero(keep), device=self.device)
        out = self._map(lambda x: x.index_select(0, idx), None,
                        lambda a: a[keep])
        out = replace(out, contexts=contexts, host=host, _ctx_sig=sig)
        tdb0, tdb_s = _rebased(out.tdb)
        out = replace(out, tdb0=tdb0, tdb_s=tdb_s)
        q = self._q
        if q.mask is not None:
            out._q.mask = np.asarray(q.mask, dtype=bool)[keep]
            out._q.reasons = [list(q.reasons[i])
                              for i in np.flatnonzero(keep)]
        return out

    # -- pulse numbers (reference ``toa.py:548-562,811-839``) --------------
    def get_pulse_numbers(self) -> Optional[torch.Tensor]:
        """The pulse numbers (float64 on the device), or None."""
        return self.pulse_number

    def compute_pulse_numbers(self, model) -> torch.Tensor:
        """Each TOA's nearest integer pulse number under ``model``: the
        absolute phase's integer part plus its rounded fraction (reference
        ``toa.py:557``), kept as this batch's column (the host TOAs it was
        frozen from keep theirs)."""
        ph = model.phase(self, abs_phase=True)
        pn = ph.int_ + torch.round(ph.frac)
        object.__setattr__(self, "pulse_number", pn)
        return pn

    def remove_pulse_numbers(self) -> None:
        """Drop both pulse-number columns."""
        object.__setattr__(self, "pulse_number", None)
        object.__setattr__(self, "delta_pulse_number", None)

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

    def certified(self, model=None) -> "TOABatch":
        """The rows :meth:`validate` did not quarantine (``self`` when
        there are none)."""
        m = self._q.mask
        if m is None or not np.any(m):
            return self
        return self.select(~np.asarray(m, dtype=bool), model)

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
            pulse_number=None if self.pulse_number is None
            else mv(self.pulse_number),
            delta_pulse_number=None if self.delta_pulse_number is None
            else mv(self.delta_pulse_number), host=self.host,
            _ctx_sig=self._ctx_sig,
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


def merge_TOAs(toas_list):
    """Concatenate TOAs in order (reference ``toa.py:1292``): host
    :class:`TOAs` into host TOAs (:func:`_merge_host`), device batches
    into one batch (:func:`_merge_batches`)."""
    toas_list = list(toas_list)
    if toas_list and all(isinstance(t, TOAs) for t in toas_list):
        return _merge_host(toas_list)
    return _merge_batches(toas_list)


def _merge_batches(batches) -> TOABatch:
    """One batch of ``batches`` in order, all drawn from one snapshot or
    one model's host TOAs: per-TOA tensors and host
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
    if any(b._ctx_sig != first._ctx_sig for b in batches):
        raise ValueError("merge_TOAs: the batches' contexts were built for "
                         "different model structures")

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
        coverage=first.coverage, pulse_number=cat(lambda b: b.pulse_number),
        delta_pulse_number=cat(lambda b: b.delta_pulse_number),
        host=_merge_host([b.host for b in batches])
        if all(b.host is not None for b in batches) else None,
        _ctx_sig=first._ctx_sig)
    if any(b.quarantine_mask is not None for b in batches):
        out._q.mask = np.concatenate([
            b.quarantine_mask if b.quarantine_mask is not None
            else np.zeros(b.ntoas, dtype=bool) for b in batches])
        out._q.reasons = [list(r) for b in batches for r in (
            b.quarantine_reasons if b.quarantine_reasons is not None
            else [[] for _ in range(b.ntoas)])]
    return out


# ---------------------------------------------------------------------------
# the host table (reference ``pint_tpu/toa.py:153-240,401-494,799-841``)
# ---------------------------------------------------------------------------
def _observatory(name):
    from pint_torch.observatory import get_observatory

    return get_observatory(name)


@dataclass(eq=False)  # identity: each table holds its own batches
class TOAs:
    """Host TOA table: numpy arrays (longdouble UTC MJDs, flags,
    observatory names) and the pipeline's products."""

    utc_mjd: np.ndarray        # (N,) longdouble site-arrival MJDs (UTC)
    error_us: np.ndarray       # (N,) float64
    freq_mhz: np.ndarray       # (N,) float64 (inf: infinite frequency)
    obs: np.ndarray            # (N,) object str, canonical site names
    flags: List[Dict[str, str]]
    commands: List = field(default_factory=list)
    filename: Optional[str] = None

    # pipeline products
    clock_corr_s: Optional[np.ndarray] = None
    tdb: Optional[np.ndarray] = None  # longdouble MJD
    #: the sub-double part of utc_mjd / tdb where longdouble is only a
    #: double (the pair branch); None where longdouble carries it
    utc_mjd_lo: Optional[np.ndarray] = None
    tdb_lo: Optional[np.ndarray] = None
    ssb_obs_pos_km: Optional[np.ndarray] = None
    ssb_obs_vel_kms: Optional[np.ndarray] = None
    obs_sun_pos_km: Optional[np.ndarray] = None
    planet_pos_km: Dict[str, np.ndarray] = field(default_factory=dict)
    ephem: Optional[str] = None
    include_bipm: bool = True
    include_gps: bool = True
    bipm_version: str = "BIPM2021"
    planets: bool = False
    #: (N,) float64 pulse numbers (NaN where a TOA has none) and added
    #: pulses, or None (reference ``toa.py:181-182``)
    pulse_number: Optional[np.ndarray] = None
    delta_pulse_number: Optional[np.ndarray] = None
    #: the quarantine of :meth:`validate` (True: quarantined) and each
    #: row's reasons; carried through slicing, merging and pickling
    quarantine_mask: Optional[np.ndarray] = None
    quarantine_reasons: Optional[List[List[str]]] = None
    #: bumped on every in-place change; the models' batches of the table
    #: (:meth:`TimingModel.batch_of`) key on it
    _version: int = 0

    def __len__(self) -> int:
        return len(self.utc_mjd)

    @classmethod
    def from_raw(cls, raw, commands=None, filename=None) -> "TOAs":
        """The table of a tim file's raw TOAs (reference ``toa.py:183``)."""
        n = len(raw)
        err = np.empty(n, dtype=np.float64)
        freq = np.empty(n, dtype=np.float64)
        obs = np.empty(n, dtype=object)
        flags = []
        for i, t in enumerate(raw):
            err[i] = t.error_us
            freq[i] = t.freq_mhz if t.freq_mhz > 0 else np.inf
            obs[i] = _observatory(t.obs).name
            fl = dict(t.flags)
            if t.name:
                fl.setdefault("name", t.name)
            flags.append(fl)
        utc, utc_lo = cls._mjds_from_raw(raw)
        t = cls(utc, err, freq, obs, flags, commands or [], filename)
        t.utc_mjd_lo = utc_lo
        return t

    @staticmethod
    def _mjds_from_raw(raw):
        """MJD strings -> (longdouble, optional float64 low word), the
        decimal digits read by :func:`parse_decimal_strings` (the C++
        parser; the pure-Python path without a compiler).  Where
        longdouble is extended, the fraction's (hi, lo) pair is rounded
        once to longdouble and added to the integer day, which is the
        reference's ``longdouble(day) + longdouble("0." + digits)``;
        where longdouble is only a double, the whole MJD's pair is kept
        as (hi, lo) (reference ``toa.py:202-230``)."""
        extended = np.finfo(np.longdouble).eps < 2e-19
        strings = [("0." if extended else f"{t.mjd_int}.") + t.mjd_frac_str
                   for t in raw]
        hi, lo = parse_decimal_strings(strings)
        if extended:
            day = np.array([t.mjd_int for t in raw], dtype=np.longdouble)
            return day + (hi.astype(np.longdouble)
                          + lo.astype(np.longdouble)), None
        return hi.astype(np.longdouble), lo

    def __getstate__(self):
        """The table without its models' device batches (``_batches``,
        :meth:`TimingModel.batch_of`): a pickle or a copy makes its own."""
        return {k: v for k, v in self.__dict__.items() if k != "_batches"}

    def __setstate__(self, state):
        """Pickles written before a field was added load with its
        default."""
        self.__dict__.update(state)
        from dataclasses import MISSING, fields

        for f_ in fields(type(self)):
            if f_.name not in self.__dict__:
                if f_.default is not MISSING:
                    self.__dict__[f_.name] = f_.default
                elif f_.default_factory is not MISSING:
                    self.__dict__[f_.name] = f_.default_factory()

    def __getitem__(self, index) -> "TOAs":
        idx = np.atleast_1d(np.arange(len(self))[index])
        new = replace(self, utc_mjd=self.utc_mjd[idx],
                      error_us=self.error_us[idx],
                      freq_mhz=self.freq_mhz[idx], obs=self.obs[idx],
                      flags=[dict(self.flags[i]) for i in idx])
        for name in ("clock_corr_s", "tdb", "utc_mjd_lo", "tdb_lo",
                     "ssb_obs_pos_km", "ssb_obs_vel_kms", "obs_sun_pos_km",
                     "pulse_number", "delta_pulse_number",
                     "quarantine_mask"):
            v = getattr(self, name)
            if v is not None:
                setattr(new, name, v[idx])
        if self.quarantine_reasons is not None:
            new.quarantine_reasons = [list(self.quarantine_reasons[i])
                                      for i in idx]
        new.planet_pos_km = {k: v[idx] for k, v in self.planet_pos_km.items()}
        return new

    # -- integrity: validation and quarantine (reference ``toa.py:314-394``)
    def validate(self, policy: Optional[str] = None,
                 check_coverage: bool = True,
                 max_error_us: Optional[float] = None,
                 ephem: Optional[str] = None):
        """The TOA integrity checks (:mod:`pint_torch.integrity.quarantine`)
        under the ingestion policy: ``strict`` raises
        :class:`TOAIntegrityError` where anything is found, ``lenient``
        quarantines with a logged summary, ``collect`` quarantines
        silently.  Returns the report (also ``self.last_validation``)."""
        from pint_torch.config import ingestion_policy
        from pint_torch.integrity.quarantine import (ABSURD_ERROR_US,
                                                     row_delta,
                                                     run_toa_checks)
        from pint_torch.logging import log

        policy = policy or ingestion_policy()
        report = run_toa_checks(
            self, check_coverage=check_coverage,
            max_error_us=ABSURD_ERROR_US if max_error_us is None
            else max_error_us, ephem=ephem)
        prev = self.quarantine_mask
        applied_n = getattr(self, "_applied_validation_n", None)
        if prev is None and applied_n is not None:
            prev = np.zeros(min(applied_n, len(self)), dtype=bool)
        report.delta = row_delta(prev, report.mask)
        self.last_validation = report
        if report and policy == "strict":
            raise TOAIntegrityError(
                f"TOA validation failed under the strict ingestion "
                f"policy:\n{report.render()}", report=report)
        self.quarantine_mask = report.mask if report else None
        self.quarantine_reasons = report.reasons_by_row() if report else None
        self._applied_validation_n = len(self)
        self._version += 1
        if report and policy == "lenient":
            log.warning(report.render())
        return report

    @property
    def n_quarantined(self) -> int:
        m = self.quarantine_mask
        return int(np.sum(m)) if m is not None else 0

    def certified(self) -> "TOAs":
        """The rows :meth:`validate` did not quarantine (``self`` where
        none was)."""
        m = self.quarantine_mask
        if m is None or not np.any(m):
            return self
        return self[~np.asarray(m, dtype=bool)]

    def quarantined(self) -> "TOAs":
        m = self.quarantine_mask
        if m is None:
            return self[np.zeros(len(self), dtype=bool)]
        return self[np.asarray(m, dtype=bool)]

    @property
    def ntoas(self) -> int:
        return len(self)

    # -- the pipeline --------------------------------------------------------
    def apply_clock_corrections(self, include_gps=True, include_bipm=True,
                                bipm_version="BIPM2021", limits="warn"):
        """Site clock chain, GPS, BIPM and the tim ``-to`` offsets."""
        self.include_gps, self.include_bipm = include_gps, include_bipm
        self.bipm_version = bipm_version
        corr = np.zeros(len(self), dtype=np.float64)
        for i, fl in enumerate(self.flags):
            if "to" in fl:
                corr[i] += float(fl["to"])
        utc64 = np.asarray(self.utc_mjd, dtype=np.float64)
        for site in np.unique(self.obs):
            m = self.obs == site
            corr[m] += _observatory(site).clock_corrections(
                utc64[m], include_gps=include_gps, include_bipm=include_bipm,
                bipm_version=bipm_version, limits=limits)
        self.clock_corr_s = corr
        self._version += 1
        return self

    def corrected_utc_mjd(self) -> np.ndarray:
        cc = self.clock_corr_s if self.clock_corr_s is not None else 0.0
        return self.utc_mjd + np.asarray(cc, dtype=np.longdouble) \
            / np.longdouble(DAY_S)

    def compute_TDBs(self, method="default", ephem=None):
        """Corrected UTC -> TDB: a longdouble MJD, or, where the UTC MJDs
        carry a low word, an exact (hi, lo) pair built with error-free
        sums so that no rounding of the absolute MJD lands in hi."""
        if self.utc_mjd_lo is not None:
            utc64 = np.asarray(self.utc_mjd, dtype=np.float64)
            cc = (self.clock_corr_s if self.clock_corr_s is not None
                  else np.zeros_like(utc64))
            corr64 = utc64 + cc / DAY_S  # argument precision only
            off = np.empty_like(utc64)
            for site in np.unique(self.obs):
                m = self.obs == site
                off[m] = _observatory(site).get_TDB_offset_seconds(
                    corr64[m], method=method, ephem=ephem)
            hi, err = two_sum(utc64, (cc + off) / DAY_S)
            hi, lo = two_sum(hi, err + self.utc_mjd_lo)
            self.tdb = np.asarray(hi, dtype=np.longdouble)
            self.tdb_lo = lo
        else:
            utc = self.corrected_utc_mjd()
            tdb = np.empty_like(utc)
            for site in np.unique(self.obs):
                m = self.obs == site
                tdb[m] = _observatory(site).get_TDBs(utc[m], method=method,
                                                     ephem=ephem)
            self.tdb = tdb
            self.tdb_lo = None
        self._version += 1
        return self

    def compute_posvels(self, ephem="DE440", planets=False):
        """The observatory's, the Sun's and (``planets``) the five planets'
        positions [km] and the observatory's velocity [km/s]."""
        from pint_torch.ephemeris import load_ephemeris

        if self.tdb is None:
            self.compute_TDBs(ephem=ephem or "DE440")
        self.ephem = ephem or "DE440"
        self.planets = planets
        eph = load_ephemeris(self.ephem)
        n = len(self)
        utc64 = np.asarray(self.corrected_utc_mjd(), dtype=np.float64)
        tdb64 = np.asarray(self.tdb, dtype=np.float64)
        pos = np.empty((n, 3))
        vel = np.empty((n, 3))
        for site in np.unique(self.obs):
            m = self.obs == site
            ob = _observatory(site)
            if getattr(ob, "needs_flags", False):
                # spacecraft: the GCRS position rides in per-TOA flags
                fl = [self.flags[i] for i in np.where(m)[0]]
                pv = ob.posvel_flags(utc64[m], tdb64[m], fl, ephem=self.ephem)
            else:
                pv = ob.posvel(utc64[m], tdb64[m], ephem=self.ephem)
            pos[m], vel[m] = pv.pos, pv.vel
        self.ssb_obs_pos_km, self.ssb_obs_vel_kms = pos, vel
        sun_pos, _ = eph.posvel_ssb("sun", tdb64)
        self.obs_sun_pos_km = sun_pos - pos
        self.planet_pos_km = {}
        if planets:
            for pl in ("jupiter", "saturn", "venus", "uranus", "neptune"):
                ppos, _ = eph.posvel_ssb(pl, tdb64)
                self.planet_pos_km[pl] = ppos - pos
        self._version += 1
        return self

    # -- accessors -----------------------------------------------------------
    def get_mjds(self, high_precision=False):
        return self.utc_mjd if high_precision \
            else np.asarray(self.utc_mjd, dtype=np.float64)

    def get_freqs(self) -> np.ndarray:
        return self.freq_mhz

    def get_obss(self) -> np.ndarray:
        return self.obs

    def get_errors(self) -> np.ndarray:
        return self.error_us

    def get_flag_value(self, flag: str, fill_value=None, as_type=None):
        """(per-TOA values of ``flag``, ``fill_value`` where absent; the
        indices that carry it)."""
        vals, valid = [], []
        for i, fl in enumerate(self.flags):
            if flag in fl:
                vals.append(as_type(fl[flag]) if as_type else fl[flag])
                valid.append(i)
            else:
                vals.append(fill_value)
        return vals, valid

    @property
    def wideband(self) -> bool:
        return len(self) > 0 and all("pp_dm" in fl for fl in self.flags)

    def is_wideband(self) -> bool:
        return self.wideband

    def get_dms(self) -> Optional[np.ndarray]:
        """Wideband DMs [pc/cm^3] from ``-pp_dm`` flags, or None."""
        vals, valid = self.get_flag_value("pp_dm", as_type=float)
        return np.asarray(vals, dtype=np.float64) \
            if len(valid) == len(self) else None

    def get_dm_errors(self) -> Optional[np.ndarray]:
        """Wideband DM uncertainties from ``-pp_dme`` flags, or None."""
        vals, valid = self.get_flag_value("pp_dme", as_type=float)
        return np.asarray(vals, dtype=np.float64) \
            if len(valid) == len(self) else None

    def update_dms(self, dms, errors=None) -> None:
        for i, fl in enumerate(self.flags):
            fl["pp_dm"] = repr(float(dms[i]))
            if errors is not None:
                fl["pp_dme"] = repr(float(errors[i]))
        self._version += 1

    # -- pulse numbers (reference ``toa.py:548-562,811-839``) --------------
    def get_pulse_numbers(self) -> Optional[np.ndarray]:
        """The pulse-number column, else the ``-pn`` flags where every TOA
        carries one, else None."""
        if self.pulse_number is not None:
            return self.pulse_number
        vals, valid = self.get_flag_value("pn", as_type=float)
        if len(valid) == len(self):
            return np.asarray(vals, dtype=np.float64)
        if valid:
            from pint_torch.logging import log

            log.warning("Some but not all TOAs have pulse-number flags; "
                        "ignoring")
        return None

    def compute_pulse_numbers(self, model) -> np.ndarray:
        """Each TOA's nearest integer pulse number under ``model``: the
        absolute phase's integer part plus its rounded fraction, evaluated
        on the model's device."""
        ph = model.phase(self, abs_phase=True)
        self.pulse_number = (ph.int_ + torch.round(ph.frac)) \
            .detach().cpu().numpy()
        # the model's batch of these TOAs carries the column
        self._version += 1
        return self.pulse_number

    def phase_columns_from_flags(self) -> None:
        """The pulse-number column from the ``-pn`` flags (NaN where a TOA
        has none; the flags are dropped) and, where any TOA carries
        ``-padd``, the added pulses (0 elsewhere); raises without a
        ``-pn`` flag."""
        pn, valid = self.get_flag_value("pn", as_type=float)
        if not valid:
            raise InvalidTOAError(
                "No pulse number flags (-pn) found in the TOAs")
        col = np.full(len(self), np.nan)
        for i in valid:
            col[i] = pn[i]
        self.pulse_number = col
        for fl in self.flags:
            fl.pop("pn", None)
        padd, pvalid = self.get_flag_value("padd", as_type=float)
        if pvalid:
            d = np.zeros(len(self))
            for i in pvalid:
                d[i] = padd[i]
            self.delta_pulse_number = d
        self._version += 1

    def remove_pulse_numbers(self) -> None:
        """Drop both pulse-number columns."""
        self.pulse_number = None
        self.delta_pulse_number = None
        self._version += 1

    def get_clusters(self, gap_limit_hr: float = 2.0,
                     add_column: bool = False) -> np.ndarray:
        """Per-TOA observing-epoch index, epochs split by gaps longer than
        ``gap_limit_hr`` hours and numbered in time order; with
        ``add_column`` also each TOA's ``-cluster`` flag."""
        if gap_limit_hr <= 0:
            raise UsageError(f"gap_limit_hr must be positive, "
                             f"got {gap_limit_hr}")
        mjds = np.asarray(self.get_mjds(), dtype=np.float64)
        if len(mjds) == 0:
            return np.empty(0, dtype=np.int64)
        order = np.argsort(mjds, kind="stable")
        gaps = np.diff(mjds[order]) > gap_limit_hr / 24.0
        clusters = np.empty(len(mjds), dtype=np.int64)
        clusters[order] = np.concatenate([[0], np.cumsum(gaps)])
        if add_column:
            for i, c in enumerate(clusters):
                self.flags[i]["cluster"] = str(int(c))
            self._version += 1
        return clusters

    def adjust_TOAs(self, delta_seconds) -> "TOAs":
        """Shift the arrival times in place by ``delta_seconds``."""
        delta_day = np.asarray(delta_seconds, dtype=np.float64) / DAY_S
        if self.utc_mjd_lo is not None:
            # pair path: error-free sums keep the shifted time exact
            hi, lo = two_sum_np(np.asarray(self.utc_mjd, np.float64),
                                delta_day)
            hi, lo = two_sum_np(hi, lo + self.utc_mjd_lo)
            self.utc_mjd = np.asarray(hi, dtype=np.longdouble)
            self.utc_mjd_lo = lo
            if self.tdb is not None:
                hi, lo = two_sum_np(np.asarray(self.tdb, np.float64),
                                    delta_day)
                hi, lo = two_sum_np(hi, lo + self.tdb_lo)
                self.tdb = np.asarray(hi, dtype=np.longdouble)
                self.tdb_lo = lo
        else:
            d = np.asarray(delta_seconds, dtype=np.longdouble) \
                / np.longdouble(DAY_S)
            self.utc_mjd = self.utc_mjd + d
            if self.tdb is not None:
                self.tdb = self.tdb + d
        self._version += 1
        return self

    def first_MJD(self) -> float:
        return float(np.min(self.get_mjds()))

    def last_MJD(self) -> float:
        return float(np.max(self.get_mjds()))

    @property
    def observatories(self) -> set:
        return set(str(o) for o in self.obs)

    def get_Tspan(self) -> float:
        """The TOAs' span [d]."""
        m = np.asarray(self.get_mjds(), dtype=np.float64)
        return float(m.max() - m.min()) if len(m) else 0.0

    def get_all_flags(self) -> list:
        names: set = set()
        for fl in self.flags:
            names |= set(fl)
        return sorted(names)

    def get_flags(self) -> list:
        return self.flags

    def get_obs_groups(self):
        """(observatory name, index array) groups, by name."""
        obs = np.asarray([str(o) for o in self.obs])
        for name in sorted(set(obs)):
            yield name, np.nonzero(obs == name)[0]

    def get_highest_density_range(self, ndays: float = 7.0):
        """(start, end) MJD of the ``ndays``-wide window holding the most
        TOAs."""
        m = np.sort(np.asarray(self.get_mjds(), dtype=np.float64))
        if not len(m):
            raise UsageError("no TOAs")
        counts = np.searchsorted(m, m + float(ndays), side="right") \
            - np.arange(len(m))
        i = int(np.argmax(counts))
        return m[i], m[i] + float(ndays)

    def get_summary(self) -> str:
        """Short text summary (reference ``toa.py:563``)."""
        s = f"Number of TOAs:  {len(self)}\n"
        s += f"Number of commands:  {len(self.commands)}\n"
        s += (f"Number of observatories: {len(self.observatories)} "
              f"{sorted(self.observatories)}\n")
        if len(self):
            s += (f"MJD span:  {self.first_MJD():.3f} to "
                  f"{self.last_MJD():.3f}\n")
        err = np.asarray(self.error_us, dtype=np.float64)
        freq = np.asarray(self.freq_mhz, dtype=np.float64)
        for obs, grp in self.get_obs_groups():
            s += f"{obs} TOAs ({len(grp)}):\n"
            s += f"  Min freq:      {np.min(freq[grp]):.3f} MHz\n"
            s += f"  Max freq:      {np.max(freq[grp]):.3f} MHz\n"
            s += f"  Min error:     {np.min(err[grp]):.3g} us\n"
            s += f"  Max error:     {np.max(err[grp]):.3g} us\n"
            s += f"  Median error:  {np.median(err[grp]):.3g} us\n"
        return s

    def print_summary(self) -> None:
        print(self.get_summary())

    def select(self, selectarray) -> None:
        """In-place boolean selection, undone by :meth:`unselect`
        (deprecated in the reference too: prefer ``toas[mask]``)."""
        import copy as _copy
        import warnings as _warnings

        _warnings.warn("Please use boolean indexing on the object instead: "
                       "toas[selectarray].", DeprecationWarning)
        stack = self.__dict__.pop("_select_stack", [])
        try:
            snapshot = _copy.deepcopy(self)
        finally:
            self._select_stack = stack
        self._select_stack.append(snapshot)
        new = self[np.asarray(selectarray)]
        for k, v in new.__dict__.items():
            if k != "_select_stack":
                self.__dict__[k] = v
        self._version += 1

    def unselect(self) -> None:
        """Undo the last :meth:`select`."""
        import warnings as _warnings

        from pint_torch.logging import log

        _warnings.warn("Please use boolean indexing on the object instead.",
                       DeprecationWarning)
        try:
            old = self._select_stack.pop()
        except (AttributeError, IndexError):
            log.error("No previous TOA table found.  No changes made.")
            return
        stack = self._select_stack
        version = self._version
        self.__dict__.update(old.__dict__)
        self._select_stack = stack
        self._version = version + 1

    def merge(self, *others) -> "TOAs":
        return merge_TOAs([self, *others])

    def to_TOA_list(self) -> list:
        """One :class:`TOA` per row."""
        out = []
        mjds = np.asarray(self.utc_mjd)
        for i in range(len(self)):
            day = np.floor(mjds[i])
            out.append(TOA((float(day), float(mjds[i] - day)),
                           error=float(self.error_us[i]),
                           obs=str(self.obs[i]), freq=float(self.freq_mhz[i]),
                           flags=dict(self.flags[i])))
        return out

    def update_all_times(self, ephem=None, planets=None) -> None:
        """Clock corrections, TDBs and posvels again (after editing
        arrival times or sites)."""
        self.clock_corr_s = None
        self.apply_clock_corrections(include_gps=self.include_gps,
                                     include_bipm=self.include_bipm,
                                     bipm_version=self.bipm_version)
        self.compute_TDBs(ephem=ephem or self.ephem)
        self.compute_posvels(ephem=ephem or self.ephem or "DE440",
                             planets=self.planets if planets is None
                             else planets)

    def check_hashes(self, timfile: Optional[str] = None) -> bool:
        """True while the source tim files (INCLUDEs too) are unchanged
        since these TOAs were read."""
        src = timfile or self.filename
        if not src:
            return True
        try:
            current = _tim_hashes(src)
        except OSError:
            return False
        stored = getattr(self, "_hashes", None)
        if stored is None:
            raise UsageError(
                "No source hashes were recorded when this TOAs object was "
                "built; cannot verify against the tim file")
        return stored == current

    def write_TOA_file(self, path, name="pint_torch", format="tempo2"):
        """Write a tim file (reference ``toa.py:843``): each MJD's digits
        exactly as :func:`_mjd_line_parts` gives them."""
        with open(path, "w") as f:
            if format.lower() in ("tempo2", "1"):
                f.write("FORMAT 1\n")
            for i in range(len(self)):
                ii, frac = _mjd_line_parts(
                    self.utc_mjd[i], self.utc_mjd_lo[i]
                    if self.utc_mjd_lo is not None else None)
                fl = dict(self.flags[i])
                nm = fl.pop("name", name)
                f.write(format_toa_line(
                    ii, frac, self.error_us[i], self.freq_mhz[i],
                    self.obs[i], name=nm, flags=fl, fmt=format))

    def save_pickle(self, path) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load_pickle(path) -> "TOAs":
        with open(path, "rb") as f:
            return pickle.load(f)

    def _mjd_lo(self) -> np.ndarray:
        """The sub-double part of each UTC MJD (the duplicate check's
        key beside the float MJD)."""
        mjd64 = np.asarray(self.utc_mjd, dtype=np.float64)
        with np.errstate(invalid="ignore"):
            lo = np.asarray(np.asarray(self.utc_mjd)
                            - mjd64.astype(np.longdouble), dtype=np.float64)
        lo = np.where(np.isfinite(lo), lo, 0.0)
        if self.utc_mjd_lo is not None:
            lo = lo + np.asarray(self.utc_mjd_lo, dtype=np.float64)
        return lo

    # -- the device batch ----------------------------------------------------
    def to_batch(self, tdb0: Optional[float] = None, device=None,
                 model=None, tzr: bool = False) -> TOABatch:
        """Freeze into a :class:`TOABatch` on ``device`` (default
        ``"cuda"``): light-second units, double-double times, ``tdb_s``
        rebuilt from the host error-free transforms as the reference's
        ``to_batch`` does; with ``model``, each of its components' context
        for these TOAs (:meth:`TimingModel.host_contexts`)."""
        from pint_torch import resolve_device

        if self.tdb is None:
            raise UsageError(
                "Run compute_TDBs/compute_posvels before to_batch()")
        if self.ssb_obs_pos_km is None:
            raise UsageError("Run compute_posvels before to_batch()")
        dev = resolve_device(device)
        if tdb0 is None:
            tdb0 = float(np.round(np.mean(np.asarray(self.tdb,
                                                     dtype=np.float64))))
        if self.tdb_lo is not None:
            hi, lo = two_sum(np.asarray(self.tdb, np.float64), self.tdb_lo)
        else:
            hi = np.asarray(self.tdb, dtype=np.float64)
            lo = np.asarray(self.tdb - hi.astype(np.longdouble),
                            dtype=np.float64)
        d_hi = hi - tdb0  # same-scale MJDs: Sterbenz-exact
        s_hi, s_err = two_prod(d_hi, DAY_S)
        s_hi, s_err2 = two_sum(s_hi, s_err + lo * DAY_S)

        def t(a):
            return torch.tensor(np.asarray(a, dtype=np.float64), dtype=F64,
                                device=dev)

        pn = self.get_pulse_numbers()
        dm = dm_err = None
        if self.wideband:
            dm = t([float(fl["pp_dm"]) for fl in self.flags])
            if all("pp_dme" in fl for fl in self.flags):
                dm_err = t([float(fl["pp_dme"]) for fl in self.flags])
        return TOABatch(
            tdb=DD(t(hi), t(lo)), tdb0=float(tdb0), tdb_s=DD(t(s_hi),
                                                             t(s_err2)),
            freq=t(self.freq_mhz), error_us=t(self.error_us),
            ssb_obs_pos=t(self.ssb_obs_pos_km / C_KM_S),
            ssb_obs_vel=t(self.ssb_obs_vel_kms / C_KM_S),
            obs_sun_pos=t(self.obs_sun_pos_km / C_KM_S),
            planet_pos={k: t(v / C_KM_S)
                        for k, v in self.planet_pos_km.items()},
            mjds=np.asarray(self.get_mjds(), dtype=np.float64), tzr=tzr,
            dm=dm, dm_error=dm_err,
            contexts=None if model is None
            else model.host_contexts(self, device=dev),
            ephem=self.ephem, mjd_lo=self._mjd_lo(),
            obs=np.asarray(self.obs).astype(str),
            pulse_number=None if pn is None else t(pn),
            delta_pulse_number=None if self.delta_pulse_number is None
            else t(self.delta_pulse_number), host=self,
            _ctx_sig=None if model is None else model._context_signatures())


def select_toa_mask(par, toas) -> np.ndarray:
    """Indices of the TOAs a mask parameter (``key``, ``key_value``)
    selects (reference ``parameter.py:493``): every TOA without a key, an
    MJD or frequency range, an observatory, a ``name``, or a flag's
    value."""
    n = len(toas)
    if par.key is None:
        return np.arange(n)
    if par.key == "mjd":
        m = np.asarray(toas.get_mjds(), dtype=np.float64)
        lo, hi = float(par.key_value[0]), float(par.key_value[1])
        return np.nonzero((m >= lo) & (m <= hi))[0]
    if par.key == "freq":
        f = toas.get_freqs()
        lo, hi = float(par.key_value[0]), float(par.key_value[1])
        return np.nonzero((f >= lo) & (f <= hi))[0]
    if par.key == "tel":
        want = _observatory(str(par.key_value[0])).name
        return np.nonzero(toas.get_obss() == want)[0]
    if par.key == "name":
        names = np.array([fl.get("name", "") for fl in toas.flags])
        return np.nonzero(names == str(par.key_value[0]))[0]
    flag = par.key.lstrip("-")
    want = str(par.key_value[0])
    return np.nonzero(np.array([fl.get(flag) == want
                                for fl in toas.flags], dtype=bool))[0]


def _pair_split(a, b):
    """(mjd1, mjd2) -> (longdouble hi, float64 lo), the low word kept
    where longdouble is only a double."""
    hi = np.asarray(a, dtype=np.longdouble) \
        + np.asarray(b, dtype=np.longdouble)
    if np.finfo(np.longdouble).eps > 2e-19:
        _, lo = two_sum(np.asarray(a, dtype=np.float64),
                        np.asarray(b, dtype=np.float64))
    else:
        lo = np.zeros_like(np.asarray(hi, dtype=np.float64))
    return hi, lo


def parse_clock_bipm(clock_value):
    """(include_bipm, bipm_version or None) that a par file's CLOCK
    implies; include_bipm is None where CLOCK decides nothing."""
    clk = str(clock_value or "").upper()
    if clk.startswith("TT(BIPM"):
        ver = clk[3:].rstrip(")")
        return True, (ver if ver and ver != "BIPM" else None)
    if clk in ("TT(TAI)", "UTC(NIST)", "TT"):
        return False, None
    return None, None


def _model_value(model, name):
    return model[name].value if name in model else None


def _resolve_pipeline_options(model, ephem, planets, include_bipm,
                              bipm_version):
    """Ephemeris, planets and BIPM settings from the model, where the
    caller left them open."""
    if model is not None:
        if ephem is None and "EPHEM" in model:
            ephem = str(_model_value(model, "EPHEM"))
        if include_bipm is None and "CLOCK" in model:
            include_bipm, ver = parse_clock_bipm(_model_value(model,
                                                              "CLOCK"))
            if ver:
                bipm_version = ver
        if planets is False and "PLANET_SHAPIRO" in model:
            planets = bool(_model_value(model, "PLANET_SHAPIRO"))
    if include_bipm is None:
        include_bipm = True
    return ephem, planets, include_bipm, bipm_version


def _finalize_toas(t: TOAs, ephem, planets, include_gps, include_bipm,
                   bipm_version, limits) -> TOAs:
    """The pipeline after the table is made: clock chain, TDB, posvels."""
    t.apply_clock_corrections(include_gps=include_gps,
                              include_bipm=include_bipm,
                              bipm_version=bipm_version, limits=limits)
    t.compute_TDBs(ephem=ephem or "DE440")
    t.compute_posvels(ephem=ephem or "DE440", planets=planets)
    return t


def get_TOAs_array(times, obs: str, errors=1.0, freqs=np.inf, flags=None,
                   ephem: Optional[str] = None, planets: bool = False,
                   include_gps: bool = True,
                   include_bipm: Optional[bool] = None,
                   bipm_version: str = "BIPM2021", model=None,
                   limits: str = "warn", **kwargs) -> TOAs:
    """TOAs at one observatory from arrays, through the whole pipeline
    (reference ``toa.py:1120``).  ``times`` is an MJD array or an
    ``(mjd1, mjd2)`` pair of arrays summing to full precision; scalar
    ``errors``/``freqs`` broadcast; ``flags`` is one dict for every TOA or
    a list of per-TOA dicts; other keywords become shared flags."""
    ephem, planets, include_bipm, bipm_version = _resolve_pipeline_options(
        model, ephem, planets, include_bipm, bipm_version)
    if isinstance(times, tuple) and len(times) == 2:
        hi, lo = _pair_split(times[0], times[1])
        utc = np.atleast_1d(hi)
        lo = np.atleast_1d(lo)
    else:
        utc = np.atleast_1d(np.asarray(times, dtype=np.longdouble))
        lo = None
    n = len(utc)
    err = np.broadcast_to(np.asarray(errors, dtype=np.float64), (n,)).copy()
    freq = np.broadcast_to(np.asarray(freqs, dtype=np.float64), (n,)).copy()
    freq[freq <= 0] = np.inf
    site = _observatory(obs).name
    obs_arr = np.full(n, site, dtype=object)
    if flags is None:
        flag_list = [dict() for _ in range(n)]
    elif isinstance(flags, dict):
        flag_list = [dict(flags) for _ in range(n)]
    else:
        if len(flags) != n:
            raise InvalidTOAError("flags list length must match times")
        flag_list = [dict(f) for f in flags]
    for k, v in kwargs.items():
        for f in flag_list:
            f.setdefault(k.lstrip("-"), str(v))
    t = TOAs(utc, err, freq, obs_arr, flag_list, [], None)
    if lo is not None and np.any(lo):
        t.utc_mjd_lo = np.asarray(lo, dtype=np.float64)
    return _finalize_toas(t, ephem, planets, include_gps, include_bipm,
                          bipm_version, limits)


def make_single_toa(mjd, obs: str, freq_mhz: float = np.inf,
                    error_us: float = 0.0, ephem: str = "DE440",
                    include_gps=True, include_bipm=True,
                    bipm_version="BIPM2021", planets=False) -> TOAs:
    """A one-TOA table flagged ``tzr`` (an absolute phase's TZR TOA,
    reference ``toa.py:1347``)."""
    t = TOAs(utc_mjd=np.array([mjd], dtype=np.longdouble),
             error_us=np.array([error_us]),
             freq_mhz=np.array([freq_mhz if freq_mhz and freq_mhz > 0
                                else np.inf]),
             obs=np.array([_observatory(obs).name], dtype=object),
             flags=[{"tzr": "True"}])
    t.apply_clock_corrections(include_gps=include_gps,
                              include_bipm=include_bipm,
                              bipm_version=bipm_version)
    t.compute_TDBs(ephem=ephem)
    t.compute_posvels(ephem=ephem, planets=planets)
    return t


# ---------------------------------------------------------------------------
# reading tim files (reference ``pint_tpu/toa.py:53-118,918-1290``)
# ---------------------------------------------------------------------------
def parse_decimal_strings(strings):
    """Decimal strings -> (hi, lo) float64 arrays to ~2^-104 relative: the
    C++ parser (:func:`pint_torch.native.str2dd_batch`, double-double
    accumulation) where it built, else the pure-Python path
    (:func:`pint_torch.dd.dd_from_string`, exact rational rounding).  The
    two may part in the low word's last bits; rounded to an 80-bit
    longdouble, as the MJD parse does, they agree but at exact near-ties."""
    from pint_torch import native
    from pint_torch.dd import dd_from_string

    if native.available():
        return native.str2dd_batch(list(strings))
    pairs = [dd_from_string(s) for s in strings]
    return (np.array([p.hi for p in pairs], dtype=np.float64),
            np.array([p.lo for p in pairs], dtype=np.float64))


class FlagDict(MutableMapping):
    """Validated per-TOA flags (reference ``toa.py:53``): string keys
    stored lowercase without their leading ``-``, single-token string
    values; an empty value deletes the flag."""

    _key_re = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

    def __init__(self, *args, **kwargs):
        self.store = {}
        self.update(dict(*args, **kwargs))

    @staticmethod
    def from_dict(d: dict) -> "FlagDict":
        r = FlagDict()
        r.update(d)
        return r

    @staticmethod
    def check_allowed_key(k) -> None:
        if not isinstance(k, str):
            raise InvalidTOAError(f"flag {k!r} must be a string")
        if k.startswith("-"):
            raise InvalidTOAError(
                "flags should be stored without their leading -")
        if not FlagDict._key_re.match(k):
            raise InvalidTOAError(f"flag {k!r} is not a valid flag name")

    @staticmethod
    def check_allowed_value(k, v) -> None:
        if not isinstance(v, str):
            raise InvalidTOAError(f"value {v!r} for flag {k} must be a string")
        if v and len(v.split()) != 1:
            raise InvalidTOAError(
                f"value {v!r} for flag {k} cannot contain whitespace")

    def __setitem__(self, key, val):
        self.check_allowed_key(key)
        self.check_allowed_value(key, val)
        if val:
            self.store[key.lower()] = val
        else:
            self.store.pop(key.lower(), None)

    def __delitem__(self, key):
        del self.store[key.lower()]

    def __getitem__(self, key):
        return self.store[key.lower()]

    def __iter__(self):
        return iter(self.store)

    def __len__(self):
        return len(self.store)

    def __repr__(self):
        return f"FlagDict({self.store!r})"

    def __str__(self):
        return str(self.store)

    def copy(self) -> "FlagDict":
        return FlagDict.from_dict(self.store)


class TOA:
    """One time of arrival (reference ``toa.py:973``), the unit of
    :func:`get_TOAs_list`: ``mjd`` a float MJD, an ``(int, frac)`` pair
    of floats summed at full precision, or an MJD string; site UTC only."""

    def __init__(self, mjd, error: float = 0.0, obs: str = "bary",
                 freq: float = float("inf"), scale=None, flags=None,
                 name: str = "unk", **kwargs):
        self.mjd = mjd
        self.error = float(error)
        self.obs = obs
        self.freq = float(freq)
        if scale not in (None, "utc"):
            raise NotImplementedError(
                f"TOA scale={scale!r} is not supported: times are site-UTC "
                "(the tim-file convention). Convert to UTC first.")
        self.scale = scale
        self.flags = dict(flags or {})
        for k, v in kwargs.items():
            self.flags.setdefault(k.lstrip("-"), str(v))
        self.name = name

    def __str__(self):
        return (f"{self.mjd}: {self.error} us error at '{self.obs}' at "
                f"{self.freq} MHz")

    def as_line(self) -> str:
        """This TOA as a tempo2 tim line."""
        hi, lo = _split_mjd_value(self.mjd)
        mjd_i, frac = _mjd_line_parts(hi, lo if lo else None)
        return format_toa_line(mjd_i, frac, self.error, self.freq, self.obs,
                               flags=self.flags, name=self.name)


def _mjd_line_parts(mjd, lo=None):
    """(longdouble, optional float64 low word) MJD -> (int day, fraction
    digits) of a tim line: with a low word the exact (hi, lo) value to 25
    digits, so a round trip through the parser is lossless; else the
    longdouble fraction to 16 digits (reference ``toa.py:1013``)."""
    ii = int(np.floor(mjd))
    if lo:
        fr = Fraction(float(mjd)) - ii + Fraction(float(lo))
        if fr < 0:
            ii -= 1
            fr += 1
        q = round(fr * 10**25)
        frac = f"{q:025d}".rstrip("0")
    else:
        ff = np.format_float_positional(mjd - ii, precision=16, trim="-")
        if ff.startswith("1"):  # the fraction rounded up to the next day
            return ii + 1, "0"
        frac = ff.split(".")[1] if "." in ff else "0"
    return ii, frac or "0"


def _split_mjd_value(mjd):
    """float | (int, frac) pair | string -> (longdouble, float64 low
    word)."""
    if isinstance(mjd, (tuple, list)) and len(mjd) == 2:
        hi, lo = _pair_split(mjd[0], mjd[1])
        return np.longdouble(hi), float(lo)
    if isinstance(mjd, str):
        i, _, f = mjd.partition(".")
        raw = RawTOA(mjd_int=int(i), mjd_frac_str=f or "0", error_us=0.0,
                     freq_mhz=0.0, obs="bary")
        utc, lo = TOAs._mjds_from_raw([raw])
        return utc[0], float(lo[0]) if lo is not None else 0.0
    return np.longdouble(mjd), 0.0


def get_TOAs(timfile: str, ephem: Optional[str] = None, planets: bool = False,
             include_gps: bool = True, include_bipm: Optional[bool] = None,
             bipm_version: str = "BIPM2021", model=None, limits: str = "warn",
             usepickle: bool = False, policy: Optional[str] = None,
             validate: bool = True) -> TOAs:
    """Read a tim file and run the host pipeline (reference
    ``toa.py:918``): the parse and the structural :meth:`TOAs.validate`
    under ``policy`` (default :func:`pint_torch.config.ingestion_policy`),
    then the clock chain, TDB and posvels.  The parse's
    :class:`~pint_torch.integrity.diagnostics.Diagnostics` rides on the
    result as ``ingest_diagnostics``; ``usepickle`` serves and refreshes
    a cache keyed on the tim files' hashes and these settings."""
    from pint_torch.config import ingestion_policy
    from pint_torch.integrity.diagnostics import Diagnostics
    from pint_torch.logging import log

    ephem, planets, include_bipm, bipm_version = _resolve_pipeline_options(
        model, ephem, planets, include_bipm, bipm_version)
    policy = policy or ingestion_policy()
    pickle_key = (ephem, planets, include_gps, include_bipm, bipm_version,
                  limits, policy, validate)
    if usepickle:
        t = _load_toa_pickle(timfile, pickle_key)
        if t is not None:
            log.info(f"Loaded {len(t)} TOAs from pickle cache for {timfile}")
            return t
    diags = Diagnostics(timfile)
    raw, commands = read_tim_file(timfile, policy=policy, diagnostics=diags)
    if not raw:
        raise TimSyntaxError("no TOAs found in file", file=timfile)
    t = TOAs.from_raw(raw, commands, filename=timfile)
    t.ingest_diagnostics = diags
    try:
        t._hashes = _tim_hashes(timfile)
    except OSError:
        pass
    if validate:
        # structural checks only; coverage needs an explicit t.validate()
        t.validate(policy=policy, check_coverage=False)
    _finalize_toas(t, ephem, planets, include_gps, include_bipm,
                   bipm_version, limits)
    log.info(f"Loaded {len(t)} TOAs from {timfile} "
             f"(ephem={t.ephem}, planets={planets}, bipm={include_bipm})")
    if usepickle:
        _save_toa_pickle(timfile, pickle_key, t)
    return t


def get_TOAs_list(toa_list, ephem: Optional[str] = None,
                  planets: bool = False, include_gps: bool = True,
                  include_bipm: Optional[bool] = None,
                  bipm_version: str = "BIPM2021", model=None,
                  limits: str = "warn", commands=None) -> TOAs:
    """TOAs from :class:`TOA` objects through the host pipeline
    (reference ``toa.py:1074``)."""
    ephem, planets, include_bipm, bipm_version = _resolve_pipeline_options(
        model, ephem, planets, include_bipm, bipm_version)
    t = build_table(toa_list, commands=commands)
    return _finalize_toas(t, ephem, planets, include_gps, include_bipm,
                          bipm_version, limits)


def build_table(toa_list, filename: Optional[str] = None,
                commands=None) -> TOAs:
    """The host table of :class:`TOA` objects, pipeline not run
    (reference ``toa.py:1089``)."""
    n = len(toa_list)
    if n == 0:
        raise InvalidTOAError("build_table: empty TOA list")
    utc = np.empty(n, dtype=np.longdouble)
    lo = np.zeros(n, dtype=np.float64)
    err = np.empty(n, dtype=np.float64)
    freq = np.empty(n, dtype=np.float64)
    obs = np.empty(n, dtype=object)
    flags = []
    for i, tt in enumerate(toa_list):
        utc[i], lo[i] = _split_mjd_value(tt.mjd)
        err[i] = tt.error
        freq[i] = tt.freq if tt.freq > 0 else np.inf
        obs[i] = _observatory(tt.obs).name
        fl = dict(tt.flags)
        if tt.name and tt.name != "unk":
            fl.setdefault("name", tt.name)
        flags.append(fl)
    t = TOAs(utc, err, freq, obs, flags, list(commands or []), filename)
    if np.any(lo):
        t.utc_mjd_lo = lo
    return t


def load_pickle(toafilename: str,
                picklefilename: Optional[str] = None) -> TOAs:
    """Pickled TOAs, gzipped or not: ``<name>.pickle.gz``,
    ``<name>.pickle`` or the name itself unless a path is given
    (reference ``toa.py:1166``)."""
    import gzip

    candidates = ([picklefilename] if picklefilename is not None else
                  [toafilename + ".pickle.gz", toafilename + ".pickle",
                   toafilename])
    for cand in candidates:
        if not os.path.exists(cand):
            continue
        try:
            with open(cand, "rb") as f:
                gzipped = f.read(2) == b"\x1f\x8b"
            with (gzip.open if gzipped else open)(cand, "rb") as f:
                return pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError, ValueError):
            continue
    raise PintPickleError(f"No readable pickle found for {toafilename}")


def save_pickle(toas: TOAs, picklefilename: Optional[str] = None) -> None:
    """Write TOAs to a ``.pickle.gz`` named after their tim file unless
    a name is given (reference ``toa.py:1190``)."""
    import gzip

    if picklefilename is None:
        if not toas.filename:
            raise UsageError(
                "TOAs have no (single) source filename; please provide "
                "picklefilename")
        picklefilename = str(toas.filename) + ".pickle.gz"
    opener = gzip.open if str(picklefilename).endswith(".gz") else open
    with opener(picklefilename, "wb") as f:
        pickle.dump(toas, f)


def read_toa_file(filename):
    """(raw TOAs, commands) of a tim file (reference ``toa.py:1209``)."""
    return read_tim_file(filename)


#: the suffix of :func:`get_TOAs`' hash-keyed pickle cache
PICKLE_SUFFIX = ".pint_torch_toas.pickle"


def _file_hash(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def _tim_file_set(timfile: str, _seen=None) -> List[str]:
    """The tim file and every file it INCLUDEs, recursively."""
    _seen = _seen if _seen is not None else []
    if timfile in _seen or not os.path.exists(timfile):
        return _seen
    _seen.append(timfile)
    with open(timfile) as f:
        for ln in f:
            fields = ln.split()
            if len(fields) >= 2 and fields[0].upper() == "INCLUDE":
                _tim_file_set(os.path.join(os.path.dirname(timfile),
                                           fields[1]), _seen)
    return _seen


def _tim_hashes(timfile: str) -> Dict[str, str]:
    return {p: _file_hash(p) for p in _tim_file_set(timfile)}


def _load_toa_pickle(timfile: str, key) -> Optional[TOAs]:
    """The cached TOAs where the SHA-256 of the tim file and of every
    INCLUDEd file and the settings all match, else None."""
    from pint_torch.logging import log

    path = timfile + PICKLE_SUFFIX
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            d = pickle.load(f)
        if d.get("tim_sha") != _tim_hashes(timfile) or d.get("key") != key:
            log.info(f"TOA pickle cache for {timfile} is stale; rebuilding")
            return None
        return d["toas"]
    except Exception as e:
        log.warning(f"Failed to read TOA pickle {path}: {e}")
        return None


def _save_toa_pickle(timfile: str, key, t: TOAs) -> None:
    from pint_torch.logging import log

    path = timfile + PICKLE_SUFFIX
    try:
        with open(path, "wb") as f:
            pickle.dump({"tim_sha": _tim_hashes(timfile), "key": key,
                         "toas": t}, f)
    except OSError as e:  # a read-only data directory: best effort
        log.warning(f"Could not write TOA pickle {path}: {e}")


def _merge_time_pair(toas_list, hi_name, lo_name):
    """Merged (hi, lo) columns, hi exactly a double wherever a low word is
    carried: inputs without one contribute their longdouble's sub-double
    part as the low word."""
    new_hi, new_lo = [], []
    for t in toas_list:
        h, v = getattr(t, hi_name), getattr(t, lo_name)
        if v is not None:
            new_hi.append(h)
            new_lo.append(v)
        else:
            h64 = np.asarray(h, np.float64)
            new_hi.append(h64.astype(np.longdouble))
            new_lo.append(np.asarray(h - h64.astype(np.longdouble),
                                     dtype=np.float64))
    return np.concatenate(new_hi), np.concatenate(new_lo)


def _merge_host(toas_list: List[TOAs]) -> TOAs:
    """Host TOAs concatenated (reference ``toa.py:1292``)."""
    first = toas_list[0]
    if any(t.utc_mjd_lo is not None for t in toas_list):
        utc_hi, utc_lo = _merge_time_pair(toas_list, "utc_mjd", "utc_mjd_lo")
    else:
        utc_hi = np.concatenate([t.utc_mjd for t in toas_list])
        utc_lo = None
    out = replace(first, utc_mjd=utc_hi,
                  error_us=np.concatenate([t.error_us for t in toas_list]),
                  freq_mhz=np.concatenate([t.freq_mhz for t in toas_list]),
                  obs=np.concatenate([t.obs for t in toas_list]),
                  flags=[fl for t in toas_list for fl in t.flags])
    out.utc_mjd_lo = utc_lo
    tdb_pair = (any(t.tdb_lo is not None for t in toas_list)
                and all(t.tdb is not None for t in toas_list))
    if tdb_pair:
        out.tdb, out.tdb_lo = _merge_time_pair(toas_list, "tdb", "tdb_lo")
    else:
        out.tdb_lo = None
    for name in ("clock_corr_s", "ssb_obs_pos_km", "ssb_obs_vel_kms",
                 "obs_sun_pos_km", "pulse_number", "delta_pulse_number") \
            + (() if tdb_pair else ("tdb",)):
        vals = [getattr(t, name) for t in toas_list]
        setattr(out, name, np.concatenate(vals)
                if all(v is not None for v in vals) else None)
    out.planet_pos_km = {}
    if all(t.planet_pos_km.keys() == first.planet_pos_km.keys()
           for t in toas_list):
        for k in first.planet_pos_km:
            out.planet_pos_km[k] = np.concatenate(
                [t.planet_pos_km[k] for t in toas_list])
    if any(t.quarantine_mask is not None for t in toas_list):
        out.quarantine_mask = np.concatenate([
            t.quarantine_mask if t.quarantine_mask is not None
            else np.zeros(len(t), dtype=bool) for t in toas_list])
        out.quarantine_reasons = [
            list(r) for t in toas_list for r in (
                t.quarantine_reasons if t.quarantine_reasons is not None
                else [[] for _ in range(len(t))])]
    else:
        out.quarantine_mask = None
        out.quarantine_reasons = None
    if len(toas_list) > 1:
        out.filename = None  # no single source file
    return out
