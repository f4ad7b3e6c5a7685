"""TOA quarantine: detect rows that must not reach a fit (port of
``pint_tpu/integrity/quarantine.py``: ``RowDelta``/``row_delta`` :57-107,
``QuarantineReport`` :110-155, the checks :158-251, ``run_toa_checks``
:254).

:meth:`pint_torch.toa.TOABatch.validate` delegates here.  Each check yields
``(index, code, message)`` findings; offenders go into a boolean quarantine
mask (True = quarantined) that rides beside the batch, and fitters consume
the certified complement (:meth:`~pint_torch.toa.TOABatch.certified`).

Checks: ``toa-nonfinite-mjd``, ``toa-bad-error`` (non-positive, non-finite
or above ``max_error_us``), ``toa-nonfinite-freq`` (NaN or -inf; +inf is
the infinite-frequency sentinel), ``toa-duplicate`` (a repeated (MJD hi,
MJD lo, observatory, frequency) row: every occurrence after the first),
``toa-clock-coverage`` and ``toa-ephem-coverage``.  The two coverage
checks read what the snapshot carries from the reference's host ingest
(``TOABatch.coverage``: each site's clock-chain end and the ephemeris
span); the port reads no clock or ephemeris file.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["QuarantineFinding", "QuarantineReport", "RowDelta",
           "row_delta", "run_toa_checks", "ABSURD_ERROR_US"]

#: anything beyond this TOA uncertainty is a corrupt column, not a
#: measurement (1e9 us = ~17 min)
ABSURD_ERROR_US = 1e9


@dataclass(frozen=True)
class QuarantineFinding:
    index: int
    code: str
    message: str

    def render(self) -> str:
        return f"  row {self.index}: {self.message} ({self.code})"


@dataclass(frozen=True)
class RowDelta:
    """The changed-row delta of one re-validation pass: rows ``added``
    (validated for the first time and certified), newly ``quarantined``
    and newly ``released``; indices into the validated batch."""

    added: Tuple[int, ...]
    quarantined: Tuple[int, ...]
    released: Tuple[int, ...]

    @property
    def empty(self) -> bool:
        return not (self.added or self.quarantined or self.released)


def row_delta(prev_mask: Optional[np.ndarray],
              new_mask: np.ndarray) -> RowDelta:
    """Delta between two quarantine masks; ``prev_mask`` None means never
    validated (every certified row is ``added``), and rows past a shorter
    previous mask are ``added`` where certified."""
    new_mask = np.asarray(new_mask, dtype=bool)
    n = len(new_mask)
    if prev_mask is None:
        return RowDelta(
            added=tuple(int(i) for i in np.nonzero(~new_mask)[0]),
            quarantined=(), released=())
    prev_mask = np.asarray(prev_mask, dtype=bool)
    o = min(len(prev_mask), n)
    return RowDelta(
        added=tuple(int(i) for i in range(o, n) if not new_mask[i]),
        quarantined=tuple(
            int(i) for i in np.nonzero(~prev_mask[:o] & new_mask[:o])[0]),
        released=tuple(
            int(i) for i in np.nonzero(prev_mask[:o] & ~new_mask[:o])[0]))


@dataclass
class QuarantineReport:
    """Outcome of one ``validate()`` pass."""

    n_toas: int
    findings: List[QuarantineFinding] = field(default_factory=list)
    #: changed-row delta against the batch's previous mask (None when the
    #: checks ran standalone)
    delta: Optional[RowDelta] = None

    @property
    def mask(self) -> np.ndarray:
        """Boolean quarantine mask (True = quarantined)."""
        m = np.zeros(self.n_toas, dtype=bool)
        for f in self.findings:
            m[f.index] = True
        return m

    @property
    def n_quarantined(self) -> int:
        return int(self.mask.sum())

    def codes(self) -> List[str]:
        return sorted({f.code for f in self.findings})

    def reasons_by_row(self) -> List[List[str]]:
        out: List[List[str]] = [[] for _ in range(self.n_toas)]
        for f in self.findings:
            out[f.index].append(f.message)
        return out

    def __bool__(self) -> bool:
        return bool(self.findings)

    def render(self, limit: int = 20) -> str:
        head = (f"TOA quarantine: {self.n_quarantined}/{self.n_toas} row(s) "
                f"quarantined ({', '.join(self.codes()) or 'clean'})")
        body = [f.render() for f in self.findings[:limit]]
        if len(self.findings) > limit:
            body.append(f"  ... and {len(self.findings) - limit} more")
        return "\n".join([head] + body)


def _check_mjds(mjd64):
    bad = ~np.isfinite(mjd64)
    return [QuarantineFinding(int(i), "toa-nonfinite-mjd",
                              f"non-finite MJD {mjd64[i]!r}")
            for i in np.nonzero(bad)[0]]


def _check_errors(err_us, max_error_us):
    out = []
    for i in np.nonzero(~np.isfinite(err_us) | (err_us <= 0)
                        | (err_us > max_error_us))[0]:
        e = err_us[i]
        if not np.isfinite(e):
            msg = f"non-finite uncertainty {e!r}"
        elif e <= 0:
            msg = f"non-positive uncertainty {e} us"
        else:
            msg = f"absurd uncertainty {e:g} us (> {max_error_us:g})"
        out.append(QuarantineFinding(int(i), "toa-bad-error", msg))
    return out


def _check_freqs(freq_mhz):
    bad = np.isnan(freq_mhz) | (freq_mhz == -np.inf)
    return [QuarantineFinding(int(i), "toa-nonfinite-freq",
                              f"non-finite frequency {freq_mhz[i]!r}")
            for i in np.nonzero(bad)[0]]


def _check_duplicates(mjd64, mjd_lo, obs, freq_mhz):
    """Every occurrence after the first of an identical (MJD hi, MJD lo,
    freq, obs) row (lexsort and adjacent compare)."""
    out: List[QuarantineFinding] = []
    idx = np.nonzero(np.isfinite(mjd64))[0]
    if len(idx) < 2:
        return out
    obs_inv = np.unique(obs.astype(str)[idx], return_inverse=True)[1]
    order = np.lexsort((idx, obs_inv, freq_mhz[idx], mjd_lo[idx],
                        mjd64[idx]))
    s = idx[order]
    same = ((mjd64[s][1:] == mjd64[s][:-1])
            & (mjd_lo[s][1:] == mjd_lo[s][:-1])
            & (freq_mhz[s][1:] == freq_mhz[s][:-1])
            & (obs_inv[order][1:] == obs_inv[order][:-1]))
    if not same.any():
        return out
    head_pos = np.maximum.accumulate(
        np.where(np.concatenate([[True], ~same]), np.arange(len(s)), -1))
    for j in np.nonzero(same)[0] + 1:
        i, first = int(s[j]), int(s[head_pos[j]])
        out.append(QuarantineFinding(
            i, "toa-duplicate",
            f"duplicate of row {first} (MJD {mjd64[i]:.10f}, {obs[i]}, "
            f"{freq_mhz[i]:g} MHz)"))
    return out


def _check_clock_coverage(mjd64, obs, clock_end):
    out = []
    for site in np.unique(obs.astype(str)):
        last = clock_end.get(site)
        if last is None or not np.isfinite(last):
            continue
        m = (obs.astype(str) == site) & np.isfinite(mjd64) & (mjd64 > last)
        for i in np.nonzero(m)[0]:
            out.append(QuarantineFinding(
                int(i), "toa-clock-coverage",
                f"MJD {mjd64[i]:.3f} is past the end of the {site} clock "
                f"chain (last correction at MJD {last:.3f})"))
    return out


def _check_ephem_coverage(mjd64, ephem, span):
    lo, hi = span
    bad = np.isfinite(mjd64) & ((mjd64 < lo) | (mjd64 > hi))
    return [QuarantineFinding(
        int(i), "toa-ephem-coverage",
        f"MJD {mjd64[i]:.3f} outside ephemeris {ephem} coverage "
        f"[{lo:.1f}, {hi:.1f}]") for i in np.nonzero(bad)[0]]


def _ephem_span(ephem):
    """The MJD span ``ephem`` covers, or None for the analytic fallback or
    an ephemeris that does not load (the reference's
    ``_check_ephem_coverage``)."""
    from pint_torch.ephemeris import load_ephemeris

    try:
        return load_ephemeris(ephem).coverage_mjd()
    except Exception:
        return None


def run_toa_checks(batch, check_coverage: bool = True,
                   max_error_us: float = ABSURD_ERROR_US,
                   ephem: Optional[str] = None) -> QuarantineReport:
    """Run every check over a :class:`~pint_torch.toa.TOABatch` or a host
    :class:`~pint_torch.toa.TOAs`; returns the report (the caller's policy
    decides what it does with it).  ``ephem`` names the ephemeris whose
    coverage is checked, in place of the TOAs' own (whose span a batch
    carries)."""
    from pint_torch.toa import TOAs

    if isinstance(batch, TOAs):
        return _run_host_checks(batch, check_coverage, max_error_us, ephem)
    n = batch.ntoas
    mjd64 = np.asarray(batch.mjds, dtype=np.float64)
    mjd_lo = np.zeros(n) if batch.mjd_lo is None \
        else np.asarray(batch.mjd_lo, dtype=np.float64)
    mjd_lo = np.where(np.isfinite(mjd_lo), mjd_lo, 0.0)
    err_us = batch.error_us.detach().cpu().numpy()
    freq = batch.freq.detach().cpu().numpy()
    obs = np.full(n, "", dtype=object) if batch.obs is None \
        else np.asarray(batch.obs)
    findings: List[QuarantineFinding] = []
    findings += _check_mjds(mjd64)
    findings += _check_errors(err_us, max_error_us)
    findings += _check_freqs(freq)
    findings += _check_duplicates(mjd64, mjd_lo, obs, freq)
    cov = batch.coverage or {}
    if check_coverage:
        findings += _check_clock_coverage(mjd64, obs,
                                          cov.get("clock_end") or {})
        if ephem:
            span = _ephem_span(str(ephem))
        else:
            ephem, span = batch.ephem, cov.get("ephem_span")
        if ephem and span is not None:
            findings += _check_ephem_coverage(mjd64, ephem, span)
    findings.sort(key=lambda f: (f.index, f.code))
    return QuarantineReport(n_toas=n, findings=findings)


def _run_host_checks(toas, check_coverage, max_error_us, ephem):
    """:func:`run_toa_checks` over host TOAs (reference
    ``quarantine.py:253``): the clock chains' ends from the observatories,
    the ephemeris span from the ephemeris."""
    from pint_torch.observatory import get_observatory

    mjd64 = np.asarray(toas.utc_mjd, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        mjd_lo = np.asarray(np.asarray(toas.utc_mjd)
                            - mjd64.astype(np.longdouble), dtype=np.float64)
    mjd_lo = np.where(np.isfinite(mjd_lo), mjd_lo, 0.0)
    if toas.utc_mjd_lo is not None:
        mjd_lo = mjd_lo + np.asarray(toas.utc_mjd_lo, dtype=np.float64)
    err_us = np.asarray(toas.error_us, dtype=np.float64)
    freq = np.asarray(toas.freq_mhz, dtype=np.float64)
    obs = np.asarray(toas.obs)
    findings: List[QuarantineFinding] = []
    findings += _check_mjds(mjd64)
    findings += _check_errors(err_us, max_error_us)
    findings += _check_freqs(freq)
    findings += _check_duplicates(mjd64, mjd_lo, obs, freq)
    if check_coverage:
        clock_end = {}
        for site in np.unique(obs.astype(str)):
            try:
                clock_end[site] = float(get_observatory(
                    site).last_clock_correction_mjd(limits="allow"))
            except Exception:
                continue  # no clock chain for this site: nothing to cover
        findings += _check_clock_coverage(mjd64, obs, clock_end)
        eph = ephem or toas.ephem
        span = _ephem_span(str(eph)) if eph else None
        if span is not None:
            findings += _check_ephem_coverage(mjd64, str(eph), span)
    findings.sort(key=lambda f: (f.index, f.code))
    return QuarantineReport(n_toas=len(mjd64), findings=findings)
