"""Catalog ingestion: many pulsars through one integrity gate (port of
``pint_tpu/catalog/ingest.py:42-200``).

Every member runs :meth:`pint_torch.toa.TOABatch.validate` (lenient by
default: offenders are quarantined with a warning and never reach a fit)
and the catalog keeps its certified rows only; a member left with fewer
certified TOAs than free parameters + 1 is excluded with a reason, since a
singular block would poison the joint solve.  Entries are ``(par, tim)``
path pairs, read by :func:`pint_torch.models.get_model_and_toas` and
validated on the host as the reference validates them, or ``(model,
TOABatch)`` pairs, as :func:`pint_torch.bridge.load_catalog_snapshot`
returns them.  The reference's ``make_synthetic_catalog``
simulates TOAs (item 11) and is not ported; the ``catalog_ingest``
telemetry event waits for item 8.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

from pint_torch.fitter import UsageError

__all__ = ["CatalogPulsar", "CatalogIngestReport", "ingest_catalog"]


@dataclass
class CatalogPulsar:
    """One array member that passed the gate: certified TOAs only."""

    name: str
    model: object
    toas: object                      #: certified TOABatch
    n_quarantined: int = 0            #: rows the gate removed
    quarantine_codes: Tuple[str, ...] = ()
    _fitter: object = field(default=None, repr=False, compare=False)

    @property
    def n_toas(self) -> int:
        return self.toas.ntoas

    @property
    def n_free(self) -> int:
        return len(self.model.free_params)

    @property
    def fitter(self):
        """The member's :class:`~pint_torch.gls_fitter.GLSFitter`, built at
        first use (its residual state lives there across the catalog
        fit's iterations)."""
        if self._fitter is None:
            from pint_torch.gls_fitter import GLSFitter

            self._fitter = GLSFitter(self.toas, self.model)
        return self._fitter

    @property
    def fitted_model(self):
        """The fitter's working model, where the batched fit's steps land
        (the ingest ``model`` stays as it was)."""
        return self.fitter.model

    def shape(self) -> Tuple[int, int]:
        """(n_toas, n_free + noise-basis columns) of the member's linearized
        system."""
        from pint_torch.serving.batcher import FitRequest

        req = FitRequest.from_fitter(self.fitter)
        return (req.n_toas, req.n_free)


@dataclass
class CatalogIngestReport:
    """Outcome of one :func:`ingest_catalog` pass."""

    pulsars: List[CatalogPulsar] = field(default_factory=list)
    #: (name, reason) of the members excluded entirely
    excluded: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def n_pulsars(self) -> int:
        return len(self.pulsars)

    @property
    def n_toas(self) -> int:
        return sum(p.n_toas for p in self.pulsars)

    @property
    def n_quarantined(self) -> int:
        return sum(p.n_quarantined for p in self.pulsars)

    def codes(self) -> List[str]:
        return sorted({c for p in self.pulsars for c in p.quarantine_codes})

    def to_dict(self) -> dict:
        return {
            "n_pulsars": self.n_pulsars,
            "n_toas": self.n_toas,
            "n_quarantined": self.n_quarantined,
            "quarantined_pulsars": len(self.excluded),
            "codes": self.codes(),
            "excluded": [list(e) for e in self.excluded],
        }

    def render(self) -> str:
        head = (f"catalog ingest: {self.n_pulsars} pulsar(s), "
                f"{self.n_toas} certified TOA(s), "
                f"{self.n_quarantined} row(s) quarantined")
        body = [f"  excluded {name}: {reason}"
                for name, reason in self.excluded]
        return "\n".join([head] + body)


def ingest_catalog(entries: Sequence, policy: str = "lenient",
                   check_coverage: bool = False,
                   device=None) -> CatalogIngestReport:
    """Load a catalog of ``(par, tim)`` path pairs or ``(model, TOABatch)``
    pairs through the integrity gate: each member's TOAs are validated
    under ``policy`` (a file pair's host TOAs, as the reference's), its
    certified rows kept (as a TOA set of their own, as the reference's
    ``toas.certified()``; a file pair's made a batch on ``device``,
    default ``"cuda"``), and a member with fewer certified TOAs than free
    parameters + 1 excluded with a reason."""
    if not len(entries):
        raise UsageError("ingest_catalog needs at least one pulsar entry")
    report = CatalogIngestReport()
    for i, entry in enumerate(entries):
        if not isinstance(entry, (tuple, list)) or len(entry) != 2:
            raise UsageError(
                f"catalog entry {i} must be a (par, tim) or (model, toas) "
                f"pair, got {type(entry).__name__}")
        model, toas = entry
        files = isinstance(model, (str, os.PathLike)) \
            and isinstance(toas, (str, os.PathLike))
        if files:
            from pint_torch.models import get_model_and_toas

            model, toas = get_model_and_toas(str(model), str(toas),
                                             device=device)
        psr = model.params_table.get("PSR")
        name = str((psr.value if psr is not None else None)
                   or f"PSR{i:04d}")
        q = toas.validate(policy=policy, check_coverage=check_coverage)
        certified = toas.certified() if files \
            else toas.certified(model)
        n_q = int(q.n_quarantined) if q else 0
        codes = tuple(q.codes()) if q else ()
        n_free = len(model.free_params)
        n_cert = len(certified) if files else certified.ntoas
        if n_cert < n_free + 1:
            report.excluded.append(
                (name, f"{n_cert} certified TOA(s) cannot "
                       f"constrain {n_free} free parameter(s)"))
            continue
        if files:
            certified = certified.to_batch(device=model.device, model=model)
        report.pulsars.append(CatalogPulsar(
            name=name, model=model, toas=certified,
            n_quarantined=n_q, quarantine_codes=codes))
    if not report.pulsars:
        raise UsageError(
            "every catalog entry was excluded by the integrity gate:\n"
            + "\n".join(f"  {n}: {r}" for n, r in report.excluded))
    return report
