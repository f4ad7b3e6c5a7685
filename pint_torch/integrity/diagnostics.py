"""Structured ingestion diagnostics (port of
``pint_tpu/integrity/diagnostics.py``).

A :class:`Diagnostics` report accumulates every problem the validating
ingestion path (``io/par.py``, ``io/tim.py``, ``TOAs.validate``) finds,
each pinned to its source location.  Under the ``strict`` ingestion policy
the first *error*-severity entry raises a typed exception instead; under
``lenient`` entries are recorded (warnings logged once each); under
``collect`` everything is recorded silently so a caller can audit the
whole file in one pass (the tempo2 read-time discipline: suspect input is
rejected or flagged before it can reach a fit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from pint_torch.exceptions import UsageError
from pint_torch.logging import log

__all__ = ["Diagnostic", "Diagnostics"]

#: severity levels, mildest first
SEVERITIES = ("info", "warning", "error")


@dataclass(frozen=True)
class Diagnostic:
    """One ingestion finding: where it is, how bad it is, what it says."""

    severity: str  # info | warning | error
    code: str      # short machine-readable slug, e.g. "tim-unknown-line"
    message: str
    file: Optional[str] = None
    line: Optional[int] = None   # 1-based
    column: Optional[int] = None  # 1-based

    def render(self) -> str:
        where = self.file or "<input>"
        if self.line is not None:
            where += f":{self.line}"
            if self.column is not None:
                where += f":{self.column}"
        return f"[{self.severity}] {where}: {self.message} ({self.code})"


class Diagnostics:
    """Ordered accumulator of :class:`Diagnostic` records for one ingestion
    pass.  Mutable and cheap; attach it to the parse result so callers can
    audit what lenient mode skipped."""

    def __init__(self, source: Optional[str] = None):
        self.source = source
        self.records: List[Diagnostic] = []

    # -- recording ----------------------------------------------------------
    def add(self, severity: str, code: str, message: str,
            file: Optional[str] = None, line: Optional[int] = None,
            column: Optional[int] = None, quiet: bool = False) -> Diagnostic:
        if severity not in SEVERITIES:
            raise UsageError(f"severity must be one of {SEVERITIES}")
        d = Diagnostic(severity, code, message, file or self.source, line,
                       column)
        self.records.append(d)
        if not quiet and severity != "info":
            log.warning(d.render())
        return d

    def info(self, code, message, **kw):
        return self.add("info", code, message, **kw)

    def warning(self, code, message, **kw):
        return self.add("warning", code, message, **kw)

    def error(self, code, message, **kw):
        return self.add("error", code, message, **kw)

    # -- inspection ---------------------------------------------------------
    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.records if d.severity == "warning"]

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.records if d.severity == "error"]

    def codes(self) -> List[str]:
        return [d.code for d in self.records]

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def __bool__(self) -> bool:
        # truthiness means "something was found", so `if diags:` reads right
        return bool(self.records)

    def extend(self, other: "Diagnostics") -> "Diagnostics":
        self.records.extend(other.records)
        return self

    def render(self) -> str:
        head = f"Ingestion diagnostics for {self.source or '<input>'}: " \
               f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)"
        return "\n".join([head] + ["  " + d.render() for d in self.records])

    def __repr__(self) -> str:
        return (f"<Diagnostics {self.source or '<input>'}: "
                f"{len(self.errors)}E/{len(self.warnings)}W>")
