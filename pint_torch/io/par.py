"""Par-file parsing and formatting (port of ``pint_tpu/io/par.py``), with
fortran-style ``D`` exponents, repeated keys (JUMP/EFAC lines), fit flags
and uncertainties.  The result is an ordered multi-dict of raw string fields; interpretation (units, aliases,
component mapping) happens in :mod:`pint_torch.models.model_builder`.

Parsing runs under the ingestion policy (:func:`pint_torch.config.
ingestion_policy`): ``strict`` raises a typed
:class:`~pint_torch.exceptions.ParSyntaxError` carrying file/line/column on
the first malformed line, ``lenient`` records a
:class:`~pint_torch.integrity.Diagnostics` entry (logged) and keeps the good
lines, ``collect`` records silently.  The returned mapping is a
:class:`ParFileDict` whose ``.diagnostics`` attribute holds the report.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, List, Optional

from pint_torch.exceptions import ParSyntaxError

__all__ = ["parse_parfile", "format_parfile", "fortran_float", "ParLine",
           "ParFileDict", "REPEATABLE_KEYS"]

_FORTRAN_RE = re.compile(r"([0-9.+\-]+)[DdE]([+\-]?[0-9]+)")

#: par keys that legitimately repeat (mask-parameter families); any other
#: repeated key is a duplicate-key diagnostic
REPEATABLE_KEYS = frozenset({
    "JUMP", "EFAC", "EQUAD", "ECORR", "T2EFAC", "T2EQUAD", "TNECORR",
    "TNEF", "TNEQ", "DMEFAC", "DMEQUAD", "DMJUMP", "FDJUMP",
})

#: a plausible par-file key: letters/digits/underscore/+-., starting with
#: a letter or underscore (F0, DMX_0001, A1DOT, NE_SW, ...)
_KEY_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_+\-.:]*$")


def fortran_float(s: str) -> float:
    """Parse a float allowing fortran 'D' exponents (e.g. -1.181D-15).

    Garbage raises a typed :class:`~pint_torch.exceptions.ParSyntaxError`
    naming the offending token (never a bare ``ValueError``)."""
    try:
        return float(s.translate(str.maketrans("Dd", "Ee")))
    except (ValueError, TypeError, AttributeError) as e:
        raise ParSyntaxError("unparseable numeric value",
                             token=str(s)) from e


class ParFileDict(OrderedDict):
    """``{KEY: [ParLine, ...]}`` multi-dict plus the ingestion
    :class:`~pint_torch.integrity.Diagnostics` report (``.diagnostics``)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.diagnostics = None


class ParLine:
    """One par-file entry: key + raw fields (value, fit flag, uncertainty)."""

    __slots__ = ("key", "fields", "line")

    def __init__(self, key: str, fields: List[str],
                 line: Optional[int] = None):
        self.key = key
        self.fields = fields
        self.line = line  # 1-based source line, None for programmatic input

    @property
    def value(self) -> Optional[str]:
        return self.fields[0] if self.fields else None

    @property
    def fit(self) -> bool:
        """True when the tempo-style fit flag ('1') is present."""
        return len(self.fields) >= 2 and self.fields[1] == "1"

    @property
    def uncertainty(self) -> Optional[str]:
        if len(self.fields) >= 3:
            return self.fields[2]
        # two-field form "KEY value uncertainty" only when field2 is not a flag
        if len(self.fields) == 2 and self.fields[1] not in ("0", "1"):
            return self.fields[1]
        return None

    def __repr__(self):
        return f"ParLine({self.key}, {self.fields})"


def parse_parfile(path_or_lines, policy: Optional[str] = None,
                  diagnostics=None) -> "ParFileDict":
    """Parse a par file into an ordered {KEY: [ParLine, ...]} multi-dict.

    Accepts a filesystem path, a multi-line par-file string, or an iterable
    of lines.  Keys are uppercased; repeated keys (JUMP, EFAC, multiple
    glitches) accumulate in order.  ``policy`` overrides the process-wide
    ingestion policy; the returned dict carries ``.diagnostics``.
    """
    from pint_torch.config import ingestion_policy
    from pint_torch.integrity.diagnostics import Diagnostics

    policy = policy or ingestion_policy()
    source = None
    if isinstance(path_or_lines, str):
        if "\n" in path_or_lines:
            lines = path_or_lines.splitlines()
        else:
            source = path_or_lines
            with open(path_or_lines) as f:
                lines = f.readlines()
    else:
        lines = list(path_or_lines)
    diags = diagnostics if diagnostics is not None else Diagnostics(source)
    quiet = policy == "collect"
    out = ParFileDict()
    out.diagnostics = diags
    for lineno, raw in enumerate(lines, start=1):
        line = raw.split("#")[0].strip()
        if not line or line.startswith(("C ", "%")):
            continue
        fields = line.split()
        key = fields[0].upper()
        column = raw.find(fields[0]) + 1
        if not _KEY_RE.match(key):
            if policy == "strict":
                raise ParSyntaxError(f"invalid par-file key {key!r}",
                                     file=source, line=lineno, column=column,
                                     token=key)
            diags.error("par-invalid-key",
                        f"invalid par-file key {key!r}; line skipped",
                        line=lineno, column=column, quiet=quiet)
            continue
        if not fields[1:]:
            diags.warning("par-empty-value",
                          f"key {key} has no value", line=lineno,
                          column=column, quiet=quiet)
        if key in out and key not in REPEATABLE_KEYS:
            diags.warning(
                "par-duplicate-key",
                f"duplicate key {key} (first at line "
                f"{out[key][0].line if out[key][0].line else '?'}); "
                f"both entries kept", line=lineno, column=column, quiet=quiet)
        out.setdefault(key, []).append(ParLine(key, fields[1:], line=lineno))
    return out


def format_parfile(entries: Dict[str, List[List[str]]]) -> str:
    """Format {KEY: [[fields...], ...]} back into par-file text."""
    lines = []
    for key, rows in entries.items():
        for fields in rows:
            lines.append(" ".join([f"{key:<15}"] + [str(f) for f in fields]).rstrip())
    return "\n".join(lines) + "\n"
