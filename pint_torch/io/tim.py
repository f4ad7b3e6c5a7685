"""Tim-file reading and writing (port of ``pint_tpu/io/tim.py``): tempo2,
Princeton, Parkes and ITOA lines, and the commands FORMAT, MODE, TIME,
PHASE, EFAC, EQUAD, EMIN, EMAX, FMIN, FMAX, SKIP/NOSKIP, INFO, JUMP (toggle
pairs -> per-TOA 'jump'/'tim_jump' flags), INCLUDE (recursive) and END.
MJDs are carried as exact (int day, decimal fraction string) pairs so no
precision is lost before the double-double conversion.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from pint_torch.exceptions import TimSyntaxError
from pint_torch.logging import log

__all__ = ["RawTOA", "read_tim_file", "format_toa_line"]

#: FORMAT directive arguments this reader understands ("1" = tempo2,
#: "0" = tempo1 heuristics); anything else is an unrecognized directive
_KNOWN_FORMATS = ("0", "1")

_COMMANDS = {
    "FORMAT", "MODE", "TIME", "PHASE", "EFAC", "EQUAD", "EMIN", "EMAX",
    "FMIN", "FMAX", "SKIP", "NOSKIP", "INFO", "JUMP", "INCLUDE", "END",
    "TRACK", "PHA1", "PHA2",
}


@dataclass
class RawTOA:
    """One TOA as read from disk, before any corrections."""

    mjd_int: int
    mjd_frac_str: str  # decimal fraction as string, full precision
    error_us: float
    freq_mhz: float
    obs: str
    name: str = ""
    flags: Dict[str, str] = field(default_factory=dict)

    @property
    def mjd_float(self) -> float:
        return self.mjd_int + float("0." + self.mjd_frac_str)

    def mjd_longdouble(self) -> np.longdouble:
        return np.longdouble(self.mjd_int) + np.longdouble("0." + self.mjd_frac_str)


def _split_mjd(field_str: str) -> Tuple[int, str]:
    if "." in field_str:
        ii, ff = field_str.split(".")
        return int(ii), ff or "0"
    return int(field_str), "0"


def _classify(line: str, current_fmt: str, path: Optional[str] = None,
              lineno: Optional[int] = None, policy: Optional[str] = None,
              diagnostics=None) -> str:
    """Classify one tim line: Blank/Comment/Command/Tempo2/Princeton/
    Parkes/ITOA/Unknown.

    With ``policy``/``path``/``lineno`` context (the ``read_tim_file``
    call path), a mode-less line — one no format heuristic matches — is no
    longer an ambiguous silent fall-through: ``strict`` raises a
    :class:`~pint_torch.exceptions.TimSyntaxError` carrying file and line
    number, ``lenient``/``collect`` record a diagnostic and return
    ``"Unknown"`` (the caller skips the line).  Without context the
    classification is pure (back-compat for direct callers)."""
    s = line.strip()
    if not s:
        return "Blank"
    if line.startswith(("#", "%", "CC ")) or line.startswith("C "):
        return "Comment"
    first = s.split()[0].upper()
    if first in _COMMANDS:
        return "Command"
    if current_fmt == "Tempo2":
        return "Tempo2"
    # Princeton: single-char observatory code in column 1, column 2 blank
    if len(line) > 45 and line[1] == " " and not line[0].isspace():
        return "Princeton"
    if len(line) > 71 and line[0] == " " and line[41] == ".":
        return "Parkes"
    if len(line) > 80:
        # long lines are tempo2 even without FORMAT 1 (reference toa.py:462,
        # checked BEFORE the ITOA heuristic so it cannot over-match)
        return "Tempo2"
    # ITOA: two-char site code then MJD with the decimal point at col 15
    # (reference ``toa.py:464``; the reference also refuses these lines)
    if (len(line) > 14 and line[14] == "." and len(s) > 1
            and not line[0].isspace() and not line[1].isspace()):
        return "ITOA"
    if policy is not None:
        msg = (f"unrecognized TOA line (no tempo2/Princeton/Parkes/ITOA "
               f"layout matches): {s[:60]!r}")
        if policy == "strict":
            raise TimSyntaxError(msg, file=path, line=lineno)
        if diagnostics is not None:
            diagnostics.error("tim-unknown-line", msg + "; line skipped",
                              file=path, line=lineno,
                              quiet=policy == "collect")
    return "Unknown"


def _parse_tempo2(line: str) -> RawTOA:
    fields = line.split()
    if len(fields) < 5:
        raise TimSyntaxError(f"Malformed tempo2 TOA line: {line!r}")
    try:
        ii, ff = _split_mjd(fields[2])
        toa = RawTOA(
            mjd_int=ii, mjd_frac_str=ff, error_us=float(fields[3]),
            freq_mhz=float(fields[1]), obs=fields[4], name=fields[0],
        )
    except ValueError as e:
        raise TimSyntaxError(
            f"Malformed tempo2 TOA line (unparseable number): {line!r}") \
            from e
    flagfields = fields[5:]
    if len(flagfields) % 2 != 0:
        raise TimSyntaxError(
            f"Flags must come in -key value pairs: {flagfields}")
    for i in range(0, len(flagfields), 2):
        k = flagfields[i].lstrip("-")
        if not k or not flagfields[i].startswith("-"):
            raise TimSyntaxError(f"Invalid flag {flagfields[i]!r}",
                                 token=flagfields[i])
        if k in ("error", "freq", "scale", "MJD", "flags", "obs", "name"):
            raise TimSyntaxError(
                f"TOA flag {k!r} would overwrite a TOA column", token=k)
        toa.flags[k] = flagfields[i + 1]
    return toa


def _parse_princeton(line: str) -> RawTOA:
    try:
        ii_str, ff = line[24:44].strip().split(".")
        ii = int(ii_str)
        if ii < 40000:  # two-digit-year era convention
            ii += 39126
        toa = RawTOA(
            mjd_int=ii, mjd_frac_str=ff or "0",
            error_us=float(line[44:53]), freq_mhz=float(line[15:24]),
            obs=line[0].upper(),
        )
    except ValueError as e:
        raise TimSyntaxError(f"Malformed Princeton TOA line: {line!r}") from e
    try:
        ddm = float(line[68:78])
        if ddm != 0.0:
            toa.flags["ddm"] = str(ddm)
    except (ValueError, IndexError):
        pass
    return toa


def _parse_itoa(line: str) -> RawTOA:
    """ITOA format (tempo convention; layout confirmed against the
    reference test file ``tests/datafile/NGC6440E.itoa``):

    .. code-block:: text

        columns  item
        1-9      source name
        10-28    TOA (decimal point in column 15)
        30-35    TOA uncertainty (us)
        36-45    observing frequency (MHz)
        46-55    DM correction (pc cm^-3)
        58-59    observatory (two-character ITOA code)

    The reference *detects* these lines but raises "not implemented yet"
    (``toa.py:557``, ``tests/test_toa_reader.py:648``); parsing them here
    closes that documented input-format gap.
    """
    name = line[:9].strip()
    mjd_field = line[9:28].strip()
    if "." not in mjd_field or len(line) < 59:
        raise TimSyntaxError(f"Malformed ITOA TOA line: {line!r}")
    try:
        ii, ff = _split_mjd(mjd_field)
        # fixed columns, like _parse_princeton/_parse_parkes: adjacent
        # full-width fields carry no separating whitespace
        error_us = float(line[29:35])
        freq_mhz = float(line[35:45])
        ddm = float(line[45:55])
        obs = line[57:59].strip().upper()
    except ValueError as e:
        raise TimSyntaxError(f"Malformed ITOA TOA line: {line!r}") from e
    if not obs:
        raise TimSyntaxError(f"ITOA TOA line has no observatory: {line!r}")
    toa = RawTOA(mjd_int=ii, mjd_frac_str=ff, error_us=error_us,
                 freq_mhz=freq_mhz, obs=obs, name=name)
    if ddm != 0.0:
        toa.flags["ddm"] = str(ddm)
    return toa


def _parse_parkes(line: str) -> RawTOA:
    try:
        ii = int(line[34:41])
        ff = line[42:55].strip()
        phaseoffset = float(line[55:62])
    except ValueError as e:
        raise TimSyntaxError(f"Malformed Parkes TOA line: {line!r}") from e
    if phaseoffset != 0:
        raise TimSyntaxError("Parkes-format phase offsets are not supported")
    try:
        return RawTOA(
            mjd_int=ii, mjd_frac_str=ff or "0",
            error_us=float(line[63:71]), freq_mhz=float(line[25:34]),
            obs=line[79].upper(), name=line[1:25].strip(),
        )
    except (ValueError, IndexError) as e:
        raise TimSyntaxError(f"Malformed Parkes TOA line: {line!r}") from e


_PARSERS = {"Tempo2": _parse_tempo2, "Princeton": _parse_princeton,
            "ITOA": _parse_itoa, "Parkes": _parse_parkes}


def read_tim_file(path: str, process_includes: bool = True,
                  _state: Optional[dict] = None,
                  policy: Optional[str] = None,
                  diagnostics=None) -> Tuple[List[RawTOA], List]:
    """Read a tim file, applying commands; returns (toas, commands).

    Runs under the ingestion policy (``policy`` overrides
    :func:`pint_torch.config.ingestion_policy`): ``strict`` raises a
    :class:`~pint_torch.exceptions.TimSyntaxError` pinned to file and line
    on the first malformed TOA line, unparseable command, unrecognized
    FORMAT directive, or mode-less line; ``lenient`` records each problem
    on ``diagnostics`` (a :class:`~pint_torch.integrity.Diagnostics`,
    created internally when not supplied), skips the offending line, and
    keeps every good row; ``collect`` records silently.
    """
    from pint_torch.config import ingestion_policy
    from pint_torch.integrity.diagnostics import Diagnostics

    policy = policy or ingestion_policy()
    diags = diagnostics if diagnostics is not None else Diagnostics(path)
    quiet = policy == "collect"
    top = _state is None
    cd = _state if _state is not None else {
        "FORMAT": "Unknown", "EFAC": 1.0, "EQUAD": 0.0, "EMIN": 0.0,
        "EMAX": np.inf, "FMIN": 0.0, "FMAX": np.inf, "INFO": None,
        "SKIP": False, "TIME": 0.0, "PHASE": 0.0, "JUMP": [False, 0],
        "END": False,
    }
    toas: List[RawTOA] = []
    commands: List = []
    with open(path) as f:
        lines = f.readlines()
    for lineno, line in enumerate(lines, start=1):
        # classification is policy-silent here: SKIP/END regions may hold
        # arbitrary garbage on purpose, so unknown-line handling waits
        # until we know the line would actually be consumed
        kind = _classify(line, cd["FORMAT"])
        if kind in ("Blank", "Comment"):
            continue
        if kind == "Command":
            fields = line.split()
            cmd = fields[0].upper()
            commands.append((fields, len(toas)))
            try:
                if cmd == "SKIP":
                    cd["SKIP"] = True
                elif cmd == "NOSKIP":
                    cd["SKIP"] = False
                elif cmd == "END":
                    cd["END"] = True
                    if top:
                        break
                elif cmd in ("TIME", "PHASE"):
                    cd[cmd] += float(fields[1])
                elif cmd in ("EMIN", "EMAX", "FMIN", "FMAX", "EFAC", "EQUAD"):
                    cd[cmd] = float(fields[1])
                elif cmd == "INFO":
                    cd[cmd] = fields[1]
                elif cmd == "FORMAT":
                    if fields[1] not in _KNOWN_FORMATS:
                        msg = (f"unrecognized FORMAT directive "
                               f"{fields[1]!r} (known: {_KNOWN_FORMATS})")
                        if policy == "strict":
                            raise TimSyntaxError(msg, file=path, line=lineno,
                                                 token=fields[1])
                        diags.error("tim-unknown-format",
                                    msg + "; falling back to tempo1 "
                                    "heuristics", file=path, line=lineno,
                                    quiet=quiet)
                    cd[cmd] = "Tempo2" if fields[1] == "1" else "Unknown"
                elif cmd == "JUMP":
                    if cd["JUMP"][0]:
                        cd["JUMP"] = [False, cd["JUMP"][1] + 1]
                    else:
                        cd["JUMP"] = [True, cd["JUMP"][1]]
                elif cmd == "MODE":
                    if fields[1] != "1":
                        log.warning("MODE %s is not supported; ignored"
                                    % fields[1])
                        diags.warning("tim-unsupported-mode",
                                      f"MODE {fields[1]} is not supported; "
                                      "ignored", file=path, line=lineno,
                                      quiet=True)
                elif cmd == "INCLUDE" and process_includes:
                    sub = os.path.join(os.path.dirname(path), fields[1])
                    fmt_save, cd["FORMAT"] = cd["FORMAT"], "Unknown"
                    sub_toas, sub_cmds = read_tim_file(
                        sub, _state=cd, policy=policy, diagnostics=diags)
                    toas.extend(sub_toas)
                    commands.extend(sub_cmds)
                    cd["FORMAT"] = fmt_save
                else:
                    log.warning(f"Unknown tim command ignored: {line.strip()}")
                    diags.warning("tim-unknown-command",
                                  f"unknown command {cmd} ignored",
                                  file=path, line=lineno, quiet=True)
            except TimSyntaxError:
                # already typed and located (e.g. the strict-mode
                # unrecognized-FORMAT raise above): never re-wrap it as a
                # generic bad-command failure (TimSyntaxError is also a
                # ValueError, so the next clause would otherwise catch it)
                raise
            except (ValueError, IndexError) as e:
                msg = f"malformed {cmd} command: {line.strip()!r} ({e})"
                if policy == "strict":
                    raise TimSyntaxError(msg, file=path,
                                         line=lineno) from e
                diags.error("tim-bad-command", msg + "; command ignored",
                            file=path, line=lineno, quiet=quiet)
            continue
        if cd["SKIP"] or cd["END"]:
            continue
        if kind == "Unknown":
            # re-classify with full context: strict raises, lenient/collect
            # record the diagnostic (the satellite-task seam lives in
            # _classify so direct callers get the same treatment)
            _classify(line, cd["FORMAT"], path=path, lineno=lineno,
                      policy=policy, diagnostics=diags)
            continue
        try:
            toa = _PARSERS[kind](line)
        except TimSyntaxError as e:
            if policy == "strict":
                if e.line is None:
                    raise TimSyntaxError(str(e), file=path,
                                         line=lineno) from e
                raise
            diags.error("tim-bad-toa-line", f"{e}; line skipped",
                        file=path, line=lineno, quiet=quiet)
            continue
        if not (cd["EMIN"] <= toa.error_us <= cd["EMAX"]):
            continue
        if not (cd["FMIN"] <= toa.freq_mhz <= cd["FMAX"]):
            continue
        toa.error_us = float(np.hypot(toa.error_us * cd["EFAC"], cd["EQUAD"]))
        if cd["INFO"]:
            toa.flags.setdefault("info", cd["INFO"])
        if cd["JUMP"][0]:
            toa.flags["jump"] = str(cd["JUMP"][1] + 1)
            toa.flags["tim_jump"] = str(cd["JUMP"][1] + 1)
        if cd["PHASE"] != 0:
            toa.flags["phase"] = str(cd["PHASE"])
        if cd["TIME"] != 0.0:
            toa.flags["to"] = str(cd["TIME"])
        toas.append(toa)
    return toas, commands


def format_toa_line(mjd_int: int, mjd_frac_str: str, error_us: float,
                    freq_mhz: float, obs: str, name: str = "unk",
                    flags: Optional[Dict[str, str]] = None,
                    fmt: str = "tempo2") -> str:
    """Format one TOA line (reference ``toa.py:566``)."""
    if fmt.lower() in ("tempo2", "1"):
        mjd_str = f"{mjd_int}.{mjd_frac_str}"
        out = f"{name or 'unk'} {freq_mhz:.6f} {mjd_str} {error_us:.3f} {obs}"
        for k, v in (flags or {}).items():
            out += f" -{k} {v}"
        return out + "\n"
    # Princeton
    mjd_str = f"{mjd_int}.{mjd_frac_str[:13]:<13}"
    return f"{obs:1s}{'':14s}{freq_mhz:9.3f} {mjd_str:<20s}{error_us:8.2f}\n"
