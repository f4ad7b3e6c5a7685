"""Logging setup for pint_torch (a copy of ``pint_tpu/logging.py``).

The surface the reference offers -- ``setup(level)``, dedup of repeated
messages, warning capture, the -v/-q level map -- on top of the stdlib
``logging`` module, under the ``pint_torch`` logger name.
"""

from __future__ import annotations

import logging as _logging
import sys
import warnings

__all__ = ["setup", "log", "levels", "LogFilter", "showwarning",
           "capture_warnings", "get_level"]

levels = ["TRACE", "DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"]

log = _logging.getLogger("pint_torch")


class LogFilter(_logging.Filter):
    """Filter that suppresses duplicate messages: messages starting with
    an entry of ``onlyonce`` (every message with ``dedup_all``) are
    emitted a single time per process."""

    def __init__(self, onlyonce: list[str] | None = None,
                 dedup_all: bool = False):
        super().__init__()
        self.onlyonce = set(onlyonce or [])
        self.dedup_all = dedup_all
        self._seen: set[str] = set()

    def filter(self, record: _logging.LogRecord) -> bool:  # noqa: A003
        msg = record.getMessage()
        if self.dedup_all or any(msg.startswith(o) for o in self.onlyonce):
            if msg in self._seen:
                return False
            self._seen.add(msg)
        return True


_DEFAULT_ONLYONCE = [
    "Using EPHEM =",
    "Using CLK =",
    "Using UNITS =",
    "No pulse number flags found",
    "SSB obs pos",
    "Setting pulse numbers",
    "Clock file",
    "Using built-in analytic solar-system ephemeris",
]

_configured = False


def setup(level: str = "INFO", usecolors: bool = True,
          dedup: bool = True) -> int:
    """Configure the pint_torch logger; returns the handler's id."""
    global _configured
    for h in list(log.handlers):
        log.removeHandler(h)
    handler = _logging.StreamHandler(sys.stderr)
    fmt = "%(asctime)s %(levelname)-8s %(name)s %(message)s"
    handler.setFormatter(_logging.Formatter(fmt, datefmt="%H:%M:%S"))
    if dedup:
        handler.addFilter(LogFilter(onlyonce=_DEFAULT_ONLYONCE))
    log.addHandler(handler)
    log.setLevel(getattr(_logging, level if level != "TRACE" else "DEBUG"))
    log.propagate = False
    if not _configured:
        _logging.captureWarnings(False)
        _configured = True
    return id(handler)


def showwarning(message, category, filename, lineno, file=None, line=None):
    """``warnings.showwarning`` replacement routing through this logger;
    installed by :func:`capture_warnings`."""
    name = category.__name__ if category else "Warning"
    log.warning(f"{name}: {message} ({filename}:{lineno})")


def capture_warnings(enable: bool = True) -> None:
    """Route Python warnings through the pint_torch logger."""
    if enable:
        warnings.showwarning = showwarning
    else:
        warnings.showwarning = warnings._showwarning_orig  # type: ignore[attr-defined]


setup("WARNING")


def get_level(starting_level_name: str, verbosity: int, quietness: int) -> str:
    """Map a base level and -v/-q counts to a level name (used by
    command-line scripts)."""
    start = levels.index(starting_level_name) \
        if starting_level_name in levels else levels.index("INFO")
    return levels[min(max(start - verbosity + quietness, 0), len(levels) - 1)]
