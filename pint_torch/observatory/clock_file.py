"""Clock-correction file readers: tempo ``time.dat`` and tempo2 ``.clk``.

Native counterpart of reference ``observatory/clock_file.py:25,441,566``.
A :class:`ClockFile` holds (mjd, clock_correction_us) samples and evaluates
by linear interpolation, with a configurable out-of-range policy.  The
global-repository download machinery of the reference
(``global_clock_corrections.py``) is replaced by a search over local
directories (``$PINT_CLOCK_DIR``, package data) since deployment targets are
zero-egress; :func:`find_clock_file` returns a zero correction with a
one-time warning when no file is found.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from pint_torch.exceptions import ClockCorrectionOutOfRange, NoClockCorrections
from pint_torch.logging import log

__all__ = ["ClockFile", "GlobalClockFile", "read_tempo_clock_file",
           "read_tempo2_clock_file", "find_clock_file"]


class GlobalClockFile:
    """A clock file served from the global repository, refreshed on demand
    (reference ``clock_file.py:781``): evaluating past the end of the
    loaded data triggers an update check against the repository (the
    local-mirror transport of
    :mod:`pint_torch.observatory.global_clock_corrections`).

    Delegates everything else to the freshly parsed :class:`ClockFile`.
    """

    def __init__(self, filename: str, fmt: str = "tempo",
                 url_base=None, valid_beyond_ends: bool = False):
        self.filename = filename
        self.fmt = fmt
        self.url_base = url_base
        self.valid_beyond_ends = valid_beyond_ends
        path = self._fetch("if_missing")
        self._load(path)

    def _fetch(self, policy: str):
        from pint_torch.observatory.global_clock_corrections import (
            get_clock_correction_file)

        try:
            path = get_clock_correction_file(self.filename,
                                             download_policy=policy,
                                             url_base=self.url_base)
        except (KeyError, FileNotFoundError) as e:
            raise NoClockCorrections(
                f"Clock file {self.filename} not available: {e}") from e
        if path is None:
            raise NoClockCorrections(
                f"Clock file {self.filename} not available from the "
                "repository or local search directories")
        return path

    @staticmethod
    def _stat_sig(path):
        st = os.stat(path)
        return (str(path), st.st_mtime, st.st_size)

    def _load(self, path, file_hash=None):
        from pint_torch.utils import compute_hash

        self._path = path
        self._sig = self._stat_sig(path)
        self._hash = file_hash if file_hash is not None \
            else compute_hash(path)
        self.clock_file = ClockFile.read(
            path, fmt=self.fmt, valid_beyond_ends=self.valid_beyond_ends)

    def update(self) -> bool:
        """Refresh from the repository per its index policy; returns True
        when new data actually arrived (reference ``clock_file.py:828``)."""
        from pint_torch.utils import compute_hash

        path = self._fetch("if_expired")
        if self._stat_sig(path) == self._sig:
            return False  # same file, untouched: skip the content hash
        h = compute_hash(path)
        if h != self._hash:
            self._load(path, file_hash=h)
            return True
        self._sig = self._stat_sig(path)  # touched but identical content
        return False

    @property
    def mjd(self):
        return self.clock_file.mjd

    @property
    def clock_us(self):
        return self.clock_file.clock_us

    def last_correction_mjd(self) -> float:
        return self.clock_file.last_correction_mjd()

    @property
    def time(self):
        """Sample epochs of the loaded data (reference
        ``clock_file.py time``)."""
        return self.clock_file.mjd

    @property
    def clock(self):
        """Corrections [us] of the loaded data (reference
        ``clock_file.py clock``)."""
        return self.clock_file.clock_us

    @property
    def leading_comment(self) -> str:
        """Header line of the underlying file (reference
        ``clock_file.py leading_comment``)."""
        return getattr(self.clock_file, "hdrline", "")

    @property
    def comments(self) -> list:
        """Per-sample comments; the parsers here keep only the header, so
        this is empty placeholders (reference ``clock_file.py
        comments``)."""
        return [""] * len(self.clock_file.mjd)

    def export(self, filename: str) -> None:
        """Write the underlying clock file out (reference
        ``clock_file.py:903``)."""
        self.clock_file.export(filename)

    def evaluate(self, mjd, limits: str = "warn"):
        """Clock correction [s] at the given MJDs; requests past the end of
        the loaded data (or with no data loaded at all) first try to
        refresh from the repository.  A failed refresh falls back to the
        already-loaded data, which then applies its own out-of-range
        ``limits`` policy."""
        mjd_arr = np.atleast_1d(np.asarray(mjd, dtype=np.float64))
        needs_more = mjd_arr.size and (
            len(self.clock_file.mjd) == 0
            or mjd_arr.max() > self.clock_file.mjd[-1])
        if needs_more:
            try:
                self.update()
            except NoClockCorrections as e:
                _warn_once(self.filename, "refresh-failed",
                           f"Clock file {self.filename} could not be "
                           f"refreshed ({e}); using the loaded data")
        return self.clock_file.evaluate(mjd_arr, limits=limits)


class ClockFile:
    """Measured clock offsets vs MJD with linear-interpolation evaluation."""

    def __init__(self, mjd, clock_us, filename="", hdrline="", valid_beyond_ends=False):
        self.mjd = np.asarray(mjd, dtype=np.float64)
        self.clock_us = np.asarray(clock_us, dtype=np.float64)
        order = np.argsort(self.mjd, kind="stable")
        self.mjd, self.clock_us = self.mjd[order], self.clock_us[order]
        self.filename = filename
        self.hdrline = hdrline
        self.valid_beyond_ends = valid_beyond_ends

    @classmethod
    def read(cls, path: str, fmt: str = "tempo", **kw) -> "ClockFile":
        if fmt == "tempo2":
            return read_tempo2_clock_file(path, **kw)
        return read_tempo_clock_file(path, **kw)

    def evaluate(self, mjd, limits: str = "warn") -> np.ndarray:
        """Clock correction in seconds at the given MJD(s)."""
        mjd = np.atleast_1d(np.asarray(mjd, dtype=np.float64))
        if len(self.mjd) == 0:
            return np.zeros_like(mjd)
        out_of_range = (mjd < self.mjd[0]) | (mjd > self.mjd[-1])
        if np.any(out_of_range) and not self.valid_beyond_ends:
            msg = (
                f"Clock file {self.filename or '<unnamed>'} does not cover "
                f"MJD {mjd[out_of_range].min():.1f}..{mjd[out_of_range].max():.1f}"
            )
            if limits == "error":
                raise ClockCorrectionOutOfRange(msg)
            if self.filename:
                _warn_once(self.filename, "out-of-range", msg)
            elif not getattr(self, "_warned_out_of_range", False):
                # filename-less (programmatic) clock files dedup on a
                # per-INSTANCE flag: a shared "<unnamed>" key would let
                # the first such file swallow every other one's distinct
                # diagnostic, and an id(self)-based key could be
                # recycled onto a new instance after garbage collection
                self._warned_out_of_range = True
                log.warning(msg)
        return np.interp(mjd, self.mjd, self.clock_us) * 1e-6

    def last_correction_mjd(self) -> float:
        return float(self.mjd[-1]) if len(self.mjd) else -np.inf

    @property
    def time(self) -> np.ndarray:
        """Sample epochs, MJD (reference ``clock_file.py time``)."""
        return self.mjd

    @property
    def clock(self) -> np.ndarray:
        """Corrections [us] at the sample epochs (reference
        ``clock_file.py clock``)."""
        return self.clock_us

    @staticmethod
    def merge(clocks, trim: bool = True) -> "ClockFile":
        """Sum a chain of clock files into one (reference
        ``clock_file.py:195``): the merged corrections are the sum of the
        inputs evaluated on the union of their sample epochs; with
        ``trim`` the result covers only the overlap of all inputs."""
        clocks = list(clocks)
        if not clocks:
            raise ValueError("need at least one clock file")
        if any(len(c.mjd) == 0 for c in clocks):
            raise ValueError(
                "cannot merge: a clock file in the chain has no samples "
                f"({[c.filename for c in clocks if len(c.mjd) == 0]})")
        mjds = np.unique(np.concatenate([c.mjd for c in clocks]))
        if trim:
            lo = max(c.mjd[0] for c in clocks)
            hi = min(c.mjd[-1] for c in clocks)
            if lo > hi:
                raise ValueError(
                    "cannot merge: clock files do not overlap in time "
                    f"({[c.filename for c in clocks]})")
            mjds = mjds[(mjds >= lo) & (mjds <= hi)]
        total_us = np.zeros_like(mjds)
        for c in clocks:
            total_us += c.evaluate(mjds, limits="warn") * 1e6
        return ClockFile(mjds, total_us,
                         filename="+".join(c.filename for c in clocks),
                         hdrline="# merged chain")

    def export(self, filename: str) -> None:
        """Write this clock file out (reference ``clock_file.py:411``):
        byte-for-byte from the backing file when its full path is known,
        else re-serialized in tempo2 format (``filename`` alone is a
        basename and must NOT be resolved against the cwd — it could name
        an unrelated file)."""
        import shutil

        src = getattr(self, "source_path", None)
        if src and os.path.exists(src):
            shutil.copyfile(src, filename)
            return
        log.info(f"export: no backing file for {self.filename!r}; "
                 "writing tempo2 format")
        self.write_tempo2_clock_file(filename)

    def __add__(self, other: "ClockFile") -> "ClockFile":
        """Merge two clock files by summing corrections on the union grid."""
        mjds = np.union1d(self.mjd, other.mjd)
        tot = self.evaluate(mjds, limits="warn") + other.evaluate(mjds, limits="warn")
        return ClockFile(mjds, tot * 1e6, filename=f"{self.filename}+{other.filename}")

    def write_tempo2_clock_file(self, path: str, hdrline: Optional[str] = None):
        with open(path, "w") as f:
            f.write((hdrline or self.hdrline or "# UTC(obs) UTC") + "\n")
            for m, c in zip(self.mjd, self.clock_us):
                f.write(f"{m:.5f} {c * 1e-6:.12e}\n")

    def write_tempo_clock_file(self, path: str, obscode: str = "1"):
        with open(path, "w") as f:
            f.write("# fake header\n   MJD       EECO-REF    NIST-REF NS      DATE    COMMENTS\n")
            for m, c in zip(self.mjd, self.clock_us):
                f.write(f"{m:9.2f} {0.0:9.3f} {c:9.3f} {obscode}\n")


def read_tempo_clock_file(path: str, obscode: Optional[str] = None, **kw) -> ClockFile:
    """Parse a TEMPO-format ``time*.dat`` file (reference ``clock_file.py:25``).

    Layout: columns MJD, EECO-REF offset [us], NIST-REF offset [us], obscode
    flag; the correction applied to TOAs is col3 - col2.  Lines starting with
    '#' or header text are skipped; a line beginning with 'MJD' is the header.
    """
    mjds: List[float] = []
    corr: List[float] = []
    # truncation signature: a line whose MJD parses but whose offset
    # columns do not, with no well-formed data line after it — a file cut
    # mid-line.  Legacy special lines mid-file still skip silently.
    bad_tail = False
    with open(path) as f:
        for ln in f:
            s = ln.strip()
            if not s or s.startswith("#") or s[0].isalpha():
                continue
            # 'si' special lines and comments
            fields = s.split()
            try:
                mjd = float(fields[0])
            except ValueError:
                continue
            if not (15000 < mjd < 100000):
                continue
            try:
                c1 = float(fields[1])
                c2 = float(fields[2]) if len(fields) > 2 else 0.0
            except (ValueError, IndexError):
                bad_tail = True
                continue
            bad_tail = False
            code = fields[3] if len(fields) > 3 else None
            if obscode is not None and code is not None and code.lower() != obscode.lower():
                continue
            mjds.append(mjd)
            corr.append(c2 - c1)
    if bad_tail:
        from pint_torch.exceptions import PintFileError

        raise PintFileError(
            f"{path}: truncated clock file — final data line is malformed")
    cf = ClockFile(mjds, corr, filename=os.path.basename(path), **kw)
    cf.source_path = os.path.abspath(path)
    return cf


def read_tempo2_clock_file(path: str, **kw) -> ClockFile:
    """Parse a TEMPO2 ``.clk`` file (reference ``clock_file.py:441``).

    The header is the first ``#``-prefixed line (``# UTC(obs) UTC(GPS)``
    style); ``##`` lines and later ``#`` lines are comments.  Data lines are
    ``MJD offset_seconds [uncertainty flags...]``; unparseable lines are
    skipped (a bare-text header line therefore also falls through safely).
    """
    mjds: List[float] = []
    corr: List[float] = []
    hdrline = ""
    bad_tail = False  # see read_tempo_clock_file: cut-mid-line signature
    with open(path) as f:
        for ln in f:
            s = ln.strip()
            if not s:
                continue
            if s.startswith("#"):
                if not hdrline and not s.startswith("##"):
                    hdrline = s
                continue
            fields = s.split()
            try:
                m_, c_ = float(fields[0]), float(fields[1])
            except (ValueError, IndexError):
                # bare-text header lines fall through safely, but a line
                # whose MJD parses and offset does not is data corruption
                try:
                    bad_tail = 15000 < float(fields[0]) < 100000
                except ValueError:
                    pass
                continue
            bad_tail = False
            mjds.append(m_)
            corr.append(c_ * 1e6)  # seconds -> us
    if bad_tail:
        from pint_torch.exceptions import PintFileError

        raise PintFileError(
            f"{path}: truncated clock file — final data line is malformed")
    cf = ClockFile(mjds, corr, filename=os.path.basename(path),
                   hdrline=hdrline, **kw)
    cf.source_path = os.path.abspath(path)
    return cf


_warned: set = set()
_cache: dict = {}


def _warn_once(filename: str, kind: str, message: str) -> None:
    """One warning per (filename, kind) per process: clock diagnostics
    repeat per TOA batch with VARYING text (different MJD ranges), so the
    logging layer's exact-message dedup can't catch them and a bench tail
    fills with the same missing-file story, drowning real diagnostics.
    The first occurrence carries the detail; repeats are dropped here."""
    key = (filename, kind)
    if key not in _warned:
        _warned.add(key)
        log.warning(message)


def _clock_search_paths() -> List[str]:
    paths = []
    for env in ("PINT_CLOCK_OVERRIDE", "PINT_CLOCK_DIR"):
        if os.environ.get(env):
            paths.append(os.environ[env])
    for env in ("TEMPO", "TEMPO2"):
        if os.environ.get(env):
            paths.append(os.path.join(os.environ[env], "clock"))
    # the global-repository cache (populated by update_clock_files /
    # get_clock_correction_file / update_all) participates in the live
    # chain whenever it exists — explicit url_base= calls populate it
    # without either env var being set
    cache = os.environ.get(
        "PINT_CLOCK_CACHE",
        os.path.join(os.path.expanduser("~"), ".pint_torch", "clock_cache"))
    if os.path.isdir(cache):
        paths.append(cache)
    paths.append(os.path.join(os.path.dirname(__file__), "..", "data", "clock"))
    return [p for p in paths if os.path.isdir(p)]


def find_clock_file(name: str, fmt: str = "tempo", limits: str = "warn",
                    valid_beyond_ends: bool = False) -> Optional[ClockFile]:
    """Locate and parse the named clock file, searching local directories.

    Returns None (with a one-time warning) when the file cannot be found —
    the zero-egress analogue of the reference's warn-and-continue policy for
    missing global clock corrections (``observatory/__init__.py:387``).
    With ``limits="error"`` a missing file always raises, cached or not.
    """
    key = (name, fmt, valid_beyond_ends)
    if key in _cache:
        cf = _cache[key]
        if cf is None and limits == "error":
            raise NoClockCorrections(f"Clock file {name} not found")
        return cf
    for d in _clock_search_paths():
        cand = os.path.join(d, name)
        if os.path.exists(cand):
            cf = ClockFile.read(cand, fmt=fmt, valid_beyond_ends=valid_beyond_ends)
            _cache[key] = cf
            return cf
    _cache[key] = None
    if limits == "error":
        raise NoClockCorrections(f"Clock file {name} not found")
    _warn_once(name, "missing",
               f"Clock file {name} not found; assuming zero correction")
    return None
