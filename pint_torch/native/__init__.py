"""Native C++ host code (port of ``pint_tpu/native``): exact
double-double arithmetic and the decimal-string -> double-double parser,
compiled with the host compiler on first use and loaded through ctypes.

The dd pair carries ~106 mantissa bits (against 64 for x87 extended) on
every platform, including those whose longdouble is a double.  Without a
C++ toolchain the callers take the pure-Python path
(:func:`pint_torch.dd.dd_from_string`, exact rational rounding, where the
C++ parser accumulates in double-double: the low words may part in their
last bits); :func:`parser_path` says which one runs.

Build: ``g++ -O2 -fPIC -shared -std=c++14 -ffp-contract=off`` (the
reference's flags, with floating-point contraction forbidden so that no
compiler fuses the error-free transforms into FMAs) into
``pint_torch/_build/pint_native-<hash>.so``, keyed on a SHA-256 of the
source and the flags, so a stale or wrong-architecture object is never
loaded (the build directory is not committed).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from pint_torch.logging import log

__all__ = ["available", "parser_path", "dd_add_batch", "dd_mul_batch", "dd_div_batch",
           "dd_horner_batch", "str2dd_batch", "parse_double_batch"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_src", "pint_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
#: the compiler flags (the reference's plus ``-ffp-contract=off``)
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++14", "-ffp-contract=off")


def _so_path() -> str:
    """Cache path keyed on the source's and the flags' hash: rebuilds
    exactly when either changes."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(_BUILD_DIR, f"pint_native-{h[:12]}.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _build(so: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for cc in ("g++", "c++", "clang++"):
        try:
            r = subprocess.run(
                [cc, *FLAGS, "-o", tmp, _SRC],
                capture_output=True, text=True, timeout=120)
        except (FileNotFoundError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, so)  # atomic: concurrent builders never tear it
            for old in os.listdir(_BUILD_DIR):  # drop superseded objects
                if (old.startswith("pint_native") and old.endswith(".so")
                        and os.path.join(_BUILD_DIR, old) != so):
                    try:
                        os.unlink(os.path.join(_BUILD_DIR, old))
                    except OSError:
                        pass
            return True
        log.warning(f"native build with {cc} failed: {r.stderr[:500]}")
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            log.info("no C++ toolchain: using the pure-Python dd path")
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            # corrupt or wrong-architecture cached object (e.g. a _build dir
            # shared across machines): drop it and rebuild once
            try:
                os.unlink(so)
            except OSError:
                pass
            if not _build(so):
                log.info("no C++ toolchain: using the pure-Python dd path")
                return None
            lib = ctypes.CDLL(so)
    except OSError as e:
        log.warning(f"could not load native kernels: {e}")
        return None
    n = ctypes.c_int64
    for name in ("dd_add_batch", "dd_mul_batch", "dd_div_batch"):
        fn = getattr(lib, name)
        fn.argtypes = [_D, _D, _D, _D, _D, _D, n]
        fn.restype = None
    lib.dd_horner_batch.argtypes = [_D, _D, n, _D, _D, _D, _D, n]
    lib.dd_horner_batch.restype = None
    lib.str2dd_batch.argtypes = [ctypes.c_char_p, _I64, n, _D, _D]
    lib.str2dd_batch.restype = ctypes.c_int
    lib.parse_double_batch.argtypes = [ctypes.c_char_p, _I64, n, _D]
    lib.parse_double_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parser_path() -> str:
    """``"native"`` where the C++ parser built and loaded, ``"python"``
    where the callers fall back to the pure-Python path."""
    return "native" if available() else "python"


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native dd kernels unavailable — no C++ toolchain could build "
            "pint_native.cpp; call pint_torch.native.available() first and "
            "fall back to the pure-Python dd path (pint_torch.dd)")
    return lib


def _pair(x):
    hi = np.ascontiguousarray(x[0], dtype=np.float64)
    lo = np.ascontiguousarray(x[1], dtype=np.float64)
    return hi, lo


def _binop(name, a, b):
    lib = _require()
    ah, al = _pair(a)
    bh, bl = _pair(b)
    ah, bh = np.broadcast_arrays(ah, bh)
    al, bl = np.broadcast_arrays(al, bl)
    ah = np.ascontiguousarray(ah); al = np.ascontiguousarray(al)
    bh = np.ascontiguousarray(bh); bl = np.ascontiguousarray(bl)
    oh = np.empty_like(ah)
    ol = np.empty_like(al)
    getattr(lib, name)(ah.ravel(), al.ravel(), bh.ravel(), bl.ravel(),
                       oh.ravel(), ol.ravel(), oh.size)
    return oh, ol


def dd_add_batch(a, b):
    """(hi, lo) + (hi, lo) elementwise in exact dd arithmetic."""
    return _binop("dd_add_batch", a, b)


def dd_mul_batch(a, b):
    return _binop("dd_mul_batch", a, b)


def dd_div_batch(a, b):
    return _binop("dd_div_batch", a, b)


def dd_horner_batch(coeffs: List[Tuple[float, float]], x):
    """sum_k c_k x^k with dd coefficients and dd x (batched over x)."""
    lib = _require()
    ch = np.ascontiguousarray([c[0] for c in coeffs], dtype=np.float64)
    cl = np.ascontiguousarray([c[1] for c in coeffs], dtype=np.float64)
    xh, xl = _pair(x)
    xh = np.ascontiguousarray(xh); xl = np.ascontiguousarray(xl)
    oh = np.empty_like(xh)
    ol = np.empty_like(xl)
    lib.dd_horner_batch(ch, cl, len(coeffs), xh.ravel(), xl.ravel(),
                        oh.ravel(), ol.ravel(), oh.size)
    return oh, ol


def _pack_strings(strings: List[str]):
    enc = [s.encode() for s in strings]
    offsets = np.zeros(len(enc), dtype=np.int64)
    pos = 0
    parts = []
    for i, b in enumerate(enc):
        offsets[i] = pos
        parts.append(b + b"\0")
        pos += len(b) + 1
    return b"".join(parts), offsets


def str2dd_batch(strings: List[str]):
    """Decimal strings -> (hi, lo) double-double, exact to 2^-106
    (the reference's ``str_to_mjds``, ``pulsar_mjd.py:488``, without
    longdouble).  Invalid entries become NaN."""
    lib = _require()
    buf, offsets = _pack_strings(strings)
    n = len(strings)
    oh = np.empty(n, dtype=np.float64)
    ol = np.empty(n, dtype=np.float64)
    bad = lib.str2dd_batch(buf, offsets, n, oh, ol)
    if bad:
        log.warning(f"str2dd_batch: {bad} unparseable values -> NaN")
    return oh, ol


def parse_double_batch(strings: List[str]) -> np.ndarray:
    """Fast batch float parsing (fortran D exponents tolerated)."""
    lib = _require()
    buf, offsets = _pack_strings(strings)
    out = np.empty(len(strings), dtype=np.float64)
    bad = lib.parse_double_batch(buf, offsets, len(strings), out)
    if bad:
        log.warning(f"parse_double_batch: {bad} unparseable values -> NaN")
    return out
