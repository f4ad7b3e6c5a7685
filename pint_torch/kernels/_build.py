"""Build the hand kernels with nvcc, bind them through ctypes, and tell
when a caller needs their partials.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface; it compiles
into ``pint_torch/_build/<name>-<hash>.so`` at first use, keyed on the hash
of its sources and the flags, so an edited source rebuilds and an unchanged
one loads in milliseconds.  No PyTorch header is compiled (a build takes
seconds, not minutes), and nothing is built while a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KernelBuildError", "KernelLaunchError", "NVCC_FLAGS",
           "build", "build_count", "load", "library_path", "check", "ptr", "stream_of",
           "traced", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

#: sm_90a keeps wgmma/setmaxnreg available to later kernels; -fmad=false
#: keeps every product rounded alone (double-double and folded products),
#: in every kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_HEADERS = ("dual.cuh",)
_loaded: Dict[str, ctypes.CDLL] = {}
#: kernel libraries compiled by this process (the port's analogue of
#: XLA's compile count)
_compiled = [0]


def build_count() -> int:
    """Kernel libraries this process has compiled with nvcc so far."""
    return _compiled[0]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the hand kernels build only where the CUDA toolkit is "
            "installed")
    return found


def library_path(name: str) -> Path:
    """Where the shared library of kernel ``name`` lives for the current
    sources and flags."""
    h = hashlib.sha256()
    for part in (f"{name}.cu",) + _HEADERS:
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns the seconds each
    build took (0.0 for a library already present); raises
    :class:`KernelBuildError` with nvcc's output when one fails.  The
    ptxas report (registers, spills, shared memory) is kept beside each
    library as ``<name>-<hash>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out)
    failures = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        _compiled[0] += 1
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return times


def ptxas_report(log: str, marker: str):
    """``(registers, stack frame bytes, spill store bytes, spill load
    bytes)`` of the kernel whose mangled name contains ``marker``, read
    from an nvcc ``-Xptxas -v`` log (the ``<name>-<hash>.log`` that
    :func:`build` keeps); None when the log has no such kernel."""
    lines = log.splitlines()
    for i, line in enumerate(lines[:-2]):
        if "Function properties for" in line and marker in line:
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", lines[i + 1])
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            if frame and regs:
                return (int(regs.group(1)),
                        *(int(v) for v in frame.groups()))
    return None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise :class:`KernelLaunchError` for a non-zero CUDA error code."""
    if code != 0:
        msg = getattr(load(name), f"{name}_error_string")(code)
        raise KernelLaunchError(f"{name}: CUDA error {code}: "
                                f"{msg.decode() if msg else '?'}")


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a contiguous tensor, for a ctypes argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def traced(*ts) -> bool:
    """True when a torch.func transform or autograd is following one of the
    tensors ``ts``: only then are a kernel's local partials worth
    computing."""
    import torch

    return any(t.requires_grad
               or torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in ts)
