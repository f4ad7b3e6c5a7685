"""Hand-written Hopper kernels of the port, with their plain twins.

Each kernel module holds the wrapper (``spin_phase``, ``dd_binary``,
``schur_cholesky_solve``), its plain PyTorch version (``*_reference``, same
signature and semantics) and ``launch_counts``, one count per CUDA kernel
of its source, that the wrapper raises by one where it launches that
kernel.  Dispatch is by device: a CUDA tensor
launches the kernel, built from ``csrc/`` with nvcc at first use (a failed
build or launch raises; nothing falls back), and a CPU tensor runs the
plain version.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

from pint_torch.kernels._build import (KernelBuildError, KernelLaunchError,
                                       build)

__all__ = ["NAMES", "modules", "build_all", "launch_counts", "reset_counts",
           "KernelBuildError", "KernelLaunchError"]

#: the kernels, by wrapper-module name
NAMES = ("spin_phase", "dd_binary", "schur_cholesky_solve")


def modules() -> Dict[str, ModuleType]:
    """Kernel name -> wrapper module (imported on first use, so that the
    engines the twins share can import this package's helpers)."""
    return {n: importlib.import_module(f"pint_torch.kernels.{n}")
            for n in NAMES}


def build_all() -> Dict[str, float]:
    """Build every kernel (one nvcc per source, started together); returns
    the seconds each build took."""
    return build(NAMES)


def launch_counts() -> Dict[str, int]:
    """Launches since the last reset, by CUDA kernel: the primal and dual
    instantiations of K1 and K2 count apart."""
    out: Dict[str, int] = {}
    for mod in modules().values():
        out.update(mod.launch_counts)
    return out


def reset_counts() -> None:
    for mod in modules().values():
        for kernel in mod.launch_counts:
            mod.launch_counts[kernel] = 0
