"""Hand-written Hopper kernels of the port, with their plain twins.

Each kernel module holds the wrapper (K1 ``spin_phase``, K2 ``dd_binary``,
K3 ``schur_cholesky_solve``, K4 ``ell1_binary``, K5 ``wls_lstsq``, K6
``binary_orbits``, K7 ``solar_wind_pl``, K8 ``photon_lnlike``, K9
``chol_rank_update``, K10 ``hd_cross_lnlike`` with its backward K12
``hd_cross_grad``, K11 ``compensated_matmul``, K13 ``polyco_eval``, K14
``polyco_fit``), its plain PyTorch version
(``*_reference``, same signature and semantics) and
``launch_counts``, one count per CUDA kernel instantiation of its source,
that the wrapper raises by one where it launches that kernel.  Dispatch
is by device: a CUDA tensor launches the kernel, built from ``csrc/`` with
nvcc at first use (a failed build or launch raises; nothing falls back),
and a CPU tensor runs the plain version.
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
NAMES = ("spin_phase", "dd_binary", "schur_cholesky_solve", "ell1_binary",
         "wls_lstsq", "binary_orbits", "solar_wind_pl", "photon_lnlike",
         "chol_rank_update", "hd_cross_lnlike", "compensated_matmul",
         "polyco_eval", "polyco_fit")


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
    instantiations of K1, K2 and K4 (and K4's ELL1k ones) count apart."""
    out: Dict[str, int] = {}
    for mod in modules().values():
        out.update(mod.launch_counts)
    return out


def reset_counts() -> None:
    for mod in modules().values():
        for kernel in mod.launch_counts:
            mod.launch_counts[kernel] = 0
