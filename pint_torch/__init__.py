"""pint_torch — the PyTorch/CUDA port of the pulsar-timing pipeline.

A second package beside :mod:`pint_tpu` (the JAX reference, which this
package never imports).  The port follows the reference module for module:
the TOA batch and parameters, the double-double delay and phase chain, model
evaluation with forward-mode design matrices, residuals, the GLS fit and the
GLS chi2 grid.  Device work that the reference leaves to XLA fusion runs
here either as plain PyTorch or, on the hot path, as hand-written Hopper
kernels (:mod:`pint_torch.kernels`).

Rules the package keeps:

* every tensor is created with an explicit ``dtype=torch.float64`` (or a
  boolean/integer type) and an explicit device; the global default dtype is
  never touched, because an implicit float32 silently costs the
  double-double precision;
* entry points take ``device=None``, meaning ``"cuda"``; without a GPU they
  raise :class:`NoGPUError` unless the caller passes ``device="cpu"``;
* a kernel wrapper dispatches on its tensors' device: CUDA tensors launch
  the hand kernel (or raise), CPU tensors run the plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["F64", "NoGPUError", "resolve_device"]

__version__ = "0.1.0"

#: the one floating dtype of the port
F64 = torch.float64


class NoGPUError(RuntimeError):
    """A CUDA device was requested (explicitly or by default) but PyTorch
    sees no GPU.  Pass ``device="cpu"`` to run the plain PyTorch path."""


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a visible GPU
    raises :class:`NoGPUError` instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoGPUError(
            "pint_torch runs on the GPU by default and torch.cuda sees no "
            "device; pass device='cpu' to run the plain PyTorch versions")
    return dev
