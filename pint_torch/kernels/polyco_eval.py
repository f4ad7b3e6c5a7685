"""K13 ``polyco_eval``: batched polyco evaluation of phase and frequency.

Replaces the reference's ``eval_kernel`` (``pint_tpu/predict/door.py:
86-113``).  Inputs, (B, T) float64 on one device -- B requests on the batch
ladder, T epochs on the time ladder --: ``dt`` minutes from each epoch's
window midpoint, ``rfrac`` the window's reference phase fraction, ``f0``
its spin frequency, and ``coeffs`` (B, T, n) the window's coefficients
(TEMPO per-minute powers).  Returns ``(ip, frac, freq)`` (B, T): the
integer and fractional part of ``rfrac + 60 f0 dt + poly`` (the integer
reference phase is added on the host) and ``f0 + dpoly / 60`` [Hz].

On a CUDA tensor this launches ``csrc/polyco_eval.cu`` (or raises); on a
CPU tensor it runs :func:`polyco_eval_reference`, the plain PyTorch
version, which makes the kernel's operations in the kernel's order and is
bitwise the reference's numpy Horner in ``PredictorCache.predict``.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["polyco_eval", "polyco_eval_reference", "launch_counts",
           "REPLACES"]

NAME = "polyco_eval"
#: the reference function this kernel replaces
REPLACES = "pint_tpu/predict/door.py:86"
#: the one ``__global__`` of ``csrc/polyco_eval.cu``
KERNELS = {"eval": "polyco_eval"}
#: launches since the last reset (pint_torch.kernels.reset_counts)
launch_counts = dict.fromkeys(KERNELS.values(), 0)


def polyco_eval_reference(dt, rfrac, f0, coeffs):
    """Plain PyTorch version of K13: ``(ip, frac, freq)``.  The
    division by 60 is by a tensor: CUDA PyTorch turns a division by a
    Python float into a product with its reciprocal."""
    n = coeffs.shape[-1]
    poly = torch.zeros_like(dt)
    dpoly = torch.zeros_like(dt)
    for i in range(n - 1, 0, -1):
        ci = coeffs[..., i]
        poly = poly * dt + ci
        dpoly = dpoly * dt + i * ci
    poly = poly * dt + coeffs[..., 0]
    raw = (rfrac + (60.0 * f0) * dt) + poly
    ip = torch.floor(raw)
    return ip, raw - ip, f0 + dpoly / torch.full_like(dpoly, 60.0)


def _lib():
    lib = _build.load(NAME)
    fn = lib.polyco_eval_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_long, ctypes.c_int, vp, vp,
                       vp, vp]
        fn.restype = ctypes.c_int
    return lib


def _launch(dt, rfrac, f0, coeffs):
    n = coeffs.shape[-1]
    ip = torch.empty_like(dt)
    frac = torch.empty_like(dt)
    freq = torch.empty_like(dt)
    rc = _lib().polyco_eval_launch(
        _build.ptr(dt), _build.ptr(rfrac), _build.ptr(f0), _build.ptr(coeffs),
        dt.numel(), n, _build.ptr(ip), _build.ptr(frac), _build.ptr(freq),
        _build.stream_of(dt))
    launch_counts["polyco_eval"] += 1
    _build.check(NAME, rc)
    return ip, frac, freq


def polyco_eval(dt, rfrac, f0, coeffs):
    """K13: ``(ip, frac, freq)`` (see the module docstring)."""
    dev = dt.device
    for nm, t in (("rfrac", rfrac), ("f0", f0), ("coeffs", coeffs)):
        if t.device != dev or t.dtype != F64:
            raise ValueError(f"polyco_eval: {nm} must be float64 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if dt.dtype != F64 or rfrac.shape != dt.shape or f0.shape != dt.shape \
            or coeffs.shape[:-1] != dt.shape or coeffs.shape[-1] < 1:
        raise ValueError(
            f"polyco_eval: shapes dt {tuple(dt.shape)}, rfrac "
            f"{tuple(rfrac.shape)}, f0 {tuple(f0.shape)}, coeffs "
            f"{tuple(coeffs.shape)} do not fit (B, T) x3 and (B, T, n)")
    args = tuple(t.contiguous() for t in (dt, rfrac, f0, coeffs))
    if dev.type == "cuda":
        return _launch(*args)
    if dev.type != "cpu":
        raise ValueError(f"polyco_eval: no kernel for device {dev}")
    return polyco_eval_reference(*args)
