"""K14 ``polyco_fit``: batched least-squares polyco fits.

Replaces the reference's ``fit_kernel`` (``pint_tpu/predict/generate.py:
51-76``, ``one_window`` vmapped over rows).  Inputs ``x``, ``y`` (W, m)
float64 on one device: each (pulsar, window) row's scaled node abscissae
in (-1, 1) and its ramp-removed phase targets [cycles].  Returns ``(c,
rms)``: ``c`` (W, n) the least-squares coefficients of ``V = x^[0..n)``
(scaled-x powers; the host rescales them to per-minute powers) and
``rms`` (W,) the fit's rms over the nodes [cycles].

The reference solves each row by LAPACK's QR and a triangular solve; the
kernel and its plain version here by Householder reflections applied
column by column to ``[V | y]``, back substitution and the residual's sum
of squares, every sum in index order -- so the two agree bitwise with each
other and with the reference at the fit's bars (the QR's signs and
roundings differ from LAPACK's; the predicted phases are compared).  A row
against a zero target solves to exactly zero.

On a CUDA tensor this launches ``csrc/polyco_fit.cu`` (or raises); on a
CPU tensor it runs :func:`polyco_fit_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["polyco_fit", "polyco_fit_reference", "launch_counts",
           "REPLACES", "MMAX", "NMAX"]

NAME = "polyco_fit"
#: the reference function this kernel replaces
REPLACES = "pint_tpu/predict/generate.py:51"
#: the one ``__global__`` of ``csrc/polyco_fit.cu``
KERNELS = {"fit": "polyco_fit"}
#: launches since the last reset (pint_torch.kernels.reset_counts)
launch_counts = dict.fromkeys(KERNELS.values(), 0)
#: the kernel's limits on the nodes and coefficients of a row
MMAX = 64
NMAX = 32


def polyco_fit_reference(x, y, n: int):
    """Plain PyTorch version of K14 (the kernel's operations in its
    order, every row at once): ``(c (W, n), rms (W,))``."""
    W, m = x.shape
    cols = [torch.ones_like(x)]
    for _ in range(1, n):
        cols.append(cols[-1] * x)
    A = torch.stack(cols + [y], dim=2)  # (W, m, n + 1)
    two = torch.full((W,), 2.0, dtype=F64, device=x.device)
    for k in range(n):
        s = torch.zeros_like(two)
        for i in range(k, m):
            s = s + A[:, i, k] * A[:, i, k]
        norm = torch.sqrt(s)
        akk = A[:, k, k]
        alpha = torch.where(akk >= 0.0, -norm, norm)
        vtv = (2.0 * norm) * (norm + torch.abs(akk))
        scale = torch.where(vtv > 0.0, two / torch.where(vtv > 0.0, vtv, 1.0),
                            0.0)
        A[:, k, k] = akk - alpha
        if k + 1 <= n:
            dot = torch.zeros_like(A[:, 0, k + 1:])
            for i in range(k, m):
                dot = dot + A[:, i, k:k + 1] * A[:, i, k + 1:]
            f = dot * scale[:, None]
            for i in range(k, m):
                A[:, i, k + 1:] = A[:, i, k + 1:] - f * A[:, i, k:k + 1]
        A[:, k, k] = alpha
    c = torch.zeros((W, n), dtype=F64, device=x.device)
    for i in range(n - 1, -1, -1):
        s = A[:, i, n].clone()
        for j in range(i + 1, n):
            s = s - A[:, i, j] * c[:, j]
        c[:, i] = s / A[:, i, i]
    p = torch.ones_like(x)
    acc = p * c[:, 0:1]
    for j in range(1, n):
        p = p * x
        acc = acc + p * c[:, j:j + 1]
    r = acc - y
    ss = torch.zeros_like(two)
    for i in range(m):
        ss = ss + r[:, i] * r[:, i]
    return c, torch.sqrt(ss / torch.full_like(ss, float(m)))


def _lib():
    lib = _build.load(NAME)
    fn = lib.polyco_fit_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_long, ci, ci, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(x, y, n):
    W, m = x.shape
    c = torch.empty((W, n), dtype=F64, device=x.device)
    rms = torch.empty((W,), dtype=F64, device=x.device)
    rc = _lib().polyco_fit_launch(_build.ptr(x), _build.ptr(y), W, m, n,
                                  _build.ptr(c), _build.ptr(rms),
                                  _build.stream_of(x))
    launch_counts["polyco_fit"] += 1
    _build.check(NAME, rc)
    return c, rms


def polyco_fit(x, y, n: int):
    """K14: ``(c, rms)`` (see the module docstring)."""
    n = int(n)
    if x.dtype != F64 or y.dtype != F64 or y.device != x.device \
            or x.ndim != 2 or y.shape != x.shape:
        raise ValueError(f"polyco_fit: x {tuple(x.shape)} {x.dtype} and y "
                         f"{tuple(y.shape)} {y.dtype} must be matching "
                         "(W, m) float64 on one device")
    m = x.shape[1]
    if not 1 <= n <= min(m, NMAX) or m > MMAX:
        raise ValueError(f"polyco_fit: the kernel takes 1 <= n <= m, n <= "
                         f"{NMAX}, m <= {MMAX}; got n = {n}, m = {m}")
    x, y = x.contiguous(), y.contiguous()
    if x.is_cuda:
        return _launch(x, y, n)
    if x.device.type != "cpu":
        raise ValueError(f"polyco_fit: no kernel for device {x.device}")
    return polyco_fit_reference(x, y, n)
