"""K10 ``hd_cross_lnlike``: the Hellings-Downs cross term of the joint PTA
log-likelihood at a batch of walker points.

Replaces the cross term of ``pint_tpu/catalog/likelihood.py:112``
``_joint_kernel``: the common power-law spectrum, the low-rank
``I + S^T blockdiag(X) S`` system's Cholesky, the solve and the
log-determinant, per point.  The reference forms that system per walker
through an ``n_p^3 (2m)^2`` einsum over the HD factor; scaling by ``D =
diag(sqrt(phi_gw))`` commutes out of it, so the caller forms the
point-independent ``G`` and ``u`` once (:mod:`pint_torch.catalog.
likelihood`) and this function takes, for ``B`` points ``(log10_A,
gamma)``::

    phi_k = 10^(2 log10_A) / (12 pi^2) fyr^(gamma - 3) f_k^-gamma / Tspan
    d     = sqrt(phi) per row (each mode's sine and cosine share it)
    M     = I + D G D,  v = D u,  L L^T = M,  z = L^-1 v
    out_b = 0.5 ||z||^2 - sum_j log L_jj

with every power as ``exp(y log x)`` (CUDA's ``pow()`` built with
``-fmad=false`` rounds a few values apart from torch's).  ``G`` is (R, R)
with ``R = n_pulsars x 2 n_modes`` (only its lower triangle is read), ``u``
(R,), ``log10_A`` and ``gamma`` (B,), ``freqs`` (m,); returns (B,).  At
``log10_A = -inf`` the amplitude is exactly 0 and the result exactly 0.0.

On a CUDA tensor this launches ``csrc/hd_cross_lnlike.cu`` (or raises): a
blocked right-looking Cholesky over many CTAs a walker -- M formed into a
(walkers, R, R + 1) global workspace, then per panel of 64 columns a panel
factor and a tiled update of the trailing lower triangle, the solve as the
factor's augmented row, and fixed-order sums -- with the walkers taken in
chunks so that the workspace never exceeds :data:`WORKSPACE_CAP_BYTES`.
The card has no backward kernel yet: a gradient through a CUDA call
raises ``NotImplementedError``.  On a CPU tensor it runs
:func:`hd_cross_lnlike_reference`, a right-looking loop in which every
entry sees the kernel's rounding sequence (each product rounded alone, the
differences in ascending column order), so its result is the kernel's
bitwise, for any chunking; it is differentiable.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["hd_cross_lnlike", "hd_cross_lnlike_reference", "launch_counts",
           "REPLACES", "KERNELS", "FYR_HZ", "WORKSPACE_CAP_BYTES",
           "walkers_per_chunk"]

NAME = "hd_cross_lnlike"
REPLACES = "pint_tpu/catalog/likelihood.py:112"
#: the kernels of ``csrc/hd_cross_lnlike.cu``, in launch order: M's
#: formation, a panel's factor, the trailing update, the sums
KERNELS = {"form": "hd_cross_form", "panel": "hd_cross_panel",
           "trail": "hd_cross_trail", "sum": "hd_cross_sum"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)
#: the most device memory one call's workspace (the factor and the pivots
#: of its chunk of walkers) may take
WORKSPACE_CAP_BYTES = 2 ** 30

#: one inverse year in Hz, the spectrum's reference frequency
FYR_HZ = 1.0 / (365.25 * 86400.0)
_LN10 = math.log(10.0)
_LN_FYR = math.log(FYR_HZ)


def _scale(Tspan: float) -> float:
    return 1.0 / (12.0 * math.pi ** 2 * float(Tspan))


def _sqrt_phi(log10_A, gamma, freqs, Tspan):
    """(B, m) square roots of the power-law spectrum, in the kernel's
    order."""
    amp = torch.exp(log10_A * _LN10)
    phi = (((amp * amp) * _scale(Tspan))[:, None]
           * torch.exp((gamma - 3.0) * _LN_FYR)[:, None]) \
        * torch.exp(-gamma[:, None] * torch.log(freqs)[None, :])
    return torch.sqrt(phi)


def hd_cross_lnlike_reference(G, u, log10_A, gamma, freqs, Tspan: float):
    """Plain PyTorch version of K10: the augmented matrix ``[[M, .], [v^T,
    .]]`` factored right-looking, column by column, the trailing block
    updated by each column's rounded products in turn -- the kernel's
    left-looking sums in the same order -- and the two sums taken in
    column order."""
    B, R, m = log10_A.shape[0], G.shape[0], freqs.shape[0]
    d = _sqrt_phi(log10_A, gamma, freqs, Tspan).repeat_interleave(
        2, dim=1).repeat(1, R // (2 * m))
    A = torch.zeros((B, R + 1, R + 1), dtype=F64, device=G.device)
    eye = torch.eye(R, dtype=F64, device=G.device)
    A[:, :R, :R] = (d[:, :, None] * G) * d[:, None, :] + eye
    A[:, R, :R] = d * u
    acc_log = torch.zeros(B, dtype=F64, device=G.device)
    acc_zz = torch.zeros(B, dtype=F64, device=G.device)
    for j in range(R):
        piv = torch.sqrt(A[:, j, j])
        # a copy, so that autograd keeps no view of A across the update
        col = A[:, j + 1:, j].clone() / piv[:, None]
        A[:, j + 1:, j + 1:].sub_(col[:, :, None] * col[:, None, :])
        acc_log = acc_log + torch.log(piv)
        z = col[:, -1]
        acc_zz = acc_zz + z * z
    return 0.5 * acc_zz - acc_log


def walkers_per_chunk(B: int, R: int) -> int:
    """Walkers a launch takes so that the (chunk, R, R + 1) factor and the
    (chunk, R) pivots stay within :data:`WORKSPACE_CAP_BYTES`, the ``B``
    walkers split into chunks as even as may be."""
    per = 8 * (R * (R + 1) + R)
    if per > WORKSPACE_CAP_BYTES:
        raise ValueError(
            f"hd_cross_lnlike: one walker's workspace at R = {R} is {per} "
            f"bytes, over the cap of {WORKSPACE_CAP_BYTES}")
    n = math.ceil(B / (WORKSPACE_CAP_BYTES // per))
    return math.ceil(B / n)


def _lib():
    lib = _build.load(NAME)
    fn = lib.hd_cross_lnlike_launch
    if fn.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cd, cd, cd, vp, vp,
                       vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(G, u, log10_A, gamma, freqs, Tspan):
    B, R, m = log10_A.shape[0], G.shape[0], freqs.shape[0]
    dev = G.device
    n = walkers_per_chunk(B, R)
    work = torch.empty((n, R, R + 1), dtype=F64, device=dev)
    piv = torch.empty((n, R), dtype=F64, device=dev)
    out = torch.empty((B,), dtype=F64, device=dev)
    p = _build.ptr
    lib = _lib()
    for b0 in range(0, B, n):
        b1 = min(B, b0 + n)
        counts = (ctypes.c_int * len(KERNELS))()
        rc = lib.hd_cross_lnlike_launch(
            p(G), p(u), p(log10_A[b0:b1]), p(gamma[b0:b1]), p(freqs),
            b1 - b0, R, m, _scale(Tspan), _LN10, _LN_FYR, p(work), p(piv),
            p(out[b0:b1]), counts, _build.stream_of(G))
        for name, c in zip(KERNELS.values(), counts):
            launch_counts[name] += c
        _build.check(NAME, rc)
    return out


class _OnCard(torch.autograd.Function):
    """The CUDA launch under autograd: no backward kernel yet (queue B 5b),
    so a gradient through it raises instead of coming back empty."""

    @staticmethod
    def forward(ctx, G, u, log10_A, gamma, freqs, Tspan):
        return _launch(G, u, log10_A, gamma, freqs, Tspan)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "hd_cross_lnlike: no backward kernel on the card yet (queue B "
            "5b); differentiate its plain version on CPU tensors")


def hd_cross_lnlike(G, u, log10_A, gamma, freqs, Tspan: float):
    """K10: the (B,) cross terms ``0.5 ||L^-1 D u||^2 - log det L`` of ``M
    = I + D G D`` (module docstring)."""
    ts = (G, u, log10_A, gamma, freqs)
    R = G.shape[0] if G.ndim == 2 else -1
    m = freqs.shape[0] if freqs.ndim == 1 else 0
    if any(t.dtype != F64 or t.device != G.device for t in ts) \
            or G.ndim != 2 or G.shape[1] != R or u.shape != (R,) \
            or log10_A.ndim != 1 or gamma.shape != log10_A.shape \
            or m < 1 or R < 1 or R % (2 * m) or log10_A.shape[0] < 1 \
            or not Tspan > 0:
        raise ValueError(
            f"hd_cross_lnlike: G {tuple(G.shape)}, u {tuple(u.shape)}, "
            f"log10_A {tuple(log10_A.shape)}, gamma {tuple(gamma.shape)}, "
            f"freqs {tuple(freqs.shape)}, Tspan {Tspan!r}; want float64 "
            "(R,R), (R,), (B,), (B,), (m,) with R a multiple of 2 m, on one "
            "device, and Tspan > 0")
    G, u, log10_A, gamma, freqs = (t.contiguous() for t in ts)
    if G.is_cuda:
        return _OnCard.apply(G, u, log10_A, gamma, freqs, float(Tspan))
    if G.device.type != "cpu":
        raise ValueError(f"hd_cross_lnlike: no kernel for device {G.device}")
    return hd_cross_lnlike_reference(G, u, log10_A, gamma, freqs,
                                     float(Tspan))
