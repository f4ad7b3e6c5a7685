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
On a CPU tensor it runs :func:`hd_cross_lnlike_reference`, a right-looking
loop in which every entry sees the kernel's rounding sequence (each
product rounded alone, the differences in ascending column order), so its
result is the kernel's bitwise, for any chunking.

K12 ``hd_cross_grad``, the backward of this function, is the gradient
with respect to each walker's ``(log10_A, gamma)``.  It replaces what
``jax.value_and_grad`` (``pint_tpu/amortized/train.py:103``) makes of the
cross term when the ELBO's flow samples the catalogue's GWB posterior.
With ``w = M^-1 v = L^-T z`` and ``e_k = d log d_k / d theta``::

    d out / d theta = sum_k e_k (w_k^2 + (M^-1)_kk - 1)

with ``e_k = ln 10`` for log10_A and ``0.5 (ln fyr - ln f_j(k))`` for gamma
(j(k) the frequency bin of row k).  ``diag(M^-1)`` is the squared column
norms of ``X = L^-1``.  Per walker: ``X`` by forward substitution, ``c_k =
(w_k w_k + s_k) - 1`` with ``s_k = sum_i X_ik^2`` and ``w_k = sum_i X_ik
z_i`` in ascending i, the c_k summed into the m bins in ascending k, and
the two derivatives as sums over the bins in ascending j (log10_A's times
ln 10 last).  At small amplitude M ~ I and each c_k cancels, so kernel and
plain version take every term in the same order; at zero amplitude L = X
= I, z = 0 and the result is exactly 0.0.

Value and gradient come from one factorization, as ``jax.value_and_grad``
computes them: :func:`hd_cross_value_and_grad` launches the source's
``hd_cross_value_and_grad_launch`` on a CUDA tensor (or raises) -- chunk
by chunk of walkers under the workspace cap, K10's form, panel and
trailing kernels (the diagonal blocks of L kept aside), K10's sum for the
value (bitwise K10's), then ``X`` in the same workspace's upper triangle
by a left-looking blocked forward substitution (one launch a row block,
each entry written once), the column sums and the bins -- and on a CPU
tensor :func:`hd_cross_value_and_grad_reference`, one
:func:`factor_columns` pass in the kernels' rounding order, so both
results are the kernels' bitwise.  Under autograd, :func:`hd_cross_lnlike`
takes that path whenever ``log10_A`` or ``gamma`` needs a gradient: the
forward keeps the (B, 2) gradient and the backward scales it by the
cotangent, so a training step factors each walker once.  Without a
gradient (the catalogue's ``lnlike_batch``, the chains) it runs K10 alone.
:func:`hd_cross_grad` is the gradient of the same call.  ``G``, ``u`` and
``freqs`` are data: no gradient flows to them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["hd_cross_lnlike", "hd_cross_lnlike_reference", "hd_cross_grad",
           "hd_cross_grad_reference", "hd_cross_value_and_grad",
           "hd_cross_value_and_grad_reference", "launch_counts", "REPLACES",
           "GRAD_REPLACES", "KERNELS", "GRAD_KERNELS", "NB", "FYR_HZ",
           "WORKSPACE_CAP_BYTES", "walkers_per_chunk", "check_inputs",
           "gamma_weights"]

NAME = "hd_cross_lnlike"
REPLACES = "pint_tpu/catalog/likelihood.py:112"
GRAD_REPLACES = "pint_tpu/amortized/train.py:103"
#: K10's kernels, in launch order: M's formation, a panel's factor, the
#: trailing update, the sums
KERNELS = {"form": "hd_cross_form", "panel": "hd_cross_panel",
           "trail": "hd_cross_trail", "sum": "hd_cross_sum"}
#: K12's launch sequence (value and gradient from one factor), in launch
#: order: K10's factor and sum (counted under K12's names), the inverse's
#: row blocks, the column sums, the bins
GRAD_KERNELS = {"form": "hd_cross_grad_form", "panel": "hd_cross_grad_panel",
                "trail": "hd_cross_grad_trail", "sum": "hd_cross_grad_sum",
                "inv": "hd_cross_inv_left", "colsum": "hd_cross_colsum",
                "bins": "hd_cross_bins"}
launch_counts = dict.fromkeys([*KERNELS.values(), *GRAD_KERNELS.values()],
                              0)
#: the most device memory one call's workspace (the factor and the pivots
#: of its chunk of walkers) may take
WORKSPACE_CAP_BYTES = 2 ** 30

#: one inverse year in Hz, the spectrum's reference frequency
FYR_HZ = 1.0 / (365.25 * 86400.0)
_LN10 = math.log(10.0)
_LN_FYR = math.log(FYR_HZ)
#: the panel width of the source: K12 keeps a walker's diagonal blocks of
#: L as (R, NB)
NB = 64


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


def factor_columns(G, u, log10_A, gamma, freqs, Tspan: float):
    """The augmented matrix ``[[M, .], [v^T, .]]`` factored right-looking,
    column by column, the trailing block updated by each column's rounded
    products in turn -- the kernel's left-looking sums in the same order;
    yields each column's pivot ``L_jj`` (B,) and its entries below, ``L_ij``
    and ``z_j`` last (B, R - j)."""
    B, R, m = log10_A.shape[0], G.shape[0], freqs.shape[0]
    d = _sqrt_phi(log10_A, gamma, freqs, Tspan).repeat_interleave(
        2, dim=1).repeat(1, R // (2 * m))
    A = torch.zeros((B, R + 1, R + 1), dtype=F64, device=G.device)
    eye = torch.eye(R, dtype=F64, device=G.device)
    A[:, :R, :R] = (d[:, :, None] * G) * d[:, None, :] + eye
    A[:, R, :R] = d * u
    for j in range(R):
        piv = torch.sqrt(A[:, j, j])
        # a copy, so that autograd keeps no view of A across the update
        col = A[:, j + 1:, j].clone() / piv[:, None]
        A[:, j + 1:, j + 1:].sub_(col[:, :, None] * col[:, None, :])
        yield piv, col


def hd_cross_lnlike_reference(G, u, log10_A, gamma, freqs, Tspan: float):
    """Plain PyTorch version of K10: :func:`factor_columns`, then the two
    sums taken in column order."""
    acc_log = torch.zeros_like(log10_A)
    acc_zz = torch.zeros_like(log10_A)
    for piv, col in factor_columns(G, u, log10_A, gamma, freqs, Tspan):
        acc_log = acc_log + torch.log(piv)
        z = col[:, -1]
        acc_zz = acc_zz + z * z
    return 0.5 * acc_zz - acc_log


def gamma_weights(freqs):
    """(m,) e of gamma per frequency bin, ``0.5 (ln fyr - ln f_j)``."""
    return 0.5 * (_LN_FYR - torch.log(freqs))


def _grad_from_factor(L, piv, z, freqs):
    """K12's gradient from a walker's factor (``L`` (B, R, R) strictly
    lower, its pivots and ``z``), in the kernels' order."""
    B, R, m = L.shape[0], L.shape[1], freqs.shape[0]
    # X = L^-1 by rows: row j divided by its pivot once every earlier row's
    # product has been subtracted; columns past j are still 0
    X = torch.eye(R, dtype=F64, device=L.device).repeat(B, 1, 1)
    for j in range(R):
        X[:, j, :j + 1] = X[:, j, :j + 1] / piv[:, j:j + 1]
        X[:, j + 1:, :j + 1] -= L[:, j + 1:, j:j + 1] * X[:, j:j + 1, :j + 1]
    s = torch.zeros((B, R), dtype=F64, device=L.device)
    wz = torch.zeros((B, R), dtype=F64, device=L.device)
    for i in range(R):
        x = X[:, i, :]
        s = s + x * x
        wz = wz + x * z[:, i:i + 1]
    c = (wz * wz + s) - 1.0
    cv = c.view(B, R // (2 * m), m, 2)
    S = torch.zeros((B, m), dtype=F64, device=L.device)
    for a in range(cv.shape[1]):
        S = S + cv[:, a, :, 0]
        S = S + cv[:, a, :, 1]
    eg = gamma_weights(freqs)
    ga = torch.zeros(B, dtype=F64, device=L.device)
    gg = torch.zeros(B, dtype=F64, device=L.device)
    for j in range(m):
        ga = ga + S[:, j]
        gg = gg + eg[j] * S[:, j]
    return torch.stack([ga * _LN10, gg], dim=1)


def hd_cross_value_and_grad_reference(G, u, log10_A, gamma, freqs,
                                      Tspan: float):
    """Plain PyTorch version of K10 and K12 from one :func:`factor_columns`
    pass: ``(value (B,), grad (B, 2))``, the value bitwise
    :func:`hd_cross_lnlike_reference`'s and the gradient in the kernels'
    order (module docstring)."""
    B, R = log10_A.shape[0], G.shape[0]
    with torch.no_grad():
        L = torch.zeros((B, R, R), dtype=F64, device=G.device)
        piv = torch.zeros((B, R), dtype=F64, device=G.device)
        z = torch.zeros((B, R), dtype=F64, device=G.device)
        acc_log = torch.zeros_like(log10_A)
        acc_zz = torch.zeros_like(log10_A)
        for j, (p, col) in enumerate(factor_columns(G, u, log10_A, gamma,
                                                    freqs, Tspan)):
            piv[:, j] = p
            L[:, j + 1:, j] = col[:, :-1]
            z[:, j] = col[:, -1]
            acc_log = acc_log + torch.log(p)
            zj = col[:, -1]
            acc_zz = acc_zz + zj * zj
        return 0.5 * acc_zz - acc_log, _grad_from_factor(L, piv, z, freqs)


def hd_cross_grad_reference(G, u, log10_A, gamma, freqs, Tspan: float):
    """Plain PyTorch version of K12: ``(B, 2)`` d out / d (log10_A, gamma),
    in the kernel's order (module docstring)."""
    return hd_cross_value_and_grad_reference(G, u, log10_A, gamma, freqs,
                                             Tspan)[1]


def walkers_per_chunk(B: int, R: int, vectors: int = 1) -> int:
    """Walkers a launch takes so that the (chunk, R, R + 1) factor and
    ``vectors`` (chunk, R) scratch vectors (the forward's pivots) stay
    within :data:`WORKSPACE_CAP_BYTES`, the ``B`` walkers split into chunks
    as even as may be."""
    per = 8 * (R * (R + 1) + vectors * R)
    if per > WORKSPACE_CAP_BYTES:
        raise ValueError(
            f"hd_cross_lnlike: one walker's workspace at R = {R} is {per} "
            f"bytes, over the cap of {WORKSPACE_CAP_BYTES}")
    n = math.ceil(B / (WORKSPACE_CAP_BYTES // per))
    return math.ceil(B / n)


def _lib():
    lib = _build.load(NAME)
    if lib.hd_cross_lnlike_launch.argtypes is None:
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.hd_cross_lnlike_launch.argtypes = [
            vp, vp, vp, vp, vp, ci, ci, ci, cd, cd, cd, vp, vp, vp, vp, vp]
        lib.hd_cross_value_and_grad_launch.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, cd, cd, cd, vp, vp, vp, vp,
            vp, vp, vp, vp]
        lib.hd_cross_lnlike_launch.restype = ci
        lib.hd_cross_value_and_grad_launch.restype = ci
        lib.hd_cross_lnlike_init.restype = ci
        _build.check(NAME, lib.hd_cross_lnlike_init())
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


def _launch_value_and_grad(G, u, log10_A, gamma, freqs, Tspan):
    B, R, m = log10_A.shape[0], G.shape[0], freqs.shape[0]
    dev = G.device
    n = walkers_per_chunk(B, R, vectors=NB + 2)
    work = torch.empty((n, R, R + 1), dtype=F64, device=dev)
    piv = torch.empty((n, R), dtype=F64, device=dev)
    diag = torch.empty((n, R, NB), dtype=F64, device=dev)
    cb = torch.empty((n, R), dtype=F64, device=dev)
    value = torch.empty((B,), dtype=F64, device=dev)
    grad = torch.empty((B, 2), dtype=F64, device=dev)
    eg = gamma_weights(freqs).contiguous()
    p = _build.ptr
    lib = _lib()
    for b0 in range(0, B, n):
        b1 = min(B, b0 + n)
        counts = (ctypes.c_int * len(GRAD_KERNELS))()
        rc = lib.hd_cross_value_and_grad_launch(
            p(G), p(u), p(log10_A[b0:b1]), p(gamma[b0:b1]), p(freqs), p(eg),
            b1 - b0, R, m, _scale(Tspan), _LN10, _LN_FYR, p(work), p(piv),
            p(diag), p(cb), p(value[b0:b1]), p(grad[b0:b1]), counts,
            _build.stream_of(G))
        for name, c in zip(GRAD_KERNELS.values(), counts):
            launch_counts[name] += c
        _build.check(NAME, rc)
    return value, grad


class _CrossTerm(torch.autograd.Function):
    """K10 under autograd.  With ``need_grad`` the forward runs value and
    gradient from one factor (K12's launch sequence, its plain version on
    CPU tensors) and keeps the (B, 2) gradient, which the backward scales
    by the output cotangent; without it (no input needs a gradient) the
    forward is K10 alone."""

    @staticmethod
    def forward(G, u, log10_A, gamma, freqs, Tspan, need_grad):
        if not need_grad:
            value = _launch(G, u, log10_A, gamma, freqs, Tspan) if G.is_cuda \
                else hd_cross_lnlike_reference(G, u, log10_A, gamma, freqs,
                                               Tspan)
            return value, value.new_empty((0, 2))
        if G.is_cuda:
            return _launch_value_and_grad(G, u, log10_A, gamma, freqs, Tspan)
        return hd_cross_value_and_grad_reference(G, u, log10_A, gamma, freqs,
                                                 Tspan)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output[1])
        ctx.mark_non_differentiable(output[1])

    @staticmethod
    def backward(ctx, grad, _):
        (D,) = ctx.saved_tensors
        return None, None, grad * D[:, 0], grad * D[:, 1], None, None, None


def check_inputs(G, u, log10_A, gamma, freqs, Tspan: float, name: str):
    """Raise ValueError unless the inputs are K10's (module docstring) and
    its data (``G``, ``u``, ``freqs``) take no gradient."""
    ts = (G, u, log10_A, gamma, freqs)
    R = G.shape[0] if G.ndim == 2 else -1
    m = freqs.shape[0] if freqs.ndim == 1 else 0
    if any(t.dtype != F64 or t.device != G.device for t in ts) \
            or G.ndim != 2 or G.shape[1] != R or u.shape != (R,) \
            or log10_A.ndim != 1 or gamma.shape != log10_A.shape \
            or m < 1 or R < 1 or R % (2 * m) or log10_A.shape[0] < 1 \
            or not Tspan > 0:
        raise ValueError(
            f"{name}: G {tuple(G.shape)}, u {tuple(u.shape)}, "
            f"log10_A {tuple(log10_A.shape)}, gamma {tuple(gamma.shape)}, "
            f"freqs {tuple(freqs.shape)}, Tspan {Tspan!r}; want float64 "
            "(R,R), (R,), (B,), (B,), (m,) with R a multiple of 2 m, on one "
            "device, and Tspan > 0")
    if G.requires_grad or u.requires_grad or freqs.requires_grad:
        raise ValueError(f"{name}: G, u and freqs are data; the gradient "
                         "goes to log10_A and gamma only")
    if G.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {G.device}")


def _prepared(G, u, log10_A, gamma, freqs, Tspan, name):
    check_inputs(G, u, log10_A, gamma, freqs, Tspan, name)
    return [t.contiguous() for t in (G, u, log10_A, gamma, freqs)]


def hd_cross_lnlike(G, u, log10_A, gamma, freqs, Tspan: float):
    """K10: the (B,) cross terms ``0.5 ||L^-1 D u||^2 - log det L`` of ``M
    = I + D G D`` (module docstring); with K12's gradient from the same
    factor when ``log10_A`` or ``gamma`` needs one."""
    ts = _prepared(G, u, log10_A, gamma, freqs, Tspan, "hd_cross_lnlike")
    need_grad = torch.is_grad_enabled() and _build.traced(log10_A, gamma)
    return _CrossTerm.apply(*ts, float(Tspan), need_grad)[0]


def hd_cross_value_and_grad(G, u, log10_A, gamma, freqs, Tspan: float):
    """K10 and K12 from one factor: ``(value (B,), grad (B, 2))``, the
    cross terms and d value_b / d (log10_A_b, gamma_b), outside autograd
    (module docstring)."""
    ts = _prepared(*(t.detach() for t in (G, u, log10_A, gamma, freqs)),
                   Tspan, "hd_cross_value_and_grad")
    if ts[0].is_cuda:
        return _launch_value_and_grad(*ts, float(Tspan))
    return hd_cross_value_and_grad_reference(*ts, float(Tspan))


def hd_cross_grad(G, u, log10_A, gamma, freqs, Tspan: float):
    """K12: ``(B, 2)`` d out_b / d (log10_A_b, gamma_b) of K10's cross term
    (module docstring)."""
    return hd_cross_value_and_grad(G, u, log10_A, gamma, freqs, Tspan)[1]
