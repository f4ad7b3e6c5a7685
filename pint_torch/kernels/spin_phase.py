"""K1 ``spin_phase``: the spindown phase with its exact mod-1 fold.

Replaces the reference's ``dd.mul_mod1`` (``pint_tpu/dd.py:355-390``) and
``day2sec_exact`` (``:396-414``) as composed in ``Spindown.phase_func``
(``pint_tpu/models/spindown.py:70-123``).  Inputs, with a leading batch
axis B (1 for a fit, the chunk of points for a grid):

* ``tdb_hi``, ``tdb_lo`` (N,): the batch's seconds since ``tdb0`` as an
  exact pair; ``tdb0`` the batch's reference MJD (float);
* ``pepoch`` (B, 2): PEPOCH as a (hi, lo) MJD pair; ``has_pepoch`` False
  drops its folds as the reference does when PEPOCH is unset;
* ``delay`` (B, N): the accumulated delay in seconds;
* ``F`` (B, S): the spin terms F0..F_{S-1}.

Returns ``(k, f)`` (B, N): integer cycles and the fraction, renormalized
like ``Phase.make``.  The local partials of ``f`` (B, N, S+2) with respect
to F0..F_{S-1}, the delay and PEPOCH's high word feed the ``jvp`` and the
``backward`` of the :class:`torch.autograd.Function`, so
``torch.func.jacfwd`` and ``torch.autograd.grad`` reach the kernel without
a hand-derived derivative.

On a CUDA tensor this launches ``csrc/spin_phase.cu`` (or raises); on a
CPU tensor it runs :func:`spin_phase_reference`, the plain PyTorch twin.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pint_torch import F64
from pint_torch.dd import DAY_S_F, _day2sec_impl, _mul_mod1_impl
from pint_torch.kernels import _build
from pint_torch.kernels.dual import (Dual, row_cotangent, seed, sum_to,
                                     toa_cotangent, val)

__all__ = ["spin_phase", "spin_phase_reference", "launch_counts",
           "REPLACES"]

NAME = "spin_phase"
#: the reference function this kernel replaces
REPLACES = "pint_tpu/dd.py:374"
#: the two ``__global__`` instantiations of ``csrc/spin_phase.cu``, by
#: whether the partials are asked for
KERNELS = {False: "spin_phase_primal", True: "spin_phase_dual"}
#: launches of each since the last reset (pint_torch.kernels.reset_counts)
launch_counts = dict.fromkeys(KERNELS.values(), 0)


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------
def _mul_mod1(c, t):
    """(k, f) of the folded product; a Dual f carries the reference's custom
    JVP, t*dc + c*dt (``dd.py:385-390``)."""
    k, f = _mul_mod1_impl(val(c), val(t))
    if not isinstance(c, Dual) and not isinstance(t, Dual):
        return k, f
    d = 0.0
    if isinstance(c, Dual):
        d = val(t).unsqueeze(-1) * c.d
    if isinstance(t, Dual):
        d = d + val(c).unsqueeze(-1) * t.d
    return k, Dual(f, d)


def _day2sec(x):
    e1, e2 = _day2sec_impl(val(x))
    if not isinstance(x, Dual):
        return e1, e2
    return Dual(e1, x.d * DAY_S_F), e2


def _spin_phase_math(t_hi, t_lo, tdb0, pe_hi, pe_lo, delay, F, has_pe):
    """The arithmetic of ``spin_phase.cu``'s ``spin_phase_math``, on tensors
    or :class:`Dual`\\ s, in the same order."""
    folds = [t_hi]
    tail = t_lo - delay
    if has_pe:
        e1, e2 = _day2sec(pe_hi - tdb0)
        folds += [-e1, -e2]
        tail = tail - pe_lo * DAY_S_F
    F0 = F[0]
    k = f = dt64 = 0.0
    for t in folds:
        ki, fi = _mul_mod1(F0, t)
        k = k + ki
        f = f + fi
        dt64 = dt64 + t
    dt64 = dt64 + tail
    f = f + F0 * tail
    S = len(F)
    if S > 1:
        acc = 0.0
        for i in range(S - 1, 0, -1):
            # tensor by tensor: on CUDA torch divides by a Python float as
            # a product with its reciprocal, the kernel divides
            fact = torch.full_like(val(F[i]), float(math.factorial(i + 1)))
            c = F[i] / fact
            acc = acc * dt64 + c
        f = f + acc * dt64 * dt64
    kk = torch.round(val(f))
    return k + kk, f - kk


def spin_phase_reference(tdb_hi, tdb_lo, tdb0: float, pepoch, delay, F,
                         has_pepoch: bool = True, partials: bool = True):
    """Plain PyTorch version of K1: ``(k, f, P)`` with ``P`` (B, N, S+2)
    the local partials of ``f`` (None when ``partials`` is False)."""
    B, N = delay.shape
    S = F.shape[1]
    K = S + 2
    if partials:
        Fs = [seed(F[:, i:i + 1], i, K) for i in range(S)]
        dl = seed(delay, S, K)
        pe_hi = seed(pepoch[:, 0:1], S + 1, K)
    else:
        Fs = [F[:, i:i + 1] for i in range(S)]
        dl = delay
        pe_hi = pepoch[:, 0:1]
    k, f = _spin_phase_math(tdb_hi, tdb_lo, tdb0, pe_hi, pepoch[:, 1:2], dl,
                            Fs, has_pepoch)
    k = k.expand(B, N)
    if isinstance(f, Dual):
        return k, f.v.expand(B, N), f.d.expand(B, N, K)
    return k, f.expand(B, N), None


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------
def _lib():
    lib = _build.load(NAME)
    fn = lib.spin_phase_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.c_double, vp, vp, vp, ci, ci, ci, ci,
                       vp, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(tdb_hi, tdb_lo, tdb0, pepoch, delay, F, has_pepoch, partials):
    B, N = delay.shape
    S = F.shape[1]
    if not 1 <= S <= 6:
        raise ValueError(f"spin_phase: the kernel takes 1..6 spin terms, got {S}")
    k = torch.empty((B, N), dtype=F64, device=delay.device)
    f = torch.empty_like(k)
    P = torch.empty((B, N, S + 2), dtype=F64, device=delay.device) \
        if partials else None
    rc = _lib().spin_phase_launch(
        _build.ptr(tdb_hi), _build.ptr(tdb_lo), float(tdb0),
        _build.ptr(pepoch), _build.ptr(delay), _build.ptr(F), B, N, S,
        int(bool(has_pepoch)), _build.ptr(k), _build.ptr(f),
        _build.ptr(P) if partials else None, _build.stream_of(delay))
    launch_counts[KERNELS[bool(partials)]] += 1
    _build.check(NAME, rc)
    return k, f, P


def _prepare(tdb_hi, tdb_lo, pepoch, delay, F):
    """Check and broadcast to a common batch: contiguous float64 on one
    device."""
    dev = delay.device
    for nm, t in (("tdb_hi", tdb_hi), ("tdb_lo", tdb_lo), ("pepoch", pepoch),
                  ("F", F)):
        if t.device != dev or t.dtype != F64:
            raise ValueError(f"spin_phase: {nm} must be float64 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if delay.dtype != F64 or delay.ndim != 2 or F.ndim != 2 \
            or pepoch.shape[-1] != 2 or tdb_hi.shape != (delay.shape[1],) \
            or tdb_lo.shape != tdb_hi.shape:
        raise ValueError(
            f"spin_phase: shapes delay {tuple(delay.shape)}, F "
            f"{tuple(F.shape)}, pepoch {tuple(pepoch.shape)}, tdb "
            f"{tuple(tdb_hi.shape)} do not fit (B,N), (B,S), (B,2), (N,)")
    B = max(delay.shape[0], F.shape[0], pepoch.shape[0])
    return (tdb_hi.contiguous(), tdb_lo.contiguous(),
            pepoch.expand(B, 2).contiguous(),
            delay.expand(B, delay.shape[1]).contiguous(),
            F.expand(B, F.shape[1]).contiguous())


def _run(tdb_hi, tdb_lo, tdb0, pepoch, delay, F, has_pepoch, partials):
    tdb_hi, tdb_lo, pepoch, delay, F = _prepare(tdb_hi, tdb_lo, pepoch,
                                                delay, F)
    if delay.is_cuda:
        return _launch(tdb_hi, tdb_lo, tdb0, pepoch, delay, F, has_pepoch,
                       partials)
    if delay.device.type != "cpu":
        raise ValueError(f"spin_phase: no kernel for device {delay.device}")
    return spin_phase_reference(tdb_hi, tdb_lo, tdb0, pepoch, delay, F,
                                has_pepoch, partials)


class SpinPhaseFn(torch.autograd.Function):
    """K1 under autodiff: forward returns ``(k, f, P)``; ``jvp`` contracts
    the incoming tangents with the local partials ``P``, ``backward`` the
    cotangent of ``f`` with them (:mod:`pint_torch.kernels.dual`); ``vmap``
    folds a vmapped axis into the kernel's batch axis B."""

    @staticmethod
    def forward(tdb_hi, tdb_lo, pepoch, delay, F, tdb0, has_pepoch):
        return _run(tdb_hi, tdb_lo, tdb0, pepoch, delay, F, has_pepoch, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        k, _, P = output
        ctx.mark_non_differentiable(k, P)
        ctx.save_for_forward(P)
        ctx.save_for_backward(P)
        ctx.shapes = tuple(t.shape for t in inputs[2:5])

    @staticmethod
    def jvp(ctx, d_hi, d_lo, d_pe, d_delay, d_F, _t0, _has):
        (P,) = ctx.saved_tensors
        S = P.shape[-1] - 2
        df = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_F is not None:
            df = df + (P[..., :S] @ d_F.unsqueeze(-1)).squeeze(-1)
        if d_delay is not None:
            df = df + d_delay * P[..., S]
        if d_pe is not None:
            df = df + d_pe[:, 0:1] * P[..., S + 1] \
                + (d_pe[:, 1:2] * DAY_S_F) * P[..., S]
        return None, df, None

    @staticmethod
    def backward(ctx, _gk, gf, _gP):
        (P,) = ctx.saved_tensors
        S = P.shape[-1] - 2
        pe, dl, Fs = ctx.shapes
        g_F = row_cotangent(gf, P[..., :S], Fs)
        g_delay = toa_cotangent(gf, P[..., S], dl)
        # PEPOCH's low word enters as the delay does, DAY_S_F to a day
        g_pe = sum_to(torch.stack([(gf * P[..., S + 1]).sum(-1),
                                   (gf * P[..., S]).sum(-1) * DAY_S_F],
                                  dim=-1), pe)
        return None, None, g_pe, g_delay, g_F, None, None

    @staticmethod
    def vmap(info, in_dims, tdb_hi, tdb_lo, pepoch, delay, F, tdb0,
             has_pepoch):
        if in_dims[0] is not None or in_dims[1] is not None:
            raise NotImplementedError(
                "spin_phase: the TOA times are shared by the whole batch")
        V = info.batch_size

        def fold(x, d):
            x = x.movedim(d, 0) if d is not None else x.expand(V, *x.shape)
            return x

        pe, dl, Fv = (fold(x, d) for x, d in zip((pepoch, delay, F),
                                                 in_dims[2:5]))
        B = max(pe.shape[1], dl.shape[1], Fv.shape[1])
        N, S = dl.shape[2], Fv.shape[2]
        k, f, P = SpinPhaseFn.apply(
            tdb_hi, tdb_lo, pe.expand(V, B, 2).reshape(V * B, 2),
            dl.expand(V, B, N).reshape(V * B, N),
            Fv.expand(V, B, S).reshape(V * B, S), tdb0, has_pepoch)
        return ((k.reshape(V, B, N), f.reshape(V, B, N),
                 P.reshape(V, B, N, S + 2)), (0, 0, 0))


def spin_phase(tdb_hi, tdb_lo, tdb0: float, pepoch, delay, F,
               has_pepoch: bool = True):
    """K1: ``(k, f)`` of the spindown phase (see the module docstring)."""
    if _build.traced(pepoch, delay, F):
        k, f, _ = SpinPhaseFn.apply(tdb_hi, tdb_lo, pepoch, delay, F,
                                    float(tdb0), bool(has_pepoch))
        return k, f
    k, f, _ = _run(tdb_hi, tdb_lo, tdb0, pepoch, delay, F, has_pepoch, False)
    return k, f
