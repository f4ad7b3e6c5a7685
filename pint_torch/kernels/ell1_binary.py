"""K4 ``ell1_binary``: the ELL1 / ELL1k binary delay with local partials.

Replaces ``pint_tpu/models/binary/engines.py``'s ``orbits_pb``,
``ell1_eps``, ``ell1_roemer_terms``, ``ell1_inverse_delay``, ``ell1_delay``
and ``ell1k_delay`` (``engines.py:355-453``) as called by
``BinaryELL1.binary_delay`` and ``BinaryELL1k.binary_delay``
(``components.py:625,717``).  Inputs with a leading batch axis B:
``ttasc`` (B, N) seconds since TASC (barycentric, delay-corrected) and
``params`` (B, 13) in the order :data:`ELL1_PARAMS`; ``ell1k`` picks
ELL1k's rotating/exponential eccentricity and first-order Dre.  Returns the
delay (B, N) in seconds; the local partials (B, N, 14) with respect to
ttasc and the 13 parameters, from the kernel's reverse sweep, feed the
``jvp`` of the :class:`torch.autograd.Function`.

On a CUDA tensor this launches ``csrc/ell1_binary.cu`` (or raises); on a
CPU tensor it runs :func:`ell1_binary_reference`, the plain PyTorch twin.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build
from pint_torch.models.binary.engines import (ELL1_PARAMS, ell1_forward,
                                              ell1_partials)

__all__ = ["ell1_binary", "ell1_binary_reference", "ELL1_PARAMS",
           "launch_counts", "REPLACES", "KERNELS"]

NAME = "ell1_binary"
REPLACES = "pint_tpu/models/binary/engines.py:440"
#: the four ``__global__`` instantiations of ``csrc/ell1_binary.cu``, by
#: (ELL1k, partials asked for): ``ell1_binary_primal<false>`` and so on
KERNELS = {(False, False): "ell1_binary_primal",
           (False, True): "ell1_binary_dual",
           (True, False): "ell1k_binary_primal",
           (True, True): "ell1k_binary_dual"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)

NPARTIAL = len(ELL1_PARAMS) + 1


def ell1_binary_reference(ttasc, params, ell1k: bool = False,
                          partials: bool = True):
    """Plain PyTorch version of K4: ``(delay, P)`` with ``P`` (B, N, 14)
    the local partials (None when ``partials`` is False); the arithmetic is
    :func:`~pint_torch.models.binary.engines.ell1_forward` and, for the
    partials, :func:`~pint_torch.models.binary.engines.ell1_partials`."""
    B, N = ttasc.shape
    p = {k: params[:, i:i + 1] for i, k in enumerate(ELL1_PARAMS)}
    f = ell1_forward(p, ttasc, ell1k)
    delay = f["delay"].expand(B, N)
    if not partials:
        return delay, None
    return delay, ell1_partials(p, ttasc, f, ell1k).expand(B, N, NPARTIAL)


def _lib():
    lib = _build.load(NAME)
    fn = lib.ell1_binary_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(ttasc, params, ell1k, partials):
    B, N = ttasc.shape
    delay = torch.empty((B, N), dtype=F64, device=ttasc.device)
    P = torch.empty((B, N, NPARTIAL), dtype=F64, device=ttasc.device) \
        if partials else None
    rc = _lib().ell1_binary_launch(
        _build.ptr(ttasc), _build.ptr(params), B, N, int(bool(ell1k)),
        _build.ptr(delay), _build.ptr(P) if partials else None,
        _build.stream_of(ttasc))
    launch_counts[KERNELS[(bool(ell1k), bool(partials))]] += 1
    _build.check(NAME, rc)
    return delay, P


def _run(ttasc, params, ell1k, partials):
    if ttasc.dtype != F64 or params.dtype != F64 \
            or ttasc.device != params.device or ttasc.ndim != 2 \
            or params.ndim != 2 or params.shape[1] != len(ELL1_PARAMS):
        raise ValueError(
            f"ell1_binary: ttasc {tuple(ttasc.shape)} {ttasc.dtype} on "
            f"{ttasc.device}, params {tuple(params.shape)} {params.dtype} on "
            f"{params.device}; want float64 (B,N) and (B,{len(ELL1_PARAMS)}) "
            "on one device")
    B = max(ttasc.shape[0], params.shape[0])
    ttasc = ttasc.expand(B, ttasc.shape[1]).contiguous()
    params = params.expand(B, params.shape[1]).contiguous()
    if ttasc.is_cuda:
        return _launch(ttasc, params, ell1k, partials)
    if ttasc.device.type != "cpu":
        raise ValueError(f"ell1_binary: no kernel for device {ttasc.device}")
    return ell1_binary_reference(ttasc, params, ell1k, partials)


class ELL1BinaryFn(torch.autograd.Function):
    """K4 under autodiff: forward returns ``(delay, P)``; ``jvp`` contracts
    tangents with ``P``; ``vmap`` folds a vmapped axis into B.  ``ell1k``
    is a plain bool."""

    @staticmethod
    def forward(ttasc, params, ell1k):
        return _run(ttasc, params, ell1k, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(output[1])

    @staticmethod
    def jvp(ctx, d_ttasc, d_params, _d_ell1k):
        (P,) = ctx.saved_tensors
        out = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_ttasc is not None:
            out = out + d_ttasc * P[..., 0]
        if d_params is not None:
            out = out + (P[..., 1:] @ d_params.unsqueeze(-1)).squeeze(-1)
        return out, None

    @staticmethod
    def vmap(info, in_dims, ttasc, params, ell1k):
        V = info.batch_size
        t = ttasc.movedim(in_dims[0], 0) if in_dims[0] is not None \
            else ttasc.expand(V, *ttasc.shape)
        p = params.movedim(in_dims[1], 0) if in_dims[1] is not None \
            else params.expand(V, *params.shape)
        B = max(t.shape[1], p.shape[1])
        N = t.shape[2]
        d, P = ELL1BinaryFn.apply(
            t.expand(V, B, N).reshape(V * B, N),
            p.expand(V, B, p.shape[2]).reshape(V * B, -1), ell1k)
        return (d.reshape(V, B, N), P.reshape(V, B, N, NPARTIAL)), (0, 0)


def ell1_binary(ttasc, params, ell1k: bool = False):
    """K4: the ELL1 (``ell1k``: ELL1k) delay (B, N) (see the module
    docstring)."""
    if _build.traced(ttasc, params):
        return ELL1BinaryFn.apply(ttasc, params, bool(ell1k))[0]
    return _run(ttasc, params, ell1k, False)[0]
