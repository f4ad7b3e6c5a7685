"""K4 ``ell1_binary``: the ELL1 family's binary delay with local partials.

Replaces ``pint_tpu/models/binary/engines.py``'s ``orbits_pb``,
``ell1_eps``, ``ell1_roemer_terms``, ``ell1_inverse_delay``, ``ell1_delay``,
``ell1k_delay``, ``_h3_fourier_harms`` and ``ell1h_delay``
(``engines.py:355-495``) as called by the ``binary_delay`` of
``BinaryELL1``, ``BinaryELL1k`` and ``BinaryELL1H``
(``components.py:625,693,717``).  Inputs with a leading batch axis B:
``ttasc`` (B, N) seconds since TASC (barycentric, delay-corrected) and
``params`` (B, n) in the order of the mode's row (:data:`ELL1_PARAMS`,
13, for ELL1 and ELL1k; :data:`ELL1H_PARAMS`, 14, for ELL1H); ``mode``
picks the form: ``ELL1``, ``ELL1K`` (ELL1k's rotating/exponential
eccentricity and first-order Dre; False and True stand for these two),
``ELL1H_EXACT`` or ``ELL1H_HARMONIC`` (the orthometric Shapiro delay,
exact or as harmonics 3..``nharms`` of stigma = STIGMA or, with
``use_h4``, H4/H3).  Returns the delay (B, N) in seconds; the local
partials (B, N, 1 + n) with respect to ttasc and the row, from the
kernel's reverse sweep, feed the ``jvp`` of the
:class:`torch.autograd.Function`.

On a CUDA tensor this launches ``csrc/ell1_binary.cu`` (or raises); on a
CPU tensor it runs :func:`ell1_binary_reference`, the plain PyTorch twin.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build
from pint_torch.models.binary.engines import (ELL1, ELL1_PARAMS,
                                              ELL1H_EXACT, ELL1H_HARMONIC,
                                              ELL1H_PARAMS, ELL1K,
                                              ell1_forward, ell1_params,
                                              ell1_partials)

__all__ = ["ell1_binary", "ell1_binary_reference", "ELL1_PARAMS",
           "ELL1H_PARAMS", "ELL1", "ELL1K", "ELL1H_EXACT", "ELL1H_HARMONIC",
           "launch_counts", "REPLACES", "KERNELS", "npartial"]

NAME = "ell1_binary"
REPLACES = "pint_tpu/models/binary/engines.py:440"
#: the reference function each mode replaces
REPLACES_OF = {ELL1: REPLACES, ELL1K: "pint_tpu/models/binary/engines.py:450",
               ELL1H_EXACT: "pint_tpu/models/binary/engines.py:474",
               ELL1H_HARMONIC: "pint_tpu/models/binary/engines.py:474"}
#: the eight ``__global__`` instantiations of ``csrc/ell1_binary.cu``, by
#: (mode, partials asked for): ``ell1_binary_primal<ELL1>`` and so on
KERNELS = {(ELL1, False): "ell1_binary_primal",
           (ELL1, True): "ell1_binary_dual",
           (ELL1K, False): "ell1k_binary_primal",
           (ELL1K, True): "ell1k_binary_dual",
           (ELL1H_EXACT, False): "ell1h_exact_binary_primal",
           (ELL1H_EXACT, True): "ell1h_exact_binary_dual",
           (ELL1H_HARMONIC, False): "ell1h_harmonic_binary_primal",
           (ELL1H_HARMONIC, True): "ell1h_harmonic_binary_dual"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)


def npartial(mode) -> int:
    """Partials per element of ``mode``: ttasc and its row."""
    return len(ell1_params(mode)) + 1


def ell1_binary_reference(ttasc, params, mode=ELL1, partials: bool = True,
                          nharms: int = 7, use_h4: bool = False):
    """Plain PyTorch version of K4: ``(delay, P)`` with ``P`` (B, N,
    :func:`npartial`) the local partials (None when ``partials`` is
    False); the arithmetic is
    :func:`~pint_torch.models.binary.engines.ell1_forward` and, for the
    partials, :func:`~pint_torch.models.binary.engines.ell1_partials`."""
    B, N = ttasc.shape
    p = {k: params[:, i:i + 1] for i, k in enumerate(ell1_params(mode))}
    f = ell1_forward(p, ttasc, mode, nharms, use_h4)
    delay = f["delay"].expand(B, N)
    if not partials:
        return delay, None
    return delay, ell1_partials(p, ttasc, f, mode, nharms, use_h4).expand(
        B, N, npartial(mode))


def _lib():
    lib = _build.load(NAME)
    fn = lib.ell1_binary_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(ttasc, params, mode, partials, nharms=7, use_h4=False):
    B, N = ttasc.shape
    delay = torch.empty((B, N), dtype=F64, device=ttasc.device)
    P = torch.empty((B, N, npartial(mode)), dtype=F64,
                    device=ttasc.device) if partials else None
    rc = _lib().ell1_binary_launch(
        _build.ptr(ttasc), _build.ptr(params), B, N, int(mode), int(nharms),
        int(bool(use_h4)), _build.ptr(delay),
        _build.ptr(P) if partials else None, _build.stream_of(ttasc))
    launch_counts[KERNELS[(int(mode), bool(partials))]] += 1
    _build.check(NAME, rc)
    return delay, P


def _run(ttasc, params, mode, partials, nharms, use_h4):
    npar = len(ell1_params(mode))
    if ttasc.dtype != F64 or params.dtype != F64 \
            or ttasc.device != params.device or ttasc.ndim != 2 \
            or params.ndim != 2 or params.shape[1] != npar \
            or int(mode) not in (ELL1, ELL1K, ELL1H_EXACT, ELL1H_HARMONIC):
        raise ValueError(
            f"ell1_binary: ttasc {tuple(ttasc.shape)} {ttasc.dtype} on "
            f"{ttasc.device}, params {tuple(params.shape)} {params.dtype} on "
            f"{params.device}, mode {mode!r}; want float64 (B,N) and "
            f"(B,{npar}) on one device and a mode of 0-3")
    B = max(ttasc.shape[0], params.shape[0])
    ttasc = ttasc.expand(B, ttasc.shape[1]).contiguous()
    params = params.expand(B, params.shape[1]).contiguous()
    if ttasc.is_cuda:
        return _launch(ttasc, params, mode, partials, nharms, use_h4)
    if ttasc.device.type != "cpu":
        raise ValueError(f"ell1_binary: no kernel for device {ttasc.device}")
    return ell1_binary_reference(ttasc, params, mode, partials, nharms,
                                 use_h4)


class ELL1BinaryFn(torch.autograd.Function):
    """K4 under autodiff: forward returns ``(delay, P)``; ``jvp`` contracts
    tangents with ``P``; ``vmap`` folds a vmapped axis into B.  ``mode``,
    ``nharms`` and ``use_h4`` are plain Python values."""

    @staticmethod
    def forward(ttasc, params, mode, nharms=7, use_h4=False):
        return _run(ttasc, params, mode, True, nharms, use_h4)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(output[1])

    @staticmethod
    def jvp(ctx, d_ttasc, d_params, *_):
        (P,) = ctx.saved_tensors
        out = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_ttasc is not None:
            out = out + d_ttasc * P[..., 0]
        if d_params is not None:
            out = out + (P[..., 1:] @ d_params.unsqueeze(-1)).squeeze(-1)
        return out, None

    @staticmethod
    def vmap(info, in_dims, ttasc, params, mode, nharms=7, use_h4=False):
        V = info.batch_size
        t = ttasc.movedim(in_dims[0], 0) if in_dims[0] is not None \
            else ttasc.expand(V, *ttasc.shape)
        p = params.movedim(in_dims[1], 0) if in_dims[1] is not None \
            else params.expand(V, *params.shape)
        B = max(t.shape[1], p.shape[1])
        N = t.shape[2]
        d, P = ELL1BinaryFn.apply(
            t.expand(V, B, N).reshape(V * B, N),
            p.expand(V, B, p.shape[2]).reshape(V * B, -1), mode, nharms,
            use_h4)
        return (d.reshape(V, B, N), P.reshape(V, B, N, P.shape[-1])), (0, 0)


def ell1_binary(ttasc, params, mode=ELL1, nharms: int = 7,
                use_h4: bool = False):
    """K4: the delay (B, N) of the ELL1 family's ``mode`` (see the module
    docstring)."""
    mode, nharms, use_h4 = int(mode), int(nharms), bool(use_h4)
    if _build.traced(ttasc, params):
        return ELL1BinaryFn.apply(ttasc, params, mode, nharms, use_h4)[0]
    return _run(ttasc, params, mode, False, nharms, use_h4)[0]
