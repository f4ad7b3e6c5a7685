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
``use_h4``, H4/H3); for FBX or ORBWAVES orbits, ``orb``: the orbits and
pbprime of K6 (:mod:`pint_torch.kernels.binary_orbits`), (B, N) each, in
place of PB/PBDOT/XPBDOT's (``engines.py:111``).  Returns the delay
(B, N) in seconds; the local partials (B, N, :func:`npartial`) with
respect to ttasc and the row -- with orbit inputs, orbits and pbprime in
place of PB and PBDOT and none for XPBDOT
(:func:`~pint_torch.models.binary.engines.ell1_columns`) -- from the
kernel's reverse sweep, feed the ``jvp`` and the ``backward`` of the
:class:`torch.autograd.Function`.

On a CUDA tensor this launches ``csrc/ell1_binary.cu`` (or raises); on a
CPU tensor it runs :func:`ell1_binary_reference`, the plain PyTorch twin.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build
from pint_torch.kernels.dual import row_cotangent, sum_to, toa_cotangent
from pint_torch.models.binary.engines import (ELL1, ELL1_PARAMS,
                                              ELL1H_EXACT, ELL1H_HARMONIC,
                                              ELL1H_PARAMS, ELL1K,
                                              ell1_columns, ell1_forward,
                                              ell1_params, ell1_partials)

__all__ = ["ell1_binary", "ell1_binary_reference", "ELL1_PARAMS",
           "ELL1H_PARAMS", "ELL1", "ELL1K", "ELL1H_EXACT", "ELL1H_HARMONIC",
           "launch_counts", "REPLACES", "KERNELS", "npartial"]

NAME = "ell1_binary"
REPLACES = "pint_tpu/models/binary/engines.py:440"
#: the reference function each mode replaces
REPLACES_OF = {ELL1: REPLACES, ELL1K: "pint_tpu/models/binary/engines.py:450",
               ELL1H_EXACT: "pint_tpu/models/binary/engines.py:474",
               ELL1H_HARMONIC: "pint_tpu/models/binary/engines.py:474"}
_MODE_NAME = {ELL1: "ell1", ELL1K: "ell1k", ELL1H_EXACT: "ell1h_exact",
              ELL1H_HARMONIC: "ell1h_harmonic"}
#: the sixteen ``__global__`` instantiations of ``csrc/ell1_binary.cu``, by
#: (mode, partials asked for) on PB orbits -- ``ell1_binary_primal<ELL1,
#: false>`` and so on -- and by (mode, partials, True) with orbit inputs
KERNELS = {(m, p): f"{n}_binary_{'dual' if p else 'primal'}"
           for m, n in _MODE_NAME.items() for p in (False, True)}
KERNELS.update({(m, p, True): f"{n}_binary_orbit_"
                f"{'dual' if p else 'primal'}"
                for m, n in _MODE_NAME.items() for p in (False, True)})
launch_counts = dict.fromkeys(KERNELS.values(), 0)


def npartial(mode, orbit: bool = False) -> int:
    """Partials per element of ``mode``: ttasc and its row, one fewer with
    orbit inputs."""
    return len(ell1_columns(mode, orbit))


def ell1_binary_reference(ttasc, params, mode=ELL1, partials: bool = True,
                          nharms: int = 7, use_h4: bool = False, orb=None):
    """Plain PyTorch version of K4: ``(delay, P)`` with ``P`` (B, N,
    :func:`npartial`) the local partials (None when ``partials`` is
    False); the arithmetic is
    :func:`~pint_torch.models.binary.engines.ell1_forward` and, for the
    partials, :func:`~pint_torch.models.binary.engines.ell1_partials`."""
    B, N = ttasc.shape
    p = {k: params[:, i:i + 1] for i, k in enumerate(ell1_params(mode))}
    f = ell1_forward(p, ttasc, mode, nharms, use_h4, orb)
    delay = f["delay"].expand(B, N)
    if not partials:
        return delay, None
    orbit = orb is not None
    return delay, ell1_partials(p, ttasc, f, mode, nharms, use_h4,
                                orbit).expand(B, N, npartial(mode, orbit))


def _lib():
    lib = _build.load(NAME)
    fn = lib.ell1_binary_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    return lib


def _kernel(mode, partials, orbit):
    return KERNELS[(int(mode), bool(partials), True) if orbit
                   else (int(mode), bool(partials))]


def _launch(ttasc, params, mode, partials, nharms=7, use_h4=False,
            orb=None):
    B, N = ttasc.shape
    orbit = orb is not None
    delay = torch.empty((B, N), dtype=F64, device=ttasc.device)
    P = torch.empty((B, N, npartial(mode, orbit)), dtype=F64,
                    device=ttasc.device) if partials else None
    o = [None, None] if orb is None else [_build.ptr(v) for v in orb]
    rc = _lib().ell1_binary_launch(
        _build.ptr(ttasc), _build.ptr(params), *o, B, N, int(mode),
        int(nharms), int(bool(use_h4)), _build.ptr(delay),
        _build.ptr(P) if partials else None, _build.stream_of(ttasc))
    launch_counts[_kernel(mode, partials, orbit)] += 1
    _build.check(NAME, rc)
    return delay, P


def _run(ttasc, params, mode, partials, nharms, use_h4, orb=None):
    npar = len(ell1_params(mode))
    ts = [ttasc] + list(orb or ())
    if any(t.dtype != F64 or t.device != params.device or t.ndim != 2
           for t in ts) or params.dtype != F64 \
            or params.ndim != 2 or params.shape[1] != npar \
            or int(mode) not in (ELL1, ELL1K, ELL1H_EXACT, ELL1H_HARMONIC) \
            or (orb is not None and len(orb) != 2):
        raise ValueError(
            f"ell1_binary: ttasc {tuple(ttasc.shape)} {ttasc.dtype} on "
            f"{ttasc.device}, params {tuple(params.shape)} {params.dtype} on "
            f"{params.device}, mode {mode!r}, {len(orb or ())} orbit "
            f"inputs; want float64 (B,N) and (B,{npar}) on one device, a "
            "mode of 0-3 and none or both of orbits and pbprime")
    B = max([params.shape[0]] + [t.shape[0] for t in ts])
    N = ttasc.shape[1]
    ttasc = ttasc.expand(B, N).contiguous()
    params = params.expand(B, params.shape[1]).contiguous()
    if orb is not None:
        orb = tuple(v.expand(B, N).contiguous() for v in orb)
    if ttasc.is_cuda:
        return _launch(ttasc, params, mode, partials, nharms, use_h4, orb)
    if ttasc.device.type != "cpu":
        raise ValueError(f"ell1_binary: no kernel for device {ttasc.device}")
    return ell1_binary_reference(ttasc, params, mode, partials, nharms,
                                 use_h4, orb)


class ELL1BinaryFn(torch.autograd.Function):
    """K4 under autodiff: forward returns ``(delay, P)``; ``jvp`` contracts
    tangents with ``P`` (the orbit inputs' through their two columns),
    ``backward`` the delay's cotangent through the same columns; ``vmap``
    folds a vmapped axis into B.  ``mode``, ``nharms`` and
    ``use_h4`` are plain Python values; ``orbits`` and ``pbprime`` the
    orbit inputs (None on PB orbits)."""

    @staticmethod
    def forward(ttasc, params, mode, nharms=7, use_h4=False, orbits=None,
                pbprime=None):
        orb = None if orbits is None else (orbits, pbprime)
        return _run(ttasc, params, mode, True, nharms, use_h4, orb)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(output[1])
        ctx.save_for_backward(output[1])
        ctx.orbit = len(inputs) > 5 and inputs[5] is not None
        ctx.n_in = len(inputs)
        ctx.shapes = tuple(None if t is None else t.shape
                           for t in inputs[:2] + inputs[5:])

    @staticmethod
    def jvp(ctx, d_ttasc, d_params, _mode=None, _nharms=None, _use_h4=None,
            d_orb=None, d_pbp=None):
        (P,) = ctx.saved_tensors
        out = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_ttasc is not None:
            out = out + d_ttasc * P[..., 0]
        if ctx.orbit:
            for i, d in enumerate((d_orb, d_pbp)):
                if d is not None:
                    out = out + d * P[..., 1 + i]
            if d_params is not None:
                out = out + (P[..., 3:] @ d_params[..., 3:].unsqueeze(-1)) \
                    .squeeze(-1)
        elif d_params is not None:
            out = out + (P[..., 1:] @ d_params.unsqueeze(-1)).squeeze(-1)
        return out, None

    @staticmethod
    def backward(ctx, grad, _gP):
        (P,) = ctx.saved_tensors
        sh_t, sh_p, *sh_o = ctx.shapes + (None,) * (4 - len(ctx.shapes))
        g_t = toa_cotangent(grad, P[..., 0], sh_t)
        if ctx.orbit:
            g_orb = [toa_cotangent(grad, P[..., 1 + i], sh_o[i])
                     for i in range(2)]
            # PB, PBDOT and XPBDOT have no column with orbit inputs
            g3 = row_cotangent(grad, P[..., 3:], P.shape[:1] + (
                P.shape[-1] - 3,))
            g_p = sum_to(torch.cat([torch.zeros_like(g3[..., :3]), g3],
                                   dim=-1), sh_p)
        else:
            g_orb = [None, None]
            g_p = row_cotangent(grad, P[..., 1:], sh_p)
        return (g_t, g_p, None, None, None, *g_orb)[:ctx.n_in]

    @staticmethod
    def vmap(info, in_dims, ttasc, params, mode, nharms=7, use_h4=False,
             orbits=None, pbprime=None):
        V = info.batch_size
        dims = list(in_dims) + [None] * (7 - len(in_dims))

        def lead(t, dim):
            if t is None:
                return None
            return t.movedim(dim, 0) if dim is not None \
                else t.expand(V, *t.shape)

        t = lead(ttasc, dims[0])
        p = lead(params, dims[1])
        orb = [lead(v, d) for v, d in zip((orbits, pbprime), dims[5:])]
        B = max([t.shape[1], p.shape[1]]
                + [v.shape[1] for v in orb if v is not None])
        N = t.shape[2]

        def fold(v):
            return None if v is None else v.expand(V, B, N).reshape(V * B, N)

        d, P = ELL1BinaryFn.apply(
            fold(t), p.expand(V, B, p.shape[2]).reshape(V * B, -1), mode,
            nharms, use_h4, *(fold(v) for v in orb))
        return (d.reshape(V, B, N), P.reshape(V, B, N, P.shape[-1])), (0, 0)


def ell1_binary(ttasc, params, mode=ELL1, nharms: int = 7,
                use_h4: bool = False, orb=None):
    """K4: the delay (B, N) of the ELL1 family's ``mode`` (see the module
    docstring); ``orb`` the orbit inputs (orbits, pbprime)."""
    mode, nharms, use_h4 = int(mode), int(nharms), bool(use_h4)
    if _build.traced(ttasc, params, *(orb or ())):
        return ELL1BinaryFn.apply(ttasc, params, mode, nharms, use_h4,
                                  *(orb or (None, None)))[0]
    return _run(ttasc, params, mode, False, nharms, use_h4, orb)[0]
