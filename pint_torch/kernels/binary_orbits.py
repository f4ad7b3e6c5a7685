"""K6 ``binary_orbits``: FBX and ORBWAVES orbits with local partials.

Replaces ``pint_tpu/models/binary/engines.py``'s ``orbits_fbx`` and
``orbits_waves`` (``engines.py:68-108``) as ``PulsarBinary._orbits_fn``
(``components.py:168-193``) hands them to every binary engine.  Inputs
with a leading batch axis B: ``tt0`` (B, N) seconds since T0 or TASC and
``coef`` (B, ncoef), the row of
:func:`~pint_torch.models.binary.engines.orbit_coefficients` (FB0..FBn or
PB, then the ORBWAVES C/S pairs and ORBWAVE_OM); ``form`` is ``FBX``,
``WAVES_PB`` or ``WAVES_FBX``; ``tw_off`` the seconds from ORBWAVE_EPOCH
to the binary's epoch (``tw = tt0 + tw_off``).  Returns ``orbits`` and
``pbprime``, (B, N) each; the local partials (B, N, 2, 1 + ncoef) with
respect to tt0 and the coefficients feed the ``jvp`` and the ``backward``
of the :class:`torch.autograd.Function`, through which the orbit-input forms of
K2 and K4 (:mod:`pint_torch.kernels.dd_binary`,
:mod:`pint_torch.kernels.ell1_binary`) reach the fitted FBn, ORBWAVE
amplitudes and frequency.

On a CUDA tensor this launches ``csrc/binary_orbits.cu`` (or raises); on
a CPU tensor it runs :func:`binary_orbits_reference`, the plain PyTorch
twin.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build
from pint_torch.kernels.dual import row_cotangent, toa_cotangent
from pint_torch.models.binary.engines import (FBX, WAVES_FBX, WAVES_PB,
                                              binary_orbits_forward,
                                              binary_orbits_partials)

__all__ = ["binary_orbits", "binary_orbits_reference", "FBX", "WAVES_PB",
           "WAVES_FBX", "launch_counts", "REPLACES", "REPLACES_OF",
           "KERNELS", "ncoef"]

NAME = "binary_orbits"
REPLACES = "pint_tpu/models/binary/engines.py:68"
#: the reference function each form replaces
REPLACES_OF = {FBX: REPLACES,
               WAVES_PB: "pint_tpu/models/binary/engines.py:83",
               WAVES_FBX: "pint_tpu/models/binary/engines.py:83"}
#: the six kernels, by (form, partials asked for); a dual too wide for a
#: one-warp tile in shared memory runs its direct instantiation under the
#: same name
KERNELS = {(f, p): f"binary_orbits_{n}_{'dual' if p else 'primal'}"
           for f, n in ((FBX, "fbx"), (WAVES_PB, "waves_pb"),
                        (WAVES_FBX, "waves_fbx")) for p in (False, True)}
launch_counts = dict.fromkeys(KERNELS.values(), 0)


def ncoef(form, nfb: int, nwaves: int) -> int:
    """The coefficient row's length in ``form``."""
    if form == FBX:
        return nfb
    return (1 if form == WAVES_PB else nfb) + 2 * nwaves + 1


def binary_orbits_reference(tt0, coef, form, nfb: int, nwaves: int,
                            tw_off: float = 0.0, partials: bool = True):
    """Plain PyTorch version of K6: ``(orbits, pbprime, P)``, P (B, N, 2,
    1 + ncoef) or None when ``partials`` is False."""
    B, N = tt0.shape
    f = binary_orbits_forward(tt0, coef, form, nfb, nwaves, tw_off)
    P = binary_orbits_partials(tt0, coef, form, nfb, nwaves, tw_off, f) \
        if partials else None
    return f["orbits"].expand(B, N), f["pbprime"].expand(B, N), P


def _lib():
    lib = _build.load(NAME)
    fn = lib.binary_orbits_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, ci, ci, ctypes.c_double, vp, vp,
                       vp, vp]
        fn.restype = ci
    return lib


def _launch(tt0, coef, form, nfb, nwaves, tw_off, partials):
    B, N = tt0.shape
    orbits = torch.empty((B, N), dtype=F64, device=tt0.device)
    pbprime = torch.empty((B, N), dtype=F64, device=tt0.device)
    P = torch.empty((B, N, 2, 1 + coef.shape[1]), dtype=F64,
                    device=tt0.device) if partials else None
    rc = _lib().binary_orbits_launch(
        _build.ptr(tt0), _build.ptr(coef), B, N, int(form), int(nfb),
        int(nwaves), float(tw_off), _build.ptr(orbits), _build.ptr(pbprime),
        _build.ptr(P) if partials else None, _build.stream_of(tt0))
    launch_counts[KERNELS[(int(form), bool(partials))]] += 1
    _build.check(NAME, rc)
    return orbits, pbprime, P


def _run(tt0, coef, form, nfb, nwaves, tw_off, partials):
    if tt0.dtype != F64 or coef.dtype != F64 or tt0.device != coef.device \
            or tt0.ndim != 2 or coef.ndim != 2 \
            or form not in (FBX, WAVES_PB, WAVES_FBX) \
            or coef.shape[1] != ncoef(form, nfb, nwaves) \
            or (form != WAVES_PB and nfb < 1) \
            or (form != FBX and nwaves < 1):
        raise ValueError(
            f"binary_orbits: tt0 {tuple(tt0.shape)} {tt0.dtype} on "
            f"{tt0.device}, coef {tuple(coef.shape)} {coef.dtype} on "
            f"{coef.device}, form {form!r}, nfb {nfb}, nwaves {nwaves}; want "
            "float64 (B,N) and (B,ncoef) on one device, a form of 0-2 and "
            "the coefficient count it implies")
    B = max(tt0.shape[0], coef.shape[0])
    tt0 = tt0.expand(B, tt0.shape[1]).contiguous()
    coef = coef.expand(B, coef.shape[1]).contiguous()
    if tt0.is_cuda:
        return _launch(tt0, coef, form, nfb, nwaves, tw_off, partials)
    if tt0.device.type != "cpu":
        raise ValueError(f"binary_orbits: no kernel for device {tt0.device}")
    return binary_orbits_reference(tt0, coef, form, nfb, nwaves, tw_off,
                                   partials)


class BinaryOrbitsFn(torch.autograd.Function):
    """K6 under autodiff: forward returns ``(orbits, pbprime, P)``; ``jvp``
    contracts the tangents of tt0 and the coefficients with ``P``,
    ``backward`` the two outputs' cotangents with it; ``vmap`` folds a vmapped axis into B.  ``form``, ``nfb``, ``nwaves``
    and ``tw_off`` are plain Python values."""

    @staticmethod
    def forward(tt0, coef, form, nfb, nwaves, tw_off):
        return _run(tt0, coef, form, nfb, nwaves, tw_off, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_forward(output[2])
        ctx.save_for_backward(output[2])
        ctx.shapes = (inputs[0].shape, inputs[1].shape)

    @staticmethod
    def jvp(ctx, d_tt0, d_coef, *_):
        (P,) = ctx.saved_tensors
        out = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_tt0 is not None:
            out = out + d_tt0.unsqueeze(-1) * P[..., 0]
        if d_coef is not None:
            out = out + (P[..., 1:] @ d_coef[:, None, :, None]).squeeze(-1)
        return out[..., 0], out[..., 1], None

    @staticmethod
    def backward(ctx, g_orb, g_pbp, _gP):
        (P,) = ctx.saved_tensors
        G = g_orb.unsqueeze(-1) * P[..., 0, :] \
            + g_pbp.unsqueeze(-1) * P[..., 1, :]
        ones = torch.ones_like(g_orb)
        return (toa_cotangent(ones, G[..., 0], ctx.shapes[0]),
                row_cotangent(ones, G[..., 1:], ctx.shapes[1]),
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, tt0, coef, form, nfb, nwaves, tw_off):
        V = info.batch_size
        t = tt0.movedim(in_dims[0], 0) if in_dims[0] is not None \
            else tt0.expand(V, *tt0.shape)
        c = coef.movedim(in_dims[1], 0) if in_dims[1] is not None \
            else coef.expand(V, *coef.shape)
        B = max(t.shape[1], c.shape[1])
        N = t.shape[2]
        o, pb, P = BinaryOrbitsFn.apply(
            t.expand(V, B, N).reshape(V * B, N),
            c.expand(V, B, c.shape[2]).reshape(V * B, -1), form, nfb, nwaves,
            tw_off)
        return ((o.reshape(V, B, N), pb.reshape(V, B, N),
                 P.reshape(V, B, N, *P.shape[2:])), (0, 0, 0))


def binary_orbits(tt0, coef, form, nfb: int, nwaves: int,
                  tw_off: float = 0.0):
    """K6: ``(orbits, pbprime)``, (B, N) each (see the module
    docstring)."""
    form, nfb, nwaves, tw_off = int(form), int(nfb), int(nwaves), \
        float(tw_off)
    if _build.traced(tt0, coef):
        return BinaryOrbitsFn.apply(tt0, coef, form, nfb, nwaves, tw_off)[:2]
    return _run(tt0, coef, form, nfb, nwaves, tw_off, False)[:2]
