"""K2 ``dd_binary``: the Damour-Deruelle binary delay with local partials.

Replaces ``pint_tpu/models/binary/engines.py``'s ``orbits_pb``,
``solve_kepler``, ``dd_state`` and ``dd_delay_core`` (``engines.py:38-226``)
as called by ``BinaryDD.delay_func`` (``components.py:195-205``).  Inputs
with a leading batch axis B: ``tt0`` (B, N) seconds since T0 (barycentric,
delay-corrected) and ``params`` (B, 16) in the order :data:`DD_PARAMS`.
Returns the delay (B, N) in seconds; the local partials (B, N, 17) with
respect to tt0 and the 16 parameters feed the ``jvp`` of the
:class:`torch.autograd.Function`.

On a CUDA tensor this launches ``csrc/dd_binary.cu`` (or raises); on a CPU
tensor it runs :func:`dd_binary_reference`, the plain PyTorch twin.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build
from pint_torch.kernels.dual import seed
from pint_torch.models.binary.engines import DD_PARAMS, dd_delay

__all__ = ["dd_binary", "dd_binary_reference", "DD_PARAMS", "launch_counts",
           "REPLACES"]

NAME = "dd_binary"
REPLACES = "pint_tpu/models/binary/engines.py:185"
#: the two ``__global__`` instantiations of ``csrc/dd_binary.cu``, by
#: whether the partials are asked for
KERNELS = {False: "dd_binary_primal", True: "dd_binary_dual"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)

NPARTIAL = len(DD_PARAMS) + 1

def dd_binary_reference(tt0, params, partials: bool = True):
    """Plain PyTorch version of K2: ``(delay, P)`` with ``P`` (B, N, 17)
    the local partials (None when ``partials`` is False); the arithmetic is
    :func:`pint_torch.models.binary.engines.dd_delay`."""
    B, N = tt0.shape
    if partials:
        p = {k: seed(params[:, i:i + 1], i + 1, NPARTIAL)
             for i, k in enumerate(DD_PARAMS)}
        r = dd_delay(p, seed(tt0, 0, NPARTIAL))
        return r.v.expand(B, N), r.d.expand(B, N, NPARTIAL)
    p = {k: params[:, i:i + 1] for i, k in enumerate(DD_PARAMS)}
    return dd_delay(p, tt0).expand(B, N), None


def _lib():
    lib = _build.load(NAME)
    fn = lib.dd_binary_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(tt0, params, partials):
    B, N = tt0.shape
    delay = torch.empty((B, N), dtype=F64, device=tt0.device)
    P = torch.empty((B, N, NPARTIAL), dtype=F64, device=tt0.device) \
        if partials else None
    rc = _lib().dd_binary_launch(
        _build.ptr(tt0), _build.ptr(params), B, N, _build.ptr(delay),
        _build.ptr(P) if partials else None, _build.stream_of(tt0))
    launch_counts[KERNELS[bool(partials)]] += 1
    _build.check(NAME, rc)
    return delay, P


def _run(tt0, params, partials):
    if tt0.dtype != F64 or params.dtype != F64 or tt0.device != params.device \
            or tt0.ndim != 2 or params.ndim != 2 \
            or params.shape[1] != len(DD_PARAMS):
        raise ValueError(
            f"dd_binary: tt0 {tuple(tt0.shape)} {tt0.dtype} on {tt0.device}, "
            f"params {tuple(params.shape)} {params.dtype} on {params.device}; "
            f"want float64 (B,N) and (B,{len(DD_PARAMS)}) on one device")
    B = max(tt0.shape[0], params.shape[0])
    tt0 = tt0.expand(B, tt0.shape[1]).contiguous()
    params = params.expand(B, params.shape[1]).contiguous()
    if tt0.is_cuda:
        return _launch(tt0, params, partials)
    if tt0.device.type != "cpu":
        raise ValueError(f"dd_binary: no kernel for device {tt0.device}")
    return dd_binary_reference(tt0, params, partials)


class DDBinaryFn(torch.autograd.Function):
    """K2 under autodiff: forward returns ``(delay, P)``; ``jvp`` contracts
    tangents with ``P``; ``vmap`` folds a vmapped axis into B."""

    @staticmethod
    def forward(tt0, params):
        return _run(tt0, params, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(output[1])

    @staticmethod
    def jvp(ctx, d_tt0, d_params):
        (P,) = ctx.saved_tensors
        out = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_tt0 is not None:
            out = out + d_tt0 * P[..., 0]
        if d_params is not None:
            out = out + (P[..., 1:] @ d_params.unsqueeze(-1)).squeeze(-1)
        return out, None

    @staticmethod
    def vmap(info, in_dims, tt0, params):
        V = info.batch_size
        t = tt0.movedim(in_dims[0], 0) if in_dims[0] is not None \
            else tt0.expand(V, *tt0.shape)
        p = params.movedim(in_dims[1], 0) if in_dims[1] is not None \
            else params.expand(V, *params.shape)
        B = max(t.shape[1], p.shape[1])
        N = t.shape[2]
        d, P = DDBinaryFn.apply(t.expand(V, B, N).reshape(V * B, N),
                                p.expand(V, B, p.shape[2]).reshape(V * B, -1))
        return (d.reshape(V, B, N), P.reshape(V, B, N, NPARTIAL)), (0, 0)


def dd_binary(tt0, params):
    """K2: the DD delay (B, N) (see the module docstring)."""
    if _build.traced(tt0, params):
        return DDBinaryFn.apply(tt0, params)[0]
    return _run(tt0, params, False)[0]
