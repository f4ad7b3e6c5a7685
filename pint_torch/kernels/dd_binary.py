"""K2 ``dd_binary``: the DD family's binary delay with local partials.

Replaces ``pint_tpu/models/binary/engines.py``'s ``orbits_pb``,
``solve_kepler``, ``dd_state`` and ``dd_delay_core`` (``engines.py:38-226``)
as called by ``BinaryDD.delay_func`` (``components.py:195-205``), and with
them, by ``mode``: ``bt_delay`` (``engines.py:135``, BT), ``dds_delay`` and
``ddh_delay`` (``:227,239``: DD on a reparameterized row, see
:func:`~pint_torch.models.binary.engines.dds_sini` and
:func:`~pint_torch.models.binary.engines.ddh_sini_m2`), ``ddgr_delay``
(``:266``, DDGR, its row from
:func:`~pint_torch.models.binary.engines.ddgr_row`) and ``ddk_delay``
(``:338``, DDK, with the per-TOA corrections of
:func:`~pint_torch.models.binary.engines.ddk_corrections`) and
``BinaryBT_piecewise.delay_func`` (``components.py:721-790``, BTX: BT
with a per-TOA a1).  Inputs with a leading batch axis B: ``tt0`` (B, N)
seconds since T0 (barycentric, delay-corrected), ``params`` (B, 16) in
the order of the mode's row (:data:`DD_PARAMS`, or :data:`DDGR_PARAMS`
for DDGR), for DDK ``toa``: the per-TOA d_a1, d_om and sini, for BTX
``toa``: the per-TOA a1, (B, N) each, and, for FBX or ORBWAVES orbits,
``orb``: the orbits and pbprime of K6
(:mod:`pint_torch.kernels.binary_orbits`), (B, N) each, in place of
PB/PBDOT/XPBDOT's (``engines.py:111``).  Returns the delay (B, N) in
seconds; the local partials (B, N, :func:`npartial`) with respect to
tt0, the orbit inputs, the row entries the mode reads and the per-TOA
inputs (:func:`~pint_torch.models.binary.engines.partial_columns`: 17 in
DD and DDGR, 11 in BT and BTX, 19 in DDK; one fewer with orbit inputs),
from the kernel's reverse sweep, feed the ``jvp`` and the ``backward`` of
the :class:`torch.autograd.Function`.

On a CUDA tensor this launches ``csrc/dd_binary.cu`` (or raises); on a
CPU tensor it runs :func:`dd_binary_reference`, the plain PyTorch twin.
"""

from __future__ import annotations

import ctypes

import torch

from pint_torch import F64
from pint_torch.kernels import _build
from pint_torch.kernels.dual import row_cotangent, sum_to, toa_cotangent
from pint_torch.models.binary.engines import (BT, BTX, DD, DD_PARAMS,
                                              DDGR, DDGR_PARAMS, DDK,
                                              DDK_TOA_INPUTS, bt_forward,
                                              bt_partials, dd_forward,
                                              dd_partials, kepler_inputs,
                                              npartial, partial_columns,
                                              row_params, toa_inputs)

__all__ = ["dd_binary", "dd_binary_reference", "DD_PARAMS", "DDGR_PARAMS",
           "DD", "BT", "DDGR", "DDK", "BTX", "MODES", "launch_counts",
           "REPLACES", "REPLACES_OF", "KERNELS", "KEPLER_EXITS",
           "kepler_exit", "kepler_steps", "npartial", "ROW_COLUMNS"]

NAME = "dd_binary"
REPLACES = "pint_tpu/models/binary/engines.py:185"
#: the reference function each mode replaces
REPLACES_OF = {DD: REPLACES, BT: "pint_tpu/models/binary/engines.py:135",
               DDGR: "pint_tpu/models/binary/engines.py:266",
               DDK: "pint_tpu/models/binary/engines.py:338",
               BTX: "pint_tpu/models/binary/components.py:769"}
#: the modes, in the kernel's numbering
MODES = (DD, BT, DDGR, DDK, BTX)
_MODE_NAME = {DD: "dd", BT: "bt", DDGR: "ddgr", DDK: "ddk", BTX: "btx"}
#: the twenty ``__global__`` instantiations of ``csrc/dd_binary.cu``, by
#: (mode, partials asked for) on PB orbits -- ``dd_binary_primal<DD,
#: false>`` and so on -- and by (mode, partials, True) with orbit inputs
KERNELS = {(m, p): f"{_MODE_NAME[m]}_binary_{'dual' if p else 'primal'}"
           for m in MODES for p in (False, True)}
KERNELS.update({(m, p, True): f"{_MODE_NAME[m]}_binary_orbit_"
                f"{'dual' if p else 'primal'}"
                for m in MODES for p in (False, True)})
launch_counts = dict.fromkeys(KERNELS.values(), 0)

def _row_columns(mode, orbit: bool = False):
    """The row entries the partials of ``mode`` cover, by their index in
    the row, in column order: those between tt0's (and the orbit inputs')
    columns and the per-TOA inputs'."""
    cols = partial_columns(mode, orbit)
    lead = 3 if orbit else 1
    return [c - 1 for c in cols[lead:len(cols) - len(toa_inputs(mode))]]


#: the row entries each mode's partials cover, by their index in the row,
#: on PB orbits (key mode) and with orbit inputs (key (mode, True))
ROW_COLUMNS = {m: _row_columns(m) for m in MODES}
ROW_COLUMNS.update({(m, True): _row_columns(m, True) for m in MODES})


def _row(params, mode):
    return {k: params[:, i:i + 1] for i, k in enumerate(row_params(mode))}


def dd_binary_reference(tt0, params, partials: bool = True, mode=DD,
                        toa=None, orb=None):
    """Plain PyTorch version of K2: ``(delay, P)`` with ``P`` (B, N,
    :func:`npartial`) the local partials (None when ``partials`` is
    False); the arithmetic is
    :func:`~pint_torch.models.binary.engines.dd_forward` (BT and BTX:
    :func:`~pint_torch.models.binary.engines.bt_forward`) and, for the
    partials, :func:`~pint_torch.models.binary.engines.dd_partials`
    (:func:`~pint_torch.models.binary.engines.bt_partials`)."""
    B, N = tt0.shape
    p = _row(params, mode)
    orbit = orb is not None
    if mode in (BT, BTX):
        f = bt_forward(p, tt0, toa[0] if mode == BTX else None, orb)
    else:
        f = dd_forward(p, tt0, mode,
                       None if toa is None else dict(zip(DDK_TOA_INPUTS, toa)),
                       orb)
    delay = f["delay"].expand(B, N)
    if not partials:
        return delay, None
    P = bt_partials(p, tt0, f, mode, orbit) if mode in (BT, BTX) \
        else dd_partials(p, tt0, f, mode, orbit)
    return delay, P.expand(B, N, npartial(mode, orbit))


#: how the kernel's Kepler solve stops, by the codes of :func:`kepler_steps`
KEPLER_EXITS = ("15 steps", "fixed point", "2-cycle")


def kepler_exit(M, e, niter: int = 15):
    """The kernel's Kepler exit rule in plain PyTorch: ``(E, steps, kind)``
    for mean anomalies ``M`` and eccentricities ``e`` of one shape.

    The clamped Newton map is a function of its iterate's bits, so once an
    iterate repeats the rest of the ``niter`` steps is known: an iterate
    bitwise equal to the one before is fixed, and one equal to the one two
    steps back is a 2-cycle, whose step ``niter`` lands on the iterate of
    its parity.  ``E`` is therefore bitwise the ``niter``-step
    :func:`~pint_torch.models.binary.engines.solve_kepler`; ``steps`` counts
    the Newton steps each element runs before it stops, and ``kind`` is the
    index in :data:`KEPLER_EXITS` of how it stopped."""
    E = prev = M + e * torch.sin(M)
    out = E.clone()
    steps = torch.zeros(E.shape, dtype=torch.int64, device=E.device)
    kind = torch.zeros_like(steps)
    done = torch.zeros(E.shape, dtype=torch.bool, device=E.device)
    for it in range(niter):
        dE = (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
        En = E - torch.where(dE < -1.0, -1.0, torch.where(dE > 1.0, 1.0, dE))
        bits = En.view(torch.int64)
        running = ~done
        steps += running
        fixed = running & (bits == E.view(torch.int64))
        cycle = running & ~fixed & (it > 0) & (bits == prev.view(torch.int64))
        last = En if (niter - 1 - it) % 2 == 0 else E
        out = torch.where(fixed, En, torch.where(cycle, last, out))
        kind = torch.where(fixed, 1, torch.where(cycle, 2, kind))
        done = done | fixed | cycle
        prev, E = E, En
    return torch.where(done, out, E), steps, kind


def kepler_steps(tt0, params):
    """:func:`kepler_exit` on K2's inputs ``tt0`` (B, N) and ``params``
    (B, 16), through the twin's own mean anomaly and eccentricity; used by
    the tests and by ``chip_smoke.py`` to count the Newton steps the
    kernel runs on a path's inputs."""
    B, N = tt0.shape
    _, M, e = kepler_inputs(_row(params, DD), tt0, {})
    return kepler_exit(M.expand(B, N), e.expand(B, N))


def _lib():
    lib = _build.load(NAME)
    fn = lib.dd_binary_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
    return lib


def _kernel(mode, partials, orbit):
    return KERNELS[(int(mode), bool(partials), True) if orbit
                   else (int(mode), bool(partials))]


def _launch(tt0, params, mode, toa, orb, partials):
    B, N = tt0.shape
    orbit = orb is not None
    delay = torch.empty((B, N), dtype=F64, device=tt0.device)
    P = torch.empty((B, N, npartial(mode, orbit)), dtype=F64,
                    device=tt0.device) if partials else None
    x = [None] * 3
    for i, v in enumerate(toa or ()):
        x[i] = _build.ptr(v)
    o = [None, None] if orb is None else [_build.ptr(v) for v in orb]
    rc = _lib().dd_binary_launch(
        _build.ptr(tt0), _build.ptr(params), B, N, int(mode), *x, *o,
        _build.ptr(delay), _build.ptr(P) if partials else None,
        _build.stream_of(tt0))
    launch_counts[_kernel(mode, partials, orbit)] += 1
    _build.check(NAME, rc)
    return delay, P


def _run(tt0, params, mode, toa, orb, partials):
    ts = [tt0, params] + list(toa or ()) + list(orb or ())
    if any(t.dtype != F64 or t.device != tt0.device or t.ndim != 2
           for t in ts) or params.shape[1] != len(DD_PARAMS) \
            or int(mode) not in MODES \
            or len(toa or ()) != len(toa_inputs(int(mode))) \
            or (orb is not None and len(orb) != 2):
        raise ValueError(
            f"dd_binary: tt0 {tuple(tt0.shape)} {tt0.dtype} on {tt0.device}, "
            f"params {tuple(params.shape)} {params.dtype} on {params.device}, "
            f"mode {mode!r}, {len(toa or ())} per-TOA inputs, "
            f"{len(orb or ())} orbit inputs; want float64 (B,N) and "
            f"(B,{len(DD_PARAMS)}) on one device, a mode of 0-4, (B,N) "
            "d_a1, d_om and sini for DDK only, a1 for BTX only, and none or "
            "both of orbits and pbprime")
    B = max(t.shape[0] for t in ts)
    N = tt0.shape[1]
    tt0 = tt0.expand(B, N).contiguous()
    params = params.expand(B, params.shape[1]).contiguous()
    if toa is not None:
        toa = tuple(v.expand(B, N).contiguous() for v in toa)
    if orb is not None:
        orb = tuple(v.expand(B, N).contiguous() for v in orb)
    if tt0.is_cuda:
        return _launch(tt0, params, int(mode), toa, orb, partials)
    if tt0.device.type != "cpu":
        raise ValueError(f"dd_binary: no kernel for device {tt0.device}")
    return dd_binary_reference(tt0, params, partials, int(mode), toa, orb)


class DDBinaryFn(torch.autograd.Function):
    """K2 under autodiff: forward returns ``(delay, P)``; ``jvp`` contracts
    tangents with ``P`` (the orbit inputs' through their two columns, the
    row's through the columns of the entries the mode reads, the per-TOA
    inputs' through the last ones; an entry the mode does not read has no
    column and contributes nothing); ``backward`` maps the delay's
    cotangent back through the same columns; ``vmap`` folds a vmapped axis
    into B.  ``mode`` is a plain Python value; ``x0``, ``x1`` and ``x2`` are
    the per-TOA inputs (DDK's d_a1, d_om and sini; BTX's a1; None where
    the mode has none), ``orbits`` and ``pbprime`` the orbit inputs (None
    on PB orbits), (B, N) each."""

    @staticmethod
    def forward(tt0, params, mode=DD, x0=None, x1=None, x2=None,
                orbits=None, pbprime=None):
        toa = tuple(v for v in (x0, x1, x2) if v is not None) or None
        orb = None if orbits is None else (orbits, pbprime)
        return _run(tt0, params, mode, toa, orb, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(output[1])
        ctx.save_for_backward(output[1])
        ctx.mode = inputs[2] if len(inputs) > 2 else DD
        ctx.orbit = len(inputs) > 6 and inputs[6] is not None
        ctx.n_in = len(inputs)
        ctx.shapes = tuple(None if t is None else t.shape
                           for t in inputs[:2] + inputs[3:])

    @staticmethod
    def jvp(ctx, d_tt0, d_params, _mode=None, d_x0=None, d_x1=None,
            d_x2=None, d_orb=None, d_pbp=None):
        (P,) = ctx.saved_tensors
        out = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_tt0 is not None:
            out = out + d_tt0 * P[..., 0]
        lead = 1
        if ctx.orbit:
            for i, d in enumerate((d_orb, d_pbp)):
                if d is not None:
                    out = out + d * P[..., 1 + i]
            lead = 3
        rows = ROW_COLUMNS[(ctx.mode, True) if ctx.orbit else ctx.mode]
        nr = len(rows)
        if d_params is not None:
            # the mode's entries gathered as views, not by a list index
            # (a host-to-device copy, which a CUDA graph cannot capture)
            dp = d_params if nr == d_params.shape[-1] \
                else torch.stack([d_params[..., r] for r in rows], dim=-1)
            out = out + (P[..., lead:lead + nr] @ dp.unsqueeze(-1)).squeeze(-1)
        for i, d in enumerate((d_x0, d_x1, d_x2)):
            if d is not None:
                out = out + d * P[..., lead + nr + i]
        return out, None

    @staticmethod
    def backward(ctx, grad, _gP):
        (P,) = ctx.saved_tensors
        sh_t, sh_p, *sh_x = ctx.shapes + (None,) * (7 - len(ctx.shapes))
        g_t = toa_cotangent(grad, P[..., 0], sh_t)
        lead = 3 if ctx.orbit else 1
        g_orb = [toa_cotangent(grad, P[..., 1 + i], sh_x[3 + i])
                 if ctx.orbit else None for i in range(2)]
        rows = ROW_COLUMNS[(ctx.mode, True) if ctx.orbit else ctx.mode]
        nr = len(rows)
        g_rows = row_cotangent(grad, P[..., lead:lead + nr],
                               P.shape[:1] + (nr,))
        at = {r: j for j, r in enumerate(rows)}
        zero = torch.zeros_like(g_rows[..., 0])
        g_p = sum_to(torch.stack([g_rows[..., at[c]] if c in at else zero
                                  for c in range(sh_p[-1])], dim=-1), sh_p)
        g_x = [toa_cotangent(grad, P[..., lead + nr + i], sh_x[i])
               if sh_x[i] is not None else None for i in range(3)]
        return (g_t, g_p, None, *g_x, *g_orb)[:ctx.n_in]

    @staticmethod
    def vmap(info, in_dims, tt0, params, mode=DD, x0=None, x1=None,
             x2=None, orbits=None, pbprime=None):
        V = info.batch_size
        dims = list(in_dims) + [None] * (8 - len(in_dims))

        def lead(t, dim):
            if t is None:
                return None
            return t.movedim(dim, 0) if dim is not None \
                else t.expand(V, *t.shape)

        t = lead(tt0, dims[0])
        p = lead(params, dims[1])
        rest = [lead(v, d) for v, d in zip((x0, x1, x2, orbits, pbprime),
                                           dims[3:])]
        B = max([t.shape[1], p.shape[1]]
                + [v.shape[1] for v in rest if v is not None])
        N = t.shape[2]

        def fold(v):
            return None if v is None else v.expand(V, B, N).reshape(V * B, N)

        d, P = DDBinaryFn.apply(fold(t),
                                p.expand(V, B, p.shape[2]).reshape(V * B, -1),
                                mode, *(fold(v) for v in rest))
        return (d.reshape(V, B, N), P.reshape(V, B, N, P.shape[-1])), (0, 0)


def dd_binary(tt0, params, mode=DD, toa=None, orb=None):
    """K2: the delay (B, N) of the DD family's ``mode`` (see the module
    docstring); ``toa`` holds DDK's per-TOA (d_a1, d_om, sini) or BTX's
    (a1,), ``orb`` the orbit inputs (orbits, pbprime)."""
    mode = int(mode)
    if _build.traced(tt0, params, *(toa or ()), *(orb or ())):
        x = list(toa or ()) + [None] * (3 - len(toa or ()))
        return DDBinaryFn.apply(tt0, params, mode, *x,
                                *(orb or (None, None)))[0]
    return _run(tt0, params, mode, toa, orb, False)[0]
