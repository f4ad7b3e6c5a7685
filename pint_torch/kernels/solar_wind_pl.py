"""K7 ``solar_wind_pl``: the power-law solar-wind geometry with local
partials.

Replaces ``pint_tpu/models/solar_wind.py``'s ``solar_wind_geometry_pl``
with ``_sw_I`` (``solar_wind.py:50-70``), the 64-node Gauss-Legendre path
integral, as ``SolarWindDispersion`` (SWM 1) and ``SolarWindDispersionX``
(``:278-290``, one power-law index per window) evaluate it per TOA.
Inputs: ``r`` (N,) the observatory-Sun distance [ls]; ``theta`` (B, N) the
pulsar's elongation [rad]; ``p`` and ``i_inf`` (B, W), each point's
power-law index per window and :func:`sw_i_inf` of it; ``win`` (N,) each
TOA's window (None: window 0 for every TOA; negative: none, geometry 0).
Returns the geometry (B, N) in parsecs; the local partials (B, N, 3) with
respect to theta, p and I_inf feed the ``jvp`` and the ``backward`` of
the :class:`torch.autograd.Function`.

On a CUDA tensor this launches ``csrc/solar_wind_pl.cu`` (or raises); on
a CPU tensor it runs :func:`solar_wind_pl_reference`, the plain PyTorch
twin, which sums the 64 nodes in a Python loop in the kernel's order.
The nodes and weights are numpy's ``leggauss(64)``, as the reference
builds them (``solar_wind.py:47``), handed to the kernel as data.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from pint_torch import F64
from pint_torch.kernels import _build
from pint_torch.kernels.dual import sum_to, toa_cotangent

__all__ = ["solar_wind_pl", "solar_wind_pl_reference", "sw_i_inf", "AU_LS",
           "PC_LS",
           "launch_counts", "REPLACES", "KERNELS", "GL_X", "GL_W"]

NAME = "solar_wind_pl"
REPLACES = "pint_tpu/models/solar_wind.py:65"
#: the two ``__global__`` instantiations, by partials asked for
KERNELS = {False: "solar_wind_pl_primal", True: "solar_wind_pl_dual"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)

#: an AU and a parsec in light-seconds (the reference's constants)
AU_LS = 1.495978707e11 / 299792458.0
PC_LS = 3.0856775814913673e16 / 299792458.0
#: 64-node Gauss-Legendre nodes and weights on [-1, 1] (reference
#: ``solar_wind.py:47``)
GL_X, GL_W = np.polynomial.legendre.leggauss(64)
_X1 = [float(v) for v in GL_X + 1.0]
_W = [float(v) for v in GL_W]
_gl_device: dict = {}


def _full(v, like):
    return torch.full_like(like, v) if not torch.is_tensor(v) else v


def sw_i_inf(p):
    """I_inf(p) = integral_0^inf (1 + t^2)^(-p/2) dt = sqrt(pi)/2
    Gamma((p-1)/2) / Gamma(p/2) (reference ``_sw_I_inf``)."""
    return 0.5 * math.sqrt(math.pi) * torch.exp(
        torch.special.gammaln((p - 1.0) / 2.0)
        - torch.special.gammaln(p / 2.0))


def solar_wind_pl_reference(r, theta, p, i_inf, partials: bool = True):
    """Plain PyTorch version of K7 on broadcast shapes (``p`` and
    ``i_inf`` already one per element): ``(geom, P)``, P (..., 3) or None
    when ``partials`` is False.  Each power is ``exp(y * log(x))``, as the
    kernel computes it, the logarithm shared with the d/dp terms."""
    st, ct = torch.sin(theta), torch.cos(theta)
    b = r * st
    z = r * ct
    u = z / b
    half = 0.5 * torch.atan(u)
    pm2 = p - 2.0
    acc = torch.zeros_like(half * pm2)
    acc_h = acc
    acc_p = acc
    for x1, w in zip(_X1, _W):
        phi = half * x1
        cp = torch.cos(phi)
        lc = torch.log(cp)
        v = torch.exp(pm2 * lc)
        acc = acc + w * v
        if partials:
            sp = torch.sin(phi)
            acc_h = acc_h + w * (-(pm2 * v * sp / cp) * x1)
            acc_p = acc_p + w * (v * lc)
    I = half * acc
    la = torch.log(_full(AU_LS, b) / b)
    a = torch.exp(p * la) * (b / _full(PC_LS, b))
    C = i_inf + I
    geom = a * C
    if not partials:
        return geom, None
    du = (-(b * b) - z * z) / (b * b)
    dhalf = 0.5 * du / (1.0 + u * u)
    dI_dth = (acc + half * acc_h) * dhalf
    dI_dp = half * acc_p
    da_dth = (1.0 - p) * a / b * z
    da_dp = a * la
    shape = geom.shape
    return geom, torch.stack([(da_dth * C + a * dI_dth).expand(shape),
                              (da_dp * C + a * dI_dp).expand(shape),
                              a.expand(shape)], dim=-1)


def _per_toa(x, win):
    """(B, W) per-window values as (B, N) per TOA (window 0 for TOAs
    outside every window, whose geometry is then zeroed)."""
    if win is None:
        return x[:, :1]
    return x[:, win.clamp(min=0)]


def _twin(r, theta, p, i_inf, win, partials):
    g, P = solar_wind_pl_reference(r, theta, _per_toa(p, win),
                                   _per_toa(i_inf, win), partials)
    if win is not None:
        out = win < 0
        g = torch.where(out, 0.0, g)
        if P is not None:
            P = torch.where(out[:, None], 0.0, P)
    return g, P


def _gl(device):
    t = _gl_device.get(device)
    if t is None:
        t = torch.tensor(np.concatenate([GL_X, GL_W]), dtype=F64,
                         device=device)
        _gl_device[device] = t
    return t


def _lib():
    lib = _build.load(NAME)
    fn = lib.solar_wind_pl_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
    return lib


def _launch(r, theta, p, i_inf, win, partials):
    B, N = theta.shape
    geom = torch.empty((B, N), dtype=F64, device=theta.device)
    P = torch.empty((B, N, 3), dtype=F64, device=theta.device) \
        if partials else None
    w32 = None if win is None else win.to(torch.int32).contiguous()
    rc = _lib().solar_wind_pl_launch(
        _build.ptr(r), _build.ptr(theta), _build.ptr(p), _build.ptr(i_inf),
        None if w32 is None else _build.ptr(w32), _build.ptr(_gl(r.device)),
        B, N, p.shape[1], _build.ptr(geom),
        _build.ptr(P) if partials else None, _build.stream_of(theta))
    launch_counts[KERNELS[bool(partials)]] += 1
    _build.check(NAME, rc)
    return geom, P


def _run(r, theta, p, i_inf, win, partials):
    if any(t.dtype != F64 or t.device != theta.device
           for t in (r, theta, p, i_inf)) or r.ndim != 1 \
            or theta.ndim != 2 or p.ndim != 2 or i_inf.shape[-1] != \
            p.shape[-1] or theta.shape[1] != r.shape[0] \
            or (win is not None and (win.shape != r.shape
                                     or win.device != r.device)):
        raise ValueError(
            f"solar_wind_pl: r {tuple(r.shape)}, theta {tuple(theta.shape)},"
            f" p {tuple(p.shape)}, i_inf {tuple(i_inf.shape)}, win "
            f"{None if win is None else tuple(win.shape)}; want float64 "
            "(N,), (B,N), (B,W), (B,W) and (N,) integers on one device")
    B = max(theta.shape[0], p.shape[0], i_inf.shape[0])
    N, W = theta.shape[1], p.shape[1]
    theta = theta.expand(B, N).contiguous()
    p = p.expand(B, W).contiguous()
    i_inf = i_inf.expand(B, W).contiguous()
    r = r.contiguous()
    if theta.is_cuda:
        return _launch(r, theta, p, i_inf, win, partials)
    if theta.device.type != "cpu":
        raise ValueError(f"solar_wind_pl: no kernel for device "
                         f"{theta.device}")
    return _twin(r, theta, p, i_inf, win, partials)


class SolarWindPLFn(torch.autograd.Function):
    """K7 under autodiff: forward returns ``(geom, P)``; ``jvp`` contracts
    the tangents of theta, p and I_inf (the latter two taken at each
    TOA's window) with ``P``, ``backward`` the geometry's cotangent with
    it, summed into each TOA's window; ``vmap`` folds a vmapped axis into
    B."""

    @staticmethod
    def forward(r, theta, p, i_inf, win):
        return _run(r, theta, p, i_inf, win, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_forward(output[1])
        ctx.save_for_backward(output[1])
        ctx.win = inputs[4]
        ctx.shapes = tuple(t.shape for t in inputs[1:4])

    @staticmethod
    def jvp(ctx, d_r, d_theta, d_p, d_i, _d_win):
        (P,) = ctx.saved_tensors
        out = torch.zeros(P.shape[:-1], dtype=F64, device=P.device)
        if d_theta is not None:
            out = out + d_theta * P[..., 0]
        for d, j in ((d_p, 1), (d_i, 2)):
            if d is not None:
                out = out + _per_toa(d, ctx.win) * P[..., j]
        return out, None

    @staticmethod
    def backward(ctx, grad, _gP):
        (P,) = ctx.saved_tensors
        sh_th, sh_p, sh_i = ctx.shapes
        W = sh_p[-1]
        win = ctx.win
        idx = torch.zeros(P.shape[1], dtype=torch.long, device=P.device) \
            if win is None else win.clamp(min=0).to(torch.long)

        def per_window(col):
            # a TOA outside every window has geometry 0 and no partials
            g = grad * col
            if win is not None:
                g = torch.where(win < 0, 0.0, g)
            return g.new_zeros(g.shape[0], W).index_add_(1, idx, g)

        return (None, toa_cotangent(grad, P[..., 0], sh_th),
                sum_to(per_window(P[..., 1]), sh_p),
                sum_to(per_window(P[..., 2]), sh_i), None)

    @staticmethod
    def vmap(info, in_dims, r, theta, p, i_inf, win):
        V = info.batch_size

        def lead(t, dim):
            return t.movedim(dim, 0) if dim is not None \
                else t.expand(V, *t.shape)

        t = lead(theta, in_dims[1])
        pp = lead(p, in_dims[2])
        ii = lead(i_inf, in_dims[3])
        B = max(t.shape[1], pp.shape[1], ii.shape[1])
        N, W = t.shape[2], pp.shape[2]
        g, P = SolarWindPLFn.apply(
            r, t.expand(V, B, N).reshape(V * B, N),
            pp.expand(V, B, W).reshape(V * B, W),
            ii.expand(V, B, W).reshape(V * B, W), win)
        return (g.reshape(V, B, N), P.reshape(V, B, N, 3)), (0, 0)


def solar_wind_pl(r, theta, p, i_inf, win=None):
    """K7: the geometry (B, N) [pc] (see the module docstring)."""
    if _build.traced(theta, p, i_inf):
        return SolarWindPLFn.apply(r, theta, p, i_inf, win)[0]
    return _run(r, theta, p, i_inf, win, False)[0]
