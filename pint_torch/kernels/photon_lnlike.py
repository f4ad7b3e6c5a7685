"""K8 ``photon_lnlike``: the photon-template log-likelihood of a walker
ensemble, or the template density.

Replaces ``pint_tpu/event_fitter.py:110-127``'s template part of
``lnpost_one`` as the reference's ``vmap`` evaluates it per walker row:
the density (``_template_density``, binned ``:327-333`` and analytic
``:345-346`` through ``lctemplate.py:36-50`` and ``lcprimitives.py:126-135``)
at ``phi = frac mod 1``, then ``sum(log(maximum(w f + 1 - w, 1e-300)))``.
Inputs: ``frac`` (B, N) the photons' phase fractions, one row a walker;
``weights`` (N,) or None; ``table`` (nbins,) the binned template (mode
:data:`BINNED`), :func:`gauss_table` of an all-Gaussian ``LCTemplate``
(mode :data:`GAUSS`), or :func:`mixed_table` of a template of any of the
closed-form primitives :data:`MIXED_CODES` (mode :data:`MIXED`: ROADMAP
queue B 5d, the rest of ``lcprimitives.py:118-356``).  Returns (B,) sums,
or with ``density=True`` the (B, N) density.

On a CUDA tensor this launches ``csrc/photon_lnlike.cu`` (or raises): the
density, or the per-block sums, in one kernel, the rows' sums of the
blocks' partials in a second (``photon_lnlike_rowsum``), both in a fixed
order, so that two launches on the same inputs give the same bits; on
a CPU tensor it runs :func:`photon_lnlike_reference`, the plain PyTorch
version, which computes the density op for op as the kernel does and sums
each row with ``torch.sum``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pint_torch import F64
from pint_torch.kernels import _build

__all__ = ["photon_lnlike", "photon_lnlike_reference", "gauss_table",
           "mixed_table", "BINNED", "GAUSS", "MIXED", "MIXED_CODES", "REC",
           "NWRAP", "launch_counts", "REPLACES", "KERNELS"]

NAME = "photon_lnlike"
REPLACES = "pint_tpu/event_fitter.py:110"
BINNED, GAUSS, MIXED = 0, 1, 2
#: image terms each side of a wrapped Gaussian (``lcprimitives.py:27``)
NWRAP = 6
#: MIXED's type code of each closed-form primitive, by class name
MIXED_CODES = {"LCGaussian": 0, "LCGaussian2": 1, "LCLorentzian": 2,
               "LCLorentzian2": 3, "LCVonMises": 4, "LCTopHat": 5,
               "LCKing": 6, "LCHarmonic": 7}
#: numbers a MIXED record: (type, p0, p1, p2, norm, c0, c1, c2)
REC = 8
#: the ``__global__`` instantiations: (mode, density) and the row sums
KERNELS = {(BINNED, False): "photon_lnlike_binned",
           (GAUSS, False): "photon_lnlike_gauss",
           (MIXED, False): "photon_lnlike_mixed",
           (BINNED, True): "photon_density_binned",
           (GAUSS, True): "photon_density_gauss",
           (MIXED, True): "photon_density_mixed",
           "rowsum": "photon_lnlike_rowsum"}
launch_counts = dict.fromkeys(KERNELS.values(), 0)
_THREADS = 256


def gauss_table(template) -> np.ndarray:
    """The GAUSS mode's table of an ``LCTemplate`` of ``LCGaussian``
    peaks: ``[bg, (sigma, loc, norm, sigma sqrt(2 pi)) per peak]``, each
    number as the reference's numpy computes it (``bg = 1 - norms.sum()``,
    the denominator ``sigma * np.sqrt(2 * np.pi)``)."""
    norms = template.norms()
    out = [1.0 - norms.sum()]
    for n, prim in zip(norms, template.primitives):
        sigma, loc = prim.p[0], prim.p[1]
        out += [sigma, loc, n, sigma * np.sqrt(2 * np.pi)]
    return np.asarray(out, dtype=np.float64)


def mixed_table(template) -> np.ndarray:
    """The MIXED mode's table of an ``LCTemplate`` of closed-form
    primitives: ``[bg, (type, p0, p1, p2, norm, c0, c1, c2) per
    primitive]`` (see ``csrc/photon_lnlike.cu``), each constant as the
    reference's numpy computes it: ``sigma * np.sqrt(2 * np.pi)``, ``1.0 /
    w``, ``math.sqrt(2.0 / np.pi) / (w1 + w2)``, ``np.sinh`` and
    ``np.cosh`` of ``2 * np.pi * gamma``, ``2.0 / np.pi / (g1 + g2)``,
    kappa ``1.0 / (2 * np.pi * width) ** 2`` with scipy's ``i0e``, King's
    normalisation by scipy's ``gammaln``, ``2 * np.pi * order``."""
    import math

    from scipy.special import gammaln, i0e

    norms = template.norms()
    out = [1.0 - norms.sum()]
    for n, prim in zip(norms, template.primitives):
        name = type(prim).__name__
        if name not in MIXED_CODES:
            raise ValueError(f"mixed_table: {name} is not a closed-form "
                             f"primitive ({sorted(MIXED_CODES)})")
        code, p = MIXED_CODES[name], [float(x) for x in prim.p]
        c = [0.0, 0.0, 0.0]
        if code == 0:
            c[0] = p[0] * np.sqrt(2 * np.pi)
        elif code == 1:
            c = [1.0 / p[0], 1.0 / p[1],
                 math.sqrt(2.0 / np.pi) / (p[0] + p[1])]
        elif code == 2:
            a = 2 * np.pi * p[0]
            c[:2] = [float(np.sinh(a)), float(np.cosh(a))]
        elif code == 3:
            c = [1.0 / p[0], 1.0 / p[1], 2.0 / np.pi / (p[0] + p[1])]
        elif code == 4:
            kappa = 1.0 / (2 * np.pi * p[0]) ** 2
            c[:2] = [kappa, float(i0e(kappa))]
        elif code == 5:
            c[:2] = [p[0] / 2, 1.0 / p[0]]
        elif code == 6:
            s, g = p[0], p[1]
            c[0] = float(s * np.sqrt(2 * np.pi * g)
                         * np.exp(gammaln(g - 0.5) - gammaln(g)))
        else:
            c[0] = 2 * np.pi * prim.order
        out += [float(code)] + (p + [0.0, 0.0, 0.0])[:3] + [float(n)] + c
    return np.asarray(out, dtype=np.float64)


def _mixed_pdf(phi, rec):
    """One MIXED record's density at ``phi`` (the kernel's operations;
    ``rec`` a float64 tensor of :data:`REC` numbers, every divisor a
    tensor)."""
    code = int(rec[0])
    p0, p1, p2, c0, c1, c2 = rec[1], rec[2], rec[3], rec[5], rec[6], rec[7]
    if code == 0:
        z = torch.remainder(phi - p1, 1.0)
        s = 0.0
        for k in range(-NWRAP, NWRAP + 1):
            t = (z + k) / p0
            s = s + torch.exp(-0.5 * (t * t))
        return s / c0
    if code in (1, 3):
        z0 = phi - p2 if code == 1 \
            else torch.remainder(phi - p2 + 0.5, 1.0) - 0.5
        s = 0.0
        for k in range(-NWRAP, NWRAP + 1):
            z = z0 + k
            zz = z * torch.where(z <= 0.0, c0, c1)
            s = s + (torch.exp(-0.5 * (zz * zz)) if code == 1
                     else c2 / (1.0 + zz * zz))
        return s * c2 if code == 1 else s
    if code == 2:
        return c0 / (c1 - torch.cos(2 * np.pi * (phi - p1)))
    if code == 4:
        return torch.exp(c0 * (torch.cos(2 * np.pi * (phi - p1)) - 1.0)) \
            / c1
    if code == 5:
        z = torch.remainder(phi - p1 + 0.5, 1.0) - 0.5
        return torch.where(torch.abs(z) <= c0, c1, torch.zeros_like(c1))
    if code == 6:
        z0 = torch.remainder(phi - p2 + 0.5, 1.0) - 0.5
        s = 0.0
        for k in range(-NWRAP, NWRAP + 1):
            t = (z0 + k) / p0
            u = 0.5 * (t * t)
            s = s + torch.exp(-p1 * torch.log(1.0 + u / p1))
        return s / c0
    return 1.0 + 2.0 * torch.cos(c0 * (phi - p0))


def _density_reference(frac, table, mode):
    phi = torch.remainder(frac, 1.0)
    if mode == MIXED:
        f = table[0]
        for i in range((table.shape[0] - 1) // REC):
            rec = table[1 + REC * i:1 + REC * (i + 1)]
            f = f + rec[4] * _mixed_pdf(phi, rec)
        return f
    if mode == BINNED:
        x = phi * table.shape[0]
        idx = torch.where(torch.isnan(x), 0.0, x).long()
        return table[idx.clamp(0, table.shape[0] - 1)]
    f = table[0]
    for i in range((table.shape[0] - 1) // 4):
        sigma, loc, norm, den = table[1 + 4 * i:5 + 4 * i]
        z = torch.remainder(phi - loc, 1.0)
        s = 0.0
        for k in range(-NWRAP, NWRAP + 1):
            t = (z + k) / sigma
            s = s + torch.exp(-0.5 * (t * t))
        f = f + norm * (s / den)
    return f


def photon_lnlike_reference(frac, weights, table, mode: int,
                            density: bool = False):
    """Plain PyTorch version of K8 (same signature and operation order;
    every division tensor by tensor)."""
    f = _density_reference(frac, table, mode)
    if density:
        return f
    v = f if weights is None else weights * f + (1.0 - weights)
    v = torch.maximum(v, torch.full((), 1e-300, dtype=F64, device=v.device))
    return torch.sum(torch.log(v), dim=-1)


def _lib():
    lib = _build.load(NAME)
    if lib.photon_lnlike_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.photon_lnlike_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                             vp, vp]
        lib.photon_lnlike_launch.restype = ci
        lib.photon_lnlike_rowsum_launch.argtypes = [vp, ci, ci, vp, vp]
        lib.photon_lnlike_rowsum_launch.restype = ci
    return lib


def _launch_terms(frac, weights, table, mode, density):
    """The first kernel: the (B, N) density, or the (B, ceil(N / 256))
    blocks' sums of log terms."""
    B, N = frac.shape
    cols = N if density else (N + _THREADS - 1) // _THREADS
    out = torch.empty((B, cols), dtype=F64, device=frac.device)
    rc = _lib().photon_lnlike_launch(
        _build.ptr(frac), None if weights is None else _build.ptr(weights),
        _build.ptr(table), table.shape[0], int(mode), int(density), B, N,
        _build.ptr(out), _build.stream_of(frac))
    if B and N:
        launch_counts[KERNELS[(mode, bool(density))]] += 1
    _build.check(NAME, rc)
    return out


def _launch_rowsum(partials):
    """The second kernel: (B,) sums of each row of ``partials``, in a
    fixed order."""
    B, nblocks = partials.shape
    out = torch.empty((B,), dtype=F64, device=partials.device)
    rc = _lib().photon_lnlike_rowsum_launch(
        _build.ptr(partials), B, nblocks, _build.ptr(out),
        _build.stream_of(partials))
    if B:
        launch_counts[KERNELS["rowsum"]] += 1
    _build.check(NAME, rc)
    return out


def _launch(frac, weights, table, mode, density):
    out = _launch_terms(frac, weights, table, mode, density)
    return out if density else _launch_rowsum(out)


def photon_lnlike(frac, weights, table, mode: int, density: bool = False):
    """K8: (B,) log-likelihood sums, or the (B, N) density (see the module
    docstring)."""
    if mode not in (BINNED, GAUSS, MIXED):
        raise ValueError(f"photon_lnlike: mode {mode} is not BINNED, GAUSS "
                         "or MIXED")
    ts = (frac, table) + (() if weights is None else (weights,))
    if any(t.dtype != F64 or t.device != frac.device for t in ts) \
            or frac.ndim != 2 or table.ndim != 1 \
            or (weights is not None and weights.shape != frac.shape[1:]) \
            or (mode == GAUSS and (table.shape[0] - 1) % 4) \
            or (mode == MIXED and (table.shape[0] - 1) % REC) \
            or (mode == BINNED and table.shape[0] == 0):
        raise ValueError(
            f"photon_lnlike: frac {tuple(frac.shape)}, table "
            f"{tuple(table.shape)}, weights "
            f"{None if weights is None else tuple(weights.shape)}; want "
            "float64 (B,N), (nbins,), (1+4 peaks,) or (1+8 primitives,), "
            "and (N,) on one device")
    frac, table = frac.contiguous(), table.contiguous()
    weights = None if weights is None else weights.contiguous()
    if frac.is_cuda:
        return _launch(frac, weights, table, mode, density)
    if frac.device.type != "cpu":
        raise ValueError(f"photon_lnlike: no kernel for device "
                         f"{frac.device}")
    return photon_lnlike_reference(frac, weights, table, mode, density)
