"""K8 ``photon_lnlike``: the photon-template log-likelihood of a walker
ensemble, or the template density.

Replaces ``pint_tpu/event_fitter.py:110-127``'s template part of
``lnpost_one`` as the reference's ``vmap`` evaluates it per walker row:
the density (``_template_density``, binned ``:327-333`` and analytic
``:345-346`` through ``lctemplate.py:36-50`` and ``lcprimitives.py:126-135``)
at ``phi = frac mod 1``, then ``sum(log(maximum(w f + 1 - w, 1e-300)))``.
Inputs: ``frac`` (B, N) the photons' phase fractions, one row a walker;
``weights`` (N,) or None; ``table`` (nbins,) the binned template (mode
:data:`BINNED`) or :func:`gauss_table` of an all-Gaussian ``LCTemplate``
(mode :data:`GAUSS`).  Returns (B,) sums, or with ``density=True`` the
(B, N) density.

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
           "BINNED", "GAUSS", "NWRAP", "launch_counts", "REPLACES",
           "KERNELS"]

NAME = "photon_lnlike"
REPLACES = "pint_tpu/event_fitter.py:110"
BINNED, GAUSS = 0, 1
#: image terms each side of a wrapped Gaussian (``lcprimitives.py:27``)
NWRAP = 6
#: the ``__global__`` instantiations: (mode, density) and the row sums
KERNELS = {(BINNED, False): "photon_lnlike_binned",
           (GAUSS, False): "photon_lnlike_gauss",
           (BINNED, True): "photon_density_binned",
           (GAUSS, True): "photon_density_gauss",
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


def _density_reference(frac, table, mode):
    phi = torch.remainder(frac, 1.0)
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
    if mode not in (BINNED, GAUSS):
        raise ValueError(f"photon_lnlike: mode {mode} is neither BINNED "
                         "nor GAUSS")
    ts = (frac, table) + (() if weights is None else (weights,))
    if any(t.dtype != F64 or t.device != frac.device for t in ts) \
            or frac.ndim != 2 or table.ndim != 1 \
            or (weights is not None and weights.shape != frac.shape[1:]) \
            or (mode == GAUSS and (table.shape[0] - 1) % 4) \
            or (mode == BINNED and table.shape[0] == 0):
        raise ValueError(
            f"photon_lnlike: frac {tuple(frac.shape)}, table "
            f"{tuple(table.shape)}, weights "
            f"{None if weights is None else tuple(weights.shape)}; want "
            "float64 (B,N), (nbins,) or (1+4 peaks,), and (N,) on one "
            "device")
    frac, table = frac.contiguous(), table.contiguous()
    weights = None if weights is None else weights.contiguous()
    if frac.is_cuda:
        return _launch(frac, weights, table, mode, density)
    if frac.device.type != "cpu":
        raise ValueError(f"photon_lnlike: no kernel for device "
                         f"{frac.device}")
    return photon_lnlike_reference(frac, weights, table, mode, density)
