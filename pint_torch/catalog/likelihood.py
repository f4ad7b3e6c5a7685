"""Joint cross-pulsar correlated-noise log-likelihood, Hellings-Downs (port
of ``pint_tpu/catalog/likelihood.py:64-395``).

The stacked TOA covariance of the array is ``C = blockdiag(P_a) + F Phi
F^T`` with ``P_a = N_a + U_a phi_a U_a^T`` (each pulsar's white noise and
augmented basis -- the timing columns under the 1e40 prior and its own
noise bases, the Woodbury system of :func:`pint_torch.gls_fitter.
linearized_system`), ``F_a`` a common Fourier basis of ``n_modes``
frequencies ``j / Tspan`` and ``Phi = HD (x) diag(phi_gw)``, the power-law
background correlated by the Hellings-Downs matrix
(:mod:`pint_torch.catalog.crosscorr`).  Block Woodbury over the per-pulsar
blocks plus the low-rank cross term:

    r^T C^-1 r = sum_a r_a^T P_a^-1 r_a - v^T M^-1 v
    ln det C   = sum_a ln det P_a + ln det M
    M = I + S^T blockdiag(X_a) S,  v = S^T [y_a],  S = L_HD (x) D
    X_a = F_a^T P_a^-1 F_a,  y_a = F_a^T P_a^-1 r_a,  D = diag(sqrt(phi_gw))

The reference evaluates all of it per walker point.  Here what does not
depend on the point is computed once, at construction, on the members'
device: each pulsar's block (:func:`_pulsar_blocks`: the unit-W-norm
scaling, the Sigma Gram over the padded pulsar axis, a batched Cholesky,
the log-determinants, ``y_a`` and ``X_a``), then ``G = sum_c L_HD[c,a]
L_HD[c,b] X_c`` as an R x R matrix and ``u = sum_c L_HD[c,a] y_c`` (R =
n_pulsars x 2 n_modes).  D commutes out (``M = I + D G D``, ``v = D u``),
so each point costs only K10 (:func:`pint_torch.kernels.hd_cross_lnlike.
hd_cross_lnlike`): the spectrum, M's Cholesky, the solve and the
log-determinant.  At zero amplitude (``log10_A = -inf``) the cross term is
exactly 0 and the joint value is the sum of the per-pulsar ones.

The per-pulsar blocks' Gram and projection products are the
``catalog.lnlike`` precision segment (``precision=`` a
:class:`~pint_torch.precision.SegmentSpec`, or None for the active one):
under a reduced spec they run through :func:`pint_torch.precision.matmul`
on the reference's operands; the factorizations, determinants, reductions
and K10's cross term stay float64, as in the reference.

Left to later items: ``plan=`` (mesh placement over ``pulsar`` and
``walker``, ROADMAP queue A item 9) raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pint_torch import F64
from pint_torch.fitter import UsageError
from pint_torch.kernels.hd_cross_lnlike import FYR_HZ, hd_cross_lnlike

__all__ = ["JointLikelihood", "FYR_HZ"]

_DAY_S = 86400.0


def _pulsar_blocks(M, r, w, phiinv, pad, F, spec=None):
    """Each padded pulsar's marginalized Woodbury pieces, the pulsar axis
    leading: ``(lnl, y, X)`` -- its log-likelihood, ``F^T P^-1 r`` and
    ``F^T P^-1 F``.  Pad rows carry ``w = 0``, pad columns ``phiinv = 0``
    and a unit pad diagonal: they add exactly nothing.  ``spec`` is the
    ``catalog.lnlike`` segment of the Gram and projection products (None:
    float64, the blocked products)."""
    from pint_torch.precision import matmul as _pmatmul
    from pint_torch.serving.batcher import _mv, _pgram, _pmv

    wM = w[..., None] * M
    s = torch.sqrt(torch.sum(wM * M, dim=-2) + phiinv)
    s = torch.where(s > 0, s, torch.ones_like(s))
    Ms = M / s[..., None, :]
    Sigma = _pgram(Ms, w[..., None] * Ms, spec) + torch.diag_embed(
        phiinv / s**2) + torch.diag_embed(pad)
    cf, info = torch.linalg.cholesky_ex(Sigma)
    if bool((info != 0).any()):
        from pint_torch.runtime.solve import NonFiniteSystemError

        raise NonFiniteSystemError(
            "joint likelihood: a pulsar's basis-space matrix is not positive "
            "definite")
    b = _pmv(Ms.mT, w * r, spec)
    xb = torch.cholesky_solve(b[..., None], cf)[..., 0]
    rNr = torch.sum(w * r * r, dim=-1)
    lndetN = -torch.sum(torch.where(w > 0, torch.log(torch.where(
        w > 0, w, torch.ones_like(w))), torch.zeros_like(w)), dim=-1)
    pos = phiinv > 0
    lndet_phi = torch.sum(torch.where(
        pos, torch.log(s * s) - torch.log(torch.where(
            pos, phiinv, torch.ones_like(phiinv))), torch.zeros_like(s)),
        dim=-1)
    lndet_sigma = 2.0 * torch.sum(torch.log(torch.diagonal(
        cf, dim1=-2, dim2=-1)), dim=-1)
    n_real = torch.sum(w > 0, dim=-1).to(F64)
    n2pi = float(np.log(2.0 * np.pi))
    lnl = -0.5 * (rNr - torch.sum(b * xb, dim=-1) + lndetN + lndet_phi
                  + lndet_sigma + n_real * n2pi)
    WF = w[..., None] * F
    A_mf = _pgram(Ms, WF, spec)
    y = _pmv(F.mT, w * r, spec) - _mv(A_mf.mT, xb)
    X = _pgram(F, WF, spec) \
        - _pmatmul(A_mf.mT, torch.cholesky_solve(A_mf, cf), spec)
    return lnl, y, X


class JointLikelihood:
    """The catalog's joint log-likelihood over ``(log10_A, gamma)`` points.

    Built from a :class:`~pint_torch.catalog.batchfit.CatalogFitter` (or a
    sequence of :class:`~pint_torch.catalog.ingest.CatalogPulsar`): each
    member contributes its current linearized Woodbury system, padded to
    one common ``(n_toa_pad, n_basis_pad)`` shape (the bucket plan's
    largest, or ``pad_shape``).  ``n_modes`` Fourier modes at ``j /
    Tspan`` form the common basis; the overlap matrix comes from the
    members' sky positions.  Every point-independent piece is computed
    here, once, on the members' device.  ``requests`` (one
    :class:`~pint_torch.serving.batcher.FitRequest` a member, in order)
    takes the members' linearized systems as the caller holds them, in
    place of each member fitter's current one (an extension of the
    reference's signature)."""

    def __init__(self, catalog, n_modes: int = 5, plan=None,
                 pad_shape: Optional[Tuple[int, int]] = None,
                 precision=None, requests: Optional[Sequence] = None):
        from pint_torch.catalog.crosscorr import hd_cholesky
        from pint_torch.precision import SegmentSpec, segment_spec
        from pint_torch.serving.batcher import FitRequest, pad_request

        # the catalog.lnlike segment, resolved once: the per-pulsar blocks
        # and per_pulsar_lnlike share it
        if precision is None:
            self._pspec = segment_spec("catalog.lnlike")
        elif isinstance(precision, SegmentSpec):
            self._pspec = precision
        else:
            raise UsageError(
                f"precision must be a SegmentSpec or None, got "
                f"{type(precision).__name__}")
        if plan is not None:
            raise NotImplementedError(
                "JointLikelihood(plan=...): execution plans over a "
                "(pulsar, walker) device mesh are ROADMAP queue A item 9")
        pulsars = list(getattr(catalog, "pulsars", catalog))
        if len(pulsars) < 2:
            raise UsageError("the joint likelihood needs >= 2 pulsars "
                             "(cross-correlations need pairs)")
        if n_modes < 1:
            raise UsageError(f"n_modes must be >= 1, got {n_modes}")
        self.pulsars = pulsars
        self.n_modes = int(n_modes)
        self.plan = None
        if requests is None:
            reqs = [FitRequest.from_fitter(p.fitter, request_id=p.name)
                    for p in pulsars]
        elif len(requests) != len(pulsars):
            raise UsageError(f"{len(requests)} requests for {len(pulsars)} "
                             "pulsars")
        else:
            reqs = list(requests)
        if pad_shape is None:
            bucket = getattr(catalog, "bucket_plan", None)
            if bucket is not None:
                n_pad = max(b for b, _ in bucket.buckets)
                k_pad = max(b for _, b in bucket.buckets)
            else:
                n_pad = max(q.n_toas for q in reqs)
                k_pad = max(q.n_free for q in reqs)
        else:
            n_pad, k_pad = int(pad_shape[0]), int(pad_shape[1])
        # the common span and Fourier frequencies, from the certified
        # arrival times on the host
        mjd = [np.asarray(p.toas.mjds, dtype=np.float64) for p in pulsars]
        tmin = min(float(m.min()) for m in mjd)
        tmax = max(float(m.max()) for m in mjd)
        self.Tspan = max((tmax - tmin) * _DAY_S, _DAY_S)
        self.freqs = np.arange(1, self.n_modes + 1) / self.Tspan
        two_m = 2 * self.n_modes
        parts = []
        for p, q, t in zip(pulsars, reqs, mjd):
            if q.n_toas > n_pad or q.n_free > k_pad:
                raise UsageError(
                    f"{p.name}: system ({q.n_toas}, {q.n_free}) exceeds "
                    f"the pad shape ({n_pad}, {k_pad})")
            F = np.zeros((n_pad, two_m))
            arg = 2.0 * np.pi * ((t - tmin) * _DAY_S)[:, None] \
                * self.freqs[None, :]
            F[: q.n_toas, 0::2] = np.sin(arg)
            F[: q.n_toas, 1::2] = np.cos(arg)
            parts.append(pad_request(q, n_pad, k_pad)
                         + (torch.as_tensor(F, dtype=F64,
                                            device=q.M.device),))
        self.device = reqs[0].M.device
        self.Lhd = hd_cholesky(self._directions())
        self.pad_shape = (n_pad, k_pad)
        data = tuple(torch.stack([p[i] for p in parts]) for i in range(6))
        lnl, y, X = _pulsar_blocks(*data, spec=self._pspec)
        self._lnl = lnl
        self._lnl_sum = torch.sum(lnl)
        Lhd = torch.as_tensor(self.Lhd, dtype=F64, device=self.device)
        R = len(pulsars) * two_m
        #: the point-independent cross-term pieces K10 takes
        self.G = torch.einsum("ca,cb,cij->aibj", Lhd, Lhd, X).reshape(
            R, R).contiguous()
        self.u = torch.einsum("ca,ci->ai", Lhd, y).reshape(R).contiguous()
        self._freqs_t = torch.as_tensor(self.freqs, dtype=F64,
                                        device=self.device)

    def _directions(self) -> np.ndarray:
        from pint_torch.catalog.crosscorr import pulsar_directions

        return pulsar_directions([p.model for p in self.pulsars])

    @property
    def n_pulsars(self) -> int:
        return len(self.pulsars)

    # -- evaluation --------------------------------------------------------
    def cross_batch(self, points) -> torch.Tensor:
        """K10's (N,) cross terms at ``(N, 2)`` points, on the device."""
        pts = torch.as_tensor(points, dtype=F64, device=self.device)
        return hd_cross_lnlike(self.G, self.u, pts[:, 0].contiguous(),
                               pts[:, 1].contiguous(), self._freqs_t,
                               self.Tspan)

    def lnlike_fn(self):
        """The joint log-likelihood as a tensor function: ``(N, 2)``
        ``(log10_A, gamma)`` float64 points on the device -> ``(N,)``,
        keeping the autograd graph (the reference's ``_fn()`` with its
        ``_data_args()`` closed over); the gradient through the cross term
        is K12 (:func:`pint_torch.kernels.hd_cross_lnlike.hd_cross_grad`)."""
        def fn(points: torch.Tensor) -> torch.Tensor:
            if points.ndim != 2 or points.shape[1] != 2:
                raise UsageError(
                    f"joint-likelihood points are (N, 2) (log10_A, gamma); "
                    f"got {tuple(points.shape)}")
            return self._lnl_sum + self.cross_batch(points)

        return fn

    def lnlike(self, log10_A: float, gamma: float) -> float:
        """The joint log-likelihood at one ``(log10_A, gamma)`` point."""
        return float(self.lnlike_batch(
            np.array([[float(log10_A), float(gamma)]]))[0])

    def lnlike_nocommon(self) -> float:
        """The joint log-likelihood with the common process off: the cross
        term at amplitude exactly zero (``log10_A = -inf``), which K10
        returns as exactly 0.0; the factorization pin holds it against
        :meth:`per_pulsar_lnlike`'s sum."""
        return self.lnlike(-np.inf, 4.33)

    def per_pulsar_lnlike(self) -> np.ndarray:
        """The ``(n_pulsars,)`` individual log-likelihoods (no common
        process)."""
        return self._lnl.cpu().numpy()[: len(self.pulsars)]

    def lnlike_batch(self, points) -> np.ndarray:
        """The joint log-likelihood at ``(N, 2)`` walker points of
        ``(log10_A, gamma)`` (the sampler's batch callable,
        :meth:`~pint_torch.sampler.EnsembleSampler.initialize_batched`)."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise UsageError(
                f"joint-likelihood points are (N, 2) (log10_A, gamma); "
                f"got {pts.shape}")
        return (self._lnl_sum + self.cross_batch(pts)).cpu().numpy()
