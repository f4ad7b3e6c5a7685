"""Shape-bucketed request batching: many fits, a handful of shapes (port of
``pint_tpu/serving/batcher.py``).

* :func:`bucket_of` rounds a dimension up its ladder, doubling past the top;
* :class:`FitRequest` carries one linearized GLS/WLS fit -- the normalized
  augmented design matrix, residuals, white-noise weights and prior
  ``phiinv`` (:meth:`FitRequest.from_fitter` builds it through
  :func:`~pint_torch.gls_fitter.linearized_system`);
* :func:`pad_request` embeds a request into a bucket shape exactly:
  zero-weight pad rows, zero pad columns with a unit pad diagonal, so the
  padded Gram is ``[[A_real, 0], [0, I]]`` and the real block's solve is
  the dedicated shape's;
* the serve kernels (:func:`serve_kernel`, :func:`serve_kernel_steps`)
  are the reference's jitted, vmapped Gauss-Newton step written with the
  batch axis explicit: the Gram a batched ``torch.matmul`` over blocks of
  :data:`GRAM_ROWS` rows whose partial Grams are then summed (one long
  reduction in cuBLAS's float64 GEMM left a padded 4096-row bucket's
  uncertainties 1.1e-8 from the reference's on an H100, the blocked sum
  4.5e-10), the factor ``torch.linalg.cholesky_ex``, the solves
  ``torch.cholesky_solve``;
* :class:`ShapeBatcher` groups requests per bucket, pads the batch axis to
  its ladder, dispatches one batched call per group and unpads.

The kernels' Gram, projection and post-step products are the
``serve.gram`` precision segment (:mod:`pint_torch.precision`): under the
default float64 spec they are the blocked products above, bit for bit;
under a reduced :class:`~pint_torch.precision.SegmentSpec` they follow the
reference's product boundaries (the whole padded row axis, in
``_split_slices`` blocks for ``two_sum``) through kernel K11.  The warm
pool (``pool=``) becomes CUDA graphs in ROADMAP queue A item 8.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_torch import F64, resolve_device
from pint_torch.fitter import UsageError
from pint_torch.precision import SegmentSpec
from pint_torch.precision import matmul as _pmatmul

__all__ = ["DEFAULT_NTOA_BUCKETS", "DEFAULT_NFREE_BUCKETS",
           "DEFAULT_BATCH_BUCKETS", "bucket_of", "FitRequest", "FitResult",
           "pad_request", "serve_kernel", "serve_batched",
           "serve_kernel_steps", "serve_fused", "HUBER_STEP_K",
           "SegmentSpec", "resolve_serve_spec", "ShapeBatcher",
           "GRAM_ROWS"]

#: default shape ladders: a handful of shapes serve the whole catalog
DEFAULT_NTOA_BUCKETS = (64, 256, 1024, 4096, 16384)
DEFAULT_NFREE_BUCKETS = (8, 32, 128, 512)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16)

#: Huber tuning constant of the fused refinement steps (the 95%-efficiency
#: value of :mod:`pint_torch.integrity.robust`)
HUBER_STEP_K = 1.345

#: rows a block of the Gram's reduction (the blocks' partial Grams are
#: summed after)
GRAM_ROWS = 256


def bucket_of(n: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung >= ``n``; past the top the ladder continues by
    doubling (never an error)."""
    if n < 1:
        raise UsageError(f"bucket dimension must be >= 1, got {n}")
    for rung in sorted(ladder):
        if n <= rung:
            return int(rung)
    top = int(max(ladder))
    while top < n:
        top *= 2
    return top


def resolve_serve_spec() -> SegmentSpec:
    """The active ``serve.gram`` :class:`~pint_torch.precision.SegmentSpec`
    (override -> manifest -> float64 default), resolved on the host at
    dispatch time."""
    from pint_torch.precision import segment_spec

    return segment_spec("serve.gram")


@dataclass
class FitRequest:
    """One linearized fit at the caller's current state: the step, errors
    and post-step chi2 of the prior-augmented normal equations.  Arrays
    become float64 tensors on ``device`` (None: CUDA)."""

    M: object                     #: (n_toas, n_free) normalized design
    r: object                     #: (n_toas,) residuals (seconds)
    w: object                     #: (n_toas,) white-noise weights 1/Nvec
    phiinv: object                #: (n_free,) prior weights (0 = flat)
    params: Tuple[str, ...] = ()  #: names of the leading timing columns
    norm: Optional[object] = None  #: column normalization to undo
    request_id: Optional[str] = None
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

        def t(a):
            return torch.as_tensor(a, dtype=F64, device=self.device)

        self.M, self.r, self.w, self.phiinv = (t(a) for a in (
            self.M, self.r, self.w, self.phiinv))
        if self.norm is not None:
            self.norm = np.asarray(torch.as_tensor(self.norm).cpu(),
                                   dtype=np.float64)
        if self.M.ndim != 2:
            raise UsageError(
                f"design matrix must be 2-D, got shape {tuple(self.M.shape)}")
        n, k = self.M.shape
        for name, arr, length in (("r", self.r, n), ("w", self.w, n),
                                  ("phiinv", self.phiinv, k)):
            if tuple(arr.shape) != (length,):
                raise UsageError(
                    f"FitRequest.{name} shape {tuple(arr.shape)} does not "
                    f"match design matrix {tuple(self.M.shape)}")

    @property
    def n_toas(self) -> int:
        return int(self.M.shape[0])

    @property
    def n_free(self) -> int:
        return int(self.M.shape[1])

    @classmethod
    def from_fitter(cls, ftr, request_id: Optional[str] = None
                    ) -> "FitRequest":
        """The fitter's current linearized system as one request, on the
        fitter's device (the Woodbury-form ``[M_timing | U_noise]`` with
        the enterprise prior weights)."""
        from pint_torch.gls_fitter import linearized_system

        M, r, w, phiinv, params, norm = linearized_system(
            ftr.model, ftr.batch, resids=ftr.resids)
        return cls(M=M, r=r, w=w, phiinv=phiinv, params=params, norm=norm,
                   request_id=request_id, device=M.device)


@dataclass
class FitResult:
    """Unpadded outcome of one served request (host values)."""

    dx: np.ndarray                #: (n_free,) normalized-parameter step
    errors: np.ndarray            #: (n_free,) normalized 1-sigma errors
    chi2: float                   #: post-step (linearized) chi2
    chi2_initial: float           #: chi2 of the residuals as submitted
    bucket: Tuple[int, int]       #: (bucket_ntoas, bucket_nfree) served on
    batch: int = 1                #: coalesced batch size dispatched
    #: hand-kernel builds (``pint_torch/kernels/_build.py``) during the
    #: dispatch -- the port's analogue of the reference's fresh XLA
    #: compiles -- on the first member of a batch only, so a sum over
    #: requests counts each once
    compiles: int = 0
    latency_ms: Optional[float] = None
    request_id: Optional[str] = None

    def dpars(self, req: FitRequest) -> Dict[str, float]:
        """Physical parameter steps of the request's named timing columns."""
        norm = req.norm if req.norm is not None else np.ones(req.n_free)
        return {p: float(self.dx[i] / norm[i])
                for i, p in enumerate(req.params)}


def pad_request(req: FitRequest, bucket_ntoas: int, bucket_nfree: int):
    """``(M, r, w, phiinv, pad_free)`` of ``req`` embedded in the bucket
    shape: zero-weight pad rows, zero pad columns, ``pad_free`` marking the
    unit diagonal the kernel adds."""
    n, k = req.M.shape
    if bucket_ntoas < n or bucket_nfree < k:
        raise UsageError(
            f"bucket ({bucket_ntoas}, {bucket_nfree}) cannot hold a "
            f"({n}, {k}) request")
    z = req.M.new_zeros
    M = z((bucket_ntoas, bucket_nfree))
    M[:n, :k] = req.M
    r, w = z(bucket_ntoas), z(bucket_ntoas)
    r[:n], w[:n] = req.r, req.w
    phiinv, pad_free = z(bucket_nfree), z(bucket_nfree)
    phiinv[:k] = req.phiinv
    pad_free[k:] = 1.0
    return M, r, w, phiinv, pad_free


def _mv(A, v):
    """Batched matrix-vector product."""
    return torch.matmul(A, v.unsqueeze(-1)).squeeze(-1)


def _gram(A, B):
    """``A^T B`` over the row axis (-2), any leading axes: one batched
    ``torch.matmul`` over blocks of :data:`GRAM_ROWS` rows (zero rows pad
    the last), the partial Grams summed."""
    n = A.shape[-2]
    c = min(GRAM_ROWS, n)
    pad = (-n) % c
    if pad:
        A = torch.cat([A, A.new_zeros(A.shape[:-2] + (pad, A.shape[-1]))],
                      dim=-2)
        B = torch.cat([B, B.new_zeros(B.shape[:-2] + (pad, B.shape[-1]))],
                      dim=-2)
    blocks = A.shape[-2] // c
    Ab = A.reshape(A.shape[:-2] + (blocks, c, A.shape[-1]))
    Bb = B.reshape(B.shape[:-2] + (blocks, c, B.shape[-1]))
    return torch.matmul(Ab.mT, Bb).sum(dim=-3)


def _pgram(A, B, spec):
    """``A^T B`` under the precision ``spec``: :func:`_gram`'s blocked float64
    product by default, else :func:`pint_torch.precision.matmul` of ``A^T``
    and ``B`` over the whole row axis."""
    if spec is None or not spec.reduced:
        return _gram(A, B)
    return _pmatmul(A.mT, B, spec)


def _pmv(A, v, spec):
    """``A v`` under the precision ``spec`` (:func:`_mv` by default)."""
    if spec is None or not spec.reduced:
        return _mv(A, v)
    return _pmatmul(A, v.unsqueeze(-1), spec).squeeze(-1)


def _scaled_system(M, w, phiinv, pad_free, spec=None):
    """The unit-W-norm column scale, scaled design, prior diagonal and
    Gram with its factor and inverse (any leading batch axes)."""
    s = torch.sqrt(torch.sum((w.unsqueeze(-1) * M) * M, dim=-2) + phiinv)
    s = torch.where(s > 0, s, torch.ones_like(s))
    Ms = M / s.unsqueeze(-2)
    prior = torch.diag_embed(phiinv / s**2) + torch.diag_embed(pad_free)
    A = _pgram(Ms, w.unsqueeze(-1) * Ms, spec) + prior
    cf, _ = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) \
        .expand(A.shape)
    Ainv = torch.cholesky_solve(eye, cf)
    err = torch.sqrt(torch.clamp(torch.diagonal(Ainv, dim1=-2, dim2=-1),
                                 min=0.0)) / s
    return s, Ms, prior, A, cf, Ainv, err


def serve_kernel(M, r, w, phiinv, pad_free, spec=None):
    """One linearized (Gauss-Newton) fit on padded systems, the batch axis
    (or axes) leading: ``(dx, err, chi2, chi2_initial)``.  The column
    scaling makes the padded factor block-diagonal, so the real block's
    solve is the dedicated shape's.  ``spec`` is the ``serve.gram`` segment
    of the Gram, projection and post-step products (None: float64); the
    scaling, the factor and both chi2 sums stay float64."""
    s, Ms, _, _, cf, _, err = _scaled_system(M, w, phiinv, pad_free, spec)
    b = _pmv(Ms.mT, w * r, spec)
    dx = torch.cholesky_solve(b.unsqueeze(-1), cf).squeeze(-1) / s
    r_post = r - _pmv(M, dx, spec)
    chi2 = torch.sum(w * r_post * r_post, dim=-1)
    return dx, err, chi2, torch.sum(w * r * r, dim=-1)


def serve_kernel_steps(M, r, w, phiinv, pad_free, spec=None,
                       steps: int = 1, reweight=None):
    """``steps`` linearized fit steps on padded systems, the scale, Gram,
    factor and covariance diagonal computed once: ``(dx (..., steps, k),
    err, chi2 (..., steps), chi2_initial)``.  ``reweight=None`` solves the
    same system against the carried residuals (step 0 is
    :func:`serve_kernel`'s step up to one refinement correction);
    ``"huber"`` re-accumulates the Gram under Huber IRLS weights
    ``min(1, k/|z|)`` of the carried whitened residuals, preconditioned by
    the clean system's inverse with one refinement correction.  ``spec``
    is as :func:`serve_kernel`'s (the refinement's products stay
    float64, as the reference's do)."""
    s, Ms, prior, A, _, Ainv, err = _scaled_system(M, w, phiinv, pad_free,
                                                   spec)
    chi2_initial = torch.sum(w * r * r, dim=-1)
    rc = r
    dxs, chi2s = [], []
    for _ in range(int(steps)):
        if reweight is None:
            wt, At = w, A
        else:
            z = torch.abs(rc) * torch.sqrt(w)
            g = torch.clamp(HUBER_STEP_K / torch.clamp(z, min=1e-300),
                            max=1.0)
            wt = w * g
            At = _pgram(Ms, wt.unsqueeze(-1) * Ms, spec) + prior
        bt = _pmv(Ms.mT, wt * rc, spec)
        x = _mv(Ainv, bt)
        x = x + _mv(Ainv, bt - _mv(At, x))
        dx = x / s
        rc = rc - _pmv(M, dx, spec)
        dxs.append(dx)
        chi2s.append(torch.sum(wt * rc * rc, dim=-1))
    return (torch.stack(dxs, dim=-2), err, torch.stack(chi2s, dim=-1),
            chi2_initial)


def serve_fused(spec=None, steps: int = 1, reweight=None):
    """The batched :func:`serve_kernel_steps` for ``(spec, steps,
    reweight)``: one call retires ``steps`` fit steps per batch lane."""
    if steps < 1:
        raise UsageError(f"serve_fused needs steps >= 1, got {steps}")
    if reweight not in (None, "huber"):
        raise UsageError(f"unknown reweight {reweight!r} (None | 'huber')")
    spec = resolve_serve_spec() if spec is None else spec
    steps = int(steps)
    return lambda M, r, w, phiinv, pad_free: serve_kernel_steps(
        M, r, w, phiinv, pad_free, spec=spec, steps=steps, reweight=reweight)


def serve_batched(spec=None):
    """The batched :func:`serve_kernel` for ``spec`` (default the active
    ``serve.gram`` spec, :func:`resolve_serve_spec`)."""
    spec = resolve_serve_spec() if spec is None else spec
    return lambda M, r, w, phiinv, pad_free: serve_kernel(
        M, r, w, phiinv, pad_free, spec=spec)


class ShapeBatcher:
    """Group -> pad -> dispatch -> unpad, on ``device`` (None: CUDA).
    Synchronous and stateless per call."""

    def __init__(self,
                 ntoa_buckets: Sequence[int] = DEFAULT_NTOA_BUCKETS,
                 nfree_buckets: Sequence[int] = DEFAULT_NFREE_BUCKETS,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 pool=None, device=None):
        if pool is not None:
            raise NotImplementedError(
                "ShapeBatcher(pool=...): the warm pool (CUDA graphs per "
                "bucket) is ROADMAP queue A item 8")
        self.ntoa_buckets = tuple(sorted(int(b) for b in ntoa_buckets))
        self.nfree_buckets = tuple(sorted(int(b) for b in nfree_buckets))
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        if not (self.ntoa_buckets and self.nfree_buckets
                and self.batch_buckets):
            raise UsageError("every bucket ladder needs at least one rung")
        self.pool = None
        self.device = resolve_device(device)

    def bucket_for(self, req: FitRequest) -> Tuple[int, int]:
        return (bucket_of(req.n_toas, self.ntoa_buckets),
                bucket_of(req.n_free, self.nfree_buckets))

    def _dispatch(self, bucket: Tuple[int, int],
                  group: List[FitRequest]) -> List[FitResult]:
        """Pad one bucket group onto its batch rung and execute."""
        from pint_torch.kernels import _build

        bn, bk = bucket
        batch = bucket_of(len(group), self.batch_buckets)
        padded = [pad_request(q, bn, bk) for q in group]
        # batch padding repeats the first request (discarded on unpad;
        # unlike zero lanes, trivially nonsingular)
        while len(padded) < batch:
            padded.append(padded[0])
        operands = tuple(torch.stack([p[i].to(self.device) for p in padded])
                         for i in range(5))
        t0 = time.perf_counter()
        builds = _build.build_count()
        out = [o.cpu().numpy() for o in serve_batched()(*operands)]
        compiles = _build.build_count() - builds
        wall_ms = 1e3 * (time.perf_counter() - t0)
        results = []
        for i, q in enumerate(group):
            k = q.n_free
            results.append(FitResult(
                dx=out[0][i, :k].copy(), errors=out[1][i, :k].copy(),
                chi2=float(out[2][i]), chi2_initial=float(out[3][i]),
                bucket=bucket, batch=batch,
                compiles=int(compiles) if i == 0 else 0,
                latency_ms=wall_ms, request_id=q.request_id))
        return results

    def run(self, requests: Sequence[FitRequest]) -> List[FitResult]:
        """Serve ``requests``: one batched call per bucket group (split at
        the batch ladder's top rung), results in request order."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, q in enumerate(requests):
            groups.setdefault(self.bucket_for(q), []).append(i)
        out: List[Optional[FitResult]] = [None] * len(requests)
        top = self.batch_buckets[-1]
        for bucket, idxs in groups.items():
            for lo in range(0, len(idxs), top):
                chunk = idxs[lo:lo + top]
                for j, res in zip(chunk, self._dispatch(
                        bucket, [requests[i] for i in chunk])):
                    out[j] = res
        return out  # type: ignore[return-value]
