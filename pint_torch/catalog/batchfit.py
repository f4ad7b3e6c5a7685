"""Batched multi-pulsar GLS fitting: the whole catalog, one batched call per
bucket (port of ``pint_tpu/catalog/batchfit.py:47-532``).

Every member's linearized Woodbury system (:meth:`~pint_torch.serving.
batcher.FitRequest.from_fitter`) is padded into its learned bucket
(:mod:`pint_torch.catalog.buckets`) and each bucket group runs one batched
Gauss-Newton step of the serve batcher (:func:`~pint_torch.serving.
batcher.serve_batched`), or ``steps`` of them fused
(:func:`~pint_torch.serving.batcher.serve_fused`): zero-weight pad rows,
zero pad columns and a unit pad diagonal make the padded solve the
dedicated one.  ``compiles`` counts the hand kernels built during a pass
(the port's analogue of the reference's fresh XLA compiles).  The batched
calls run the ``catalog.fit`` precision segment
(:func:`resolve_catalog_fit_spec`), and the bucket ladders are the tuning
manifest's where it holds them for this catalogue's shapes, else the
learned ones.

Left to later items: ``plan=`` (the execution-plan mesh, ROADMAP queue A
item 9) and ``pool=`` / :meth:`CatalogFitter.warm` with a pool (CUDA graphs
per bucket, item 8) raise ``NotImplementedError``; the telemetry spans and
events are item 8's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_torch.fitter import UsageError
from pint_torch.runtime.solve import NonFiniteSystemError

__all__ = ["CatalogFitter", "CatalogFitResult", "CatalogRefineResult",
           "PulsarFit", "catalog_batched", "catalog_fused",
           "resolve_catalog_fit_spec", "DEFAULT_CATALOG_BATCH_BUCKETS",
           "DEFAULT_REFINE_STEPS"]

#: default fused refinement depth
DEFAULT_REFINE_STEPS = 8

#: batch-axis ladder for bucket groups
DEFAULT_CATALOG_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def resolve_catalog_fit_spec():
    """The active ``catalog.fit`` precision
    :class:`~pint_torch.precision.SegmentSpec` (override -> manifest ->
    float64 default), resolved on the host at dispatch time."""
    from pint_torch.precision import segment_spec

    return segment_spec("catalog.fit")


def catalog_fused(spec=None, steps: int = DEFAULT_REFINE_STEPS,
                  reweight=None):
    """``steps`` linearized fit steps per pulsar lane in one call
    (:func:`~pint_torch.serving.batcher.serve_fused`) at the ``catalog.fit``
    spec; ``reweight="huber"`` re-weights the Grams by Huber IRLS."""
    from pint_torch.serving.batcher import serve_fused

    return serve_fused(resolve_catalog_fit_spec() if spec is None else spec,
                       steps=steps, reweight=reweight)


def catalog_batched(spec=None):
    """One batched Gauss-Newton step per lane
    (:func:`~pint_torch.serving.batcher.serve_batched`) at the
    ``catalog.fit`` spec."""
    from pint_torch.serving.batcher import serve_batched

    return serve_batched(resolve_catalog_fit_spec() if spec is None
                         else spec)


@dataclass
class PulsarFit:
    """One member's unpadded fit outcome."""

    name: str
    chi2: float                      #: post-fit residual chi2
    chi2_initial: float              #: linearized chi2 as submitted
    dpars: Dict[str, float]          #: last iteration's physical steps
    errors: Dict[str, float]         #: physical 1-sigma errors
    bucket: Tuple[int, int]
    n_toas: int
    n_quarantined: int = 0


@dataclass
class CatalogFitResult:
    """Outcome of one :meth:`CatalogFitter.fit` pass."""

    fits: List[PulsarFit] = field(default_factory=list)
    n_buckets: int = 0
    pad_waste_frac: float = 0.0
    compiles: int = 0                #: hand kernels built during the pass
    wall_s: float = 0.0
    maxiter: int = 1

    @property
    def n_pulsars(self) -> int:
        return len(self.fits)

    @property
    def chi2_total(self) -> float:
        return float(sum(f.chi2 for f in self.fits))

    def by_name(self) -> Dict[str, PulsarFit]:
        return {f.name: f for f in self.fits}

    def to_dict(self) -> dict:
        return {
            "n_pulsars": self.n_pulsars,
            "n_buckets": self.n_buckets,
            "pad_waste_frac": self.pad_waste_frac,
            "compiles": self.compiles,
            "wall_s": self.wall_s,
            "chi2_total": self.chi2_total,
        }


@dataclass
class CatalogRefineResult:
    """Outcome of one :meth:`CatalogFitter.refine` fused pass."""

    steps: int = 1
    reweight: Optional[str] = None
    n_buckets: int = 0
    #: fused calls dispatched: one per bucket for the whole step ladder
    dispatches: int = 0
    compiles: int = 0
    wall_s: float = 0.0
    #: per-pulsar chi2 trajectory over the fused steps
    chi2_steps: Dict[str, np.ndarray] = field(default_factory=dict)
    #: per-pulsar physical steps at the first fused step
    dpars_first: Dict[str, Dict[str, float]] = field(default_factory=dict)

    @property
    def chi2_final(self) -> float:
        return float(sum(float(v[-1]) for v in self.chi2_steps.values()))

    def to_dict(self) -> dict:
        return {"steps": self.steps, "reweight": self.reweight,
                "n_buckets": self.n_buckets,
                "dispatches": self.dispatches,
                "compiles": self.compiles, "wall_s": self.wall_s,
                "chi2_final": self.chi2_final}


def _physical(req, v) -> Dict[str, float]:
    """The request's named timing columns of a normalized vector ``v``."""
    norm = req.norm if req.norm is not None else np.ones(req.n_free)
    return {par: float(v[j] / norm[j]) for j, par in enumerate(req.params)}


class CatalogFitter:
    """Fit a certified catalog as one batched call per bucket.

    ``catalog`` is a :class:`~pint_torch.catalog.ingest.
    CatalogIngestReport` (or a sequence of :class:`~pint_torch.catalog.
    ingest.CatalogPulsar`); the ladders default to those learned from the
    catalog's own shapes (:func:`~pint_torch.catalog.buckets.
    learn_ladders`).  The work runs on the members' batches' device."""

    def __init__(self, catalog, ntoa_ladder: Optional[Sequence[int]] = None,
                 nfree_ladder: Optional[Sequence[int]] = None,
                 batch_ladder: Sequence[int] = DEFAULT_CATALOG_BATCH_BUCKETS,
                 plan=None, pool=None):
        from pint_torch.catalog.buckets import assign_buckets, learn_ladders

        if plan is not None:
            raise NotImplementedError(
                "CatalogFitter(plan=...): execution plans over a device "
                "mesh are ROADMAP queue A item 9")
        if pool is not None:
            raise NotImplementedError(
                "CatalogFitter(pool=...): the warm pool (CUDA graphs per "
                "bucket) is ROADMAP queue A item 8")
        pulsars = list(getattr(catalog, "pulsars", catalog))
        if not pulsars:
            raise UsageError("CatalogFitter needs at least one pulsar")
        self.pulsars = pulsars
        self.batch_ladder = tuple(sorted(int(b) for b in batch_ladder))
        if not self.batch_ladder or self.batch_ladder[0] < 1:
            raise UsageError("batch_ladder needs positive rungs")
        self.pool = None
        self.plan = None
        #: each member's linearized system, built once for the shapes and
        #: served to the first fit or warm pass (the state cannot have
        #: changed in between)
        self._request_memo = self._build_requests()
        self.shapes = [(q.n_toas, q.n_free) for q in self._request_memo]
        if ntoa_ladder is None and nfree_ladder is None:
            from pint_torch import autotune

            tuned = autotune.resolve_catalog_ladders(self.shapes)
            if tuned is not None:
                ntoa_ladder, nfree_ladder = tuned["ntoa"], tuned["nfree"]
        if ntoa_ladder is None or nfree_ladder is None:
            learned_n, learned_k = learn_ladders(self.shapes)
            ntoa_ladder = ntoa_ladder or learned_n
            nfree_ladder = nfree_ladder or learned_k
        self.bucket_plan = assign_buckets(self.shapes, ntoa_ladder,
                                          nfree_ladder)
        self.last_result: Optional[CatalogFitResult] = None

    # -- operands ----------------------------------------------------------
    def _build_requests(self):
        from pint_torch.serving.batcher import FitRequest

        return [FitRequest.from_fitter(p.fitter, request_id=p.name)
                for p in self.pulsars]

    def _requests(self):
        """The members' linearized systems at the current state: the
        constructor's build once, then a fresh linearization each call."""
        if self._request_memo is not None:
            reqs, self._request_memo = self._request_memo, None
            return reqs
        return self._build_requests()

    def _group_operands(self, bucket: Tuple[int, int], reqs: List) -> tuple:
        """One bucket group's padded operands, the batch axis padded to its
        ladder rung by repeating the first member."""
        from pint_torch.serving.batcher import bucket_of, pad_request

        bn, bk = bucket
        batch = bucket_of(len(reqs), self.batch_ladder)
        padded = [pad_request(q, bn, bk) for q in reqs]
        while len(padded) < batch:
            padded.append(padded[0])
        return tuple(torch.stack([p[i] for p in padded]) for i in range(5))

    @staticmethod
    def _bucket_name(batch: int, bucket: Tuple[int, int], spec) -> str:
        """A bucket call's name (the reference's warm-pool key)."""
        return f"catalog.fit[{batch}x{bucket[0]}x{bucket[1]}]" \
            + spec.suffix()

    def bucket_executables(self, spec=None) -> Dict[str, tuple]:
        """``name -> (batched call, operands)`` per bucket at the current
        linearized state: what :meth:`fit` dispatches."""
        reqs = self._requests()
        spec = resolve_catalog_fit_spec() if spec is None else spec
        out: Dict[str, tuple] = {}
        for bucket, idx in sorted(self.bucket_plan.buckets.items()):
            operands = self._group_operands(bucket, [reqs[i] for i in idx])
            out[self._bucket_name(operands[0].shape[0], bucket, spec)] = (
                catalog_batched(spec), operands)
        return out

    def refine(self, steps: int = DEFAULT_REFINE_STEPS,
               reweight=None) -> CatalogRefineResult:
        """``steps`` fused linearized fit steps per member at the current
        state, one call per bucket; the members' models are not moved (step
        0 equals a dedicated single step for ``reweight=None``;
        ``"huber"`` runs robust IRLS refinement)."""
        from pint_torch.kernels import _build

        t0 = time.perf_counter()
        builds = _build.build_count()
        result = CatalogRefineResult(steps=int(steps), reweight=reweight,
                                     n_buckets=self.bucket_plan.n_buckets)
        reqs = self._requests()
        fn = catalog_fused(steps=steps, reweight=reweight)
        for bucket, idx in sorted(self.bucket_plan.buckets.items()):
            operands = self._group_operands(bucket, [reqs[i] for i in idx])
            dxs, _, chi2s, _ = (o.cpu().numpy() for o in fn(*operands))
            result.dispatches += 1
            for j, i in enumerate(idx):
                name = self.pulsars[i].name
                if not np.all(np.isfinite(chi2s[j])):
                    raise NonFiniteSystemError(
                        f"fused catalog refinement produced non-finite chi2 "
                        f"for {name}")
                result.chi2_steps[name] = chi2s[j].copy()
                result.dpars_first[name] = _physical(reqs[i], dxs[j, 0])
        result.compiles = _build.build_count() - builds
        result.wall_s = time.perf_counter() - t0
        return result

    def warm(self, pool=None):
        """Run every bucket's call once at the current state (builds the
        kernels, warms PyTorch's allocator); a pool is ROADMAP queue A item
        8's CUDA graphs.  Returns the bucket names warmed."""
        if pool is not None:
            raise NotImplementedError(
                "CatalogFitter.warm(pool): the warm pool (CUDA graphs per "
                "bucket) is ROADMAP queue A item 8")
        execs = self.bucket_executables()
        for fn, operands in execs.values():
            fn(*operands)
        return list(execs)

    # -- the fit -----------------------------------------------------------
    def fit(self, maxiter: int = 1) -> CatalogFitResult:
        """Fit every member: per iteration, relinearize each at its current
        state, run one batched call per bucket, and apply the unpadded
        steps to the members' fitter models (:meth:`_apply`).  Raises
        :class:`~pint_torch.runtime.solve.NonFiniteSystemError` when a
        member's post-fit chi2 is not finite."""
        from pint_torch.kernels import _build

        maxiter = max(1, int(maxiter))
        t0 = time.perf_counter()
        builds = _build.build_count()
        kernel_out: Dict[int, tuple] = {}
        reqs: List = []
        fn = catalog_batched()
        for _ in range(maxiter):
            reqs = self._requests()
            for bucket, idx in sorted(self.bucket_plan.buckets.items()):
                operands = self._group_operands(bucket,
                                                [reqs[i] for i in idx])
                out = [o.cpu().numpy() for o in fn(*operands)]
                for j, i in enumerate(idx):
                    kernel_out[i] = (out[0][j], out[1][j], float(out[2][j]),
                                     float(out[3][j]), bucket)
            self._apply(reqs, kernel_out)
        result = CatalogFitResult(
            n_buckets=self.bucket_plan.n_buckets,
            pad_waste_frac=float(self.bucket_plan.pad_waste_frac),
            compiles=_build.build_count() - builds,
            wall_s=time.perf_counter() - t0, maxiter=maxiter)
        for i, p in enumerate(self.pulsars):
            dx, err, _, chi2_init, bucket = kernel_out[i]
            chi2 = float(p.fitter.resids.calc_chi2())
            if not np.isfinite(chi2):
                raise NonFiniteSystemError(
                    f"catalog fit produced non-finite chi2 for {p.name} "
                    "(non-finite residuals or a poisoned solve)")
            result.fits.append(PulsarFit(
                name=p.name, chi2=chi2, chi2_initial=chi2_init,
                dpars=_physical(reqs[i], dx), errors=_physical(reqs[i], err),
                bucket=bucket, n_toas=p.n_toas,
                n_quarantined=p.n_quarantined))
        self.last_result = result
        return result

    def _apply(self, reqs, kernel_out) -> None:
        """Apply one iteration's unpadded steps to the members' fitter
        models (the ingest models stay as they were): named timing
        parameters move by the physical step, ``Offset`` never
        materializes, and the residuals refresh for the next
        linearization."""
        for i, p in enumerate(self.pulsars):
            dx, err, _, _, _ = kernel_out[i]
            steps, errors = _physical(reqs[i], dx), _physical(reqs[i], err)
            for par_name in reqs[i].params:
                if par_name == "Offset":
                    continue
                par = p.fitter.model[par_name]
                par.value = float(par.value or 0.0) + steps[par_name]
                par.uncertainty = errors[par_name]
                p.fitter.errors[par_name] = errors[par_name]
            p.fitter.update_resids()
