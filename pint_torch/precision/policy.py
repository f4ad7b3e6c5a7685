"""Precision policy: named hot-path segments and their compute dtypes (port
of ``pint_tpu/precision/policy.py``).

A **segment** is one named bulk linear-algebra region of the hot path (a
design-matrix product, a Gram block, the batched serve kernel, the joint
likelihood's projections).  Each segment a consumer runs is described by a
:class:`SegmentSpec` -- compute dtype, accumulation mode and the error
budget the decision was admitted under -- and the default spec of EVERY
segment is full float64, which :func:`pint_torch.precision.compensated.
matmul` turns into the plain ``a @ b`` the consumers ran before this layer
existed: **no manifest and no override means bit-identical float64
everywhere**.

Resolution order of :func:`segment_spec`:

1. an **override policy** installed with :func:`set_policy` /
   :func:`use_policy` wins outright;
2. a **tuned decision** in the tuning manifest (``precision.<segment>``
   keys recorded by :func:`pint_torch.precision.tune.
   tune_precision_segments` under the vkey and device-fingerprint scheme of
   :mod:`pint_torch.autotune`), verified field by field by the manifest,
   validated again here (:func:`spec_from_decision`) and degraded to
   float64 on any miss or malformation;
3. the **float64 default**.

A reduced spec handed to a consumer is logged as a ``precision_applied``
record (the reference's telemetry event; telemetry itself is ROADMAP queue
A item 8).  Everything here is host-side decision plumbing.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from pint_torch import config
from pint_torch.exceptions import UsageError
from pint_torch.logging import log

__all__ = ["COMPUTE_DTYPES", "ACCUMULATIONS", "SEGMENTS", "SegmentDef",
           "SegmentSpec", "PrecisionPolicy", "active_policy", "set_policy",
           "use_policy", "override_spec", "segment_spec", "precision_vkey",
           "spec_from_decision", "describe_segments"]

#: dtypes a segment may compute its matmuls in
COMPUTE_DTYPES = ("float64", "float32", "bfloat16")
#: how a reduced segment's products re-enter float64: ``native`` (the
#: product in the compute dtype, one upcast at the end), ``f64`` (the
#: rounded operands' exact products summed in float64), ``two_sum``
#: (float64 partials over contraction blocks folded error-free),
#: ``two_prod`` (each operand split into a reduced (hi, lo) pair, the
#: product hi@hi + hi@lo + lo@hi accumulated in float64 and folded)
ACCUMULATIONS = ("native", "f64", "two_sum", "two_prod")

_SHORT = {"float64": "f64", "float32": "f32", "bfloat16": "bf16"}
_ACC_SHORT = {"native": "", "f64": "+a64", "two_sum": "+dd",
              "two_prod": "+split"}


@dataclass(frozen=True)
class SegmentDef:
    """Registry entry for one tunable segment."""

    name: str
    description: str
    #: a probe may ship reduced precision unrequested only below this
    #: measured float64-vs-reduced relative disagreement
    safe_rel: float
    #: the budget a FORCED reduced decision is admitted (and asserted) under
    forced_budget: float
    #: whether the vkey binds to a (model, TOAs) workload or is
    #: deployment-generic (kernel-schema versioned)
    model_bound: bool = False


#: the segments the consumers run, with their stated budgets
SEGMENTS: Dict[str, SegmentDef] = {s.name: s for s in (
    SegmentDef("gls.design",
               "GLS normal-equation build + Schur Gram blocks "
               "(gls_fitter: M^T W M, noise-block and coupling Grams)",
               safe_rel=1e-12, forced_budget=1e-3, model_bound=True),
    SegmentDef("grid.gram",
               "per-point design/Gram products inside the chunked GLS "
               "grid kernel (grid.py gn_step)",
               safe_rel=1e-12, forced_budget=1e-3, model_bound=True),
    SegmentDef("grid.correction",
               "Woodbury chi2-correction segment of the grid kernel "
               "(PR 10's dd-split-guarded probe; decision key "
               "grid.correction_dtype)",
               safe_rel=1e-12, forced_budget=1e-4, model_bound=True),
    SegmentDef("serve.gram",
               "the batched serve kernel's Gram/projection/step "
               "products (serving/batcher serve_kernel)",
               safe_rel=1e-12, forced_budget=1e-3),
    SegmentDef("catalog.fit",
               "the catalog batched-fit kernel (jit(vmap(serve_kernel)) "
               "per bucket, catalog/batchfit)",
               safe_rel=1e-12, forced_budget=1e-3),
    SegmentDef("catalog.lnlike",
               "joint Hellings-Downs lnlikelihood Gram/projection "
               "products (catalog/likelihood)",
               safe_rel=1e-9, forced_budget=1e-3),
    SegmentDef("flow.coupling",
               "the amortized-inference flow's coupling-MLP matmuls "
               "(amortized/flows; ELBO training and the draw/log-prob "
               "serve kernels trace the same segment — no per-workload "
               "probe exists, the decision is owned by the training "
               "run's policy/manifest)",
               safe_rel=1e-9, forced_budget=1e-2),
)}


@dataclass(frozen=True)
class SegmentSpec:
    """One segment's resolved precision configuration.

    ``budget`` is the error bar the configuration was admitted under (0.0
    for the float64 default: the bit-identical contract); ``rel_err`` the
    probe-measured float64-vs-reduced disagreement, when one exists.
    Frozen and hashable: caches key on :meth:`key`."""

    segment: str
    compute_dtype: str = "float64"
    accumulation: str = "native"
    budget: float = 0.0
    rel_err: Optional[float] = None
    source: str = "default"          #: default | tuned | forced

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise UsageError(
                f"segment {self.segment!r}: compute_dtype "
                f"{self.compute_dtype!r} not in {COMPUTE_DTYPES}")
        if self.accumulation not in ACCUMULATIONS:
            raise UsageError(
                f"segment {self.segment!r}: accumulation "
                f"{self.accumulation!r} not in {ACCUMULATIONS}")

    @property
    def reduced(self) -> bool:
        return self.compute_dtype != "float64"

    def key(self) -> Tuple[str, str]:
        """The cache-key material: what changes the computation (dtype and
        accumulation; budgets and provenance do not)."""
        if not self.reduced:
            return ("float64", "native")
        return (self.compute_dtype, self.accumulation)

    def tag(self) -> str:
        """Human/manifest tag: ``f64`` or e.g. ``f32+dd``."""
        if not self.reduced:
            return "f64"
        return _SHORT[self.compute_dtype] + _ACC_SHORT[self.accumulation]

    def suffix(self) -> str:
        """Name suffix: empty for the float64 default, ``@<tag>`` for a
        reduced spec."""
        return "" if not self.reduced else f"@{self.tag()}"

    def to_value(self) -> dict:
        """The JSON decision value the tuning manifest stores."""
        return {"compute_dtype": self.compute_dtype,
                "accumulation": self.accumulation,
                "budget": self.budget, "rel_err": self.rel_err}


def default_spec(segment: str) -> SegmentSpec:
    _require_segment(segment)
    return SegmentSpec(segment=segment)


def _require_segment(segment: str) -> SegmentDef:
    d = SEGMENTS.get(segment)
    if d is None:
        raise UsageError(f"unknown precision segment {segment!r}; "
                         f"known: {sorted(SEGMENTS)}")
    return d


class PrecisionPolicy:
    """A segment -> :class:`SegmentSpec` mapping with a float64 default.

    :meth:`forced` builds the all-segments reduced policy; the empty policy
    (:meth:`f64`) is the explicit everything-full-precision override (it
    WINS over a manifest, unlike no policy at all)."""

    def __init__(self, specs: Optional[Dict[str, SegmentSpec]] = None):
        self.specs: Dict[str, SegmentSpec] = dict(specs or {})
        for name in self.specs:
            _require_segment(name)

    def spec_for(self, segment: str) -> SegmentSpec:
        _require_segment(segment)
        return self.specs.get(segment) or SegmentSpec(segment=segment)

    @classmethod
    def f64(cls) -> "PrecisionPolicy":
        """Everything forced full float64."""
        return cls({})

    @classmethod
    def forced(cls, compute_dtype: str, accumulation: str = "f64",
               segments: Optional[Tuple[str, ...]] = None
               ) -> "PrecisionPolicy":
        """Every (or the named) segment forced to ``compute_dtype``,
        budgeted at its registered forced budget."""
        if compute_dtype not in COMPUTE_DTYPES:
            raise UsageError(f"compute_dtype {compute_dtype!r} not in "
                             f"{COMPUTE_DTYPES}")
        names = tuple(segments) if segments is not None \
            else tuple(SEGMENTS)
        specs = {}
        for name in names:
            d = _require_segment(name)
            if compute_dtype == "float64":
                continue
            specs[name] = SegmentSpec(
                segment=name, compute_dtype=compute_dtype,
                accumulation=accumulation, budget=d.forced_budget,
                source="forced")
        return cls(specs)


#: the process override policy (None: resolve through the manifest)
_override: Optional[PrecisionPolicy] = None


def active_policy() -> Optional[PrecisionPolicy]:
    return _override


def set_policy(policy: Optional[PrecisionPolicy]) -> None:
    """Install (or clear, with ``None``) the process override policy."""
    global _override
    if policy is not None and not isinstance(policy, PrecisionPolicy):
        raise UsageError(
            f"set_policy takes a PrecisionPolicy or None, got "
            f"{type(policy).__name__}")
    _override = policy


@contextlib.contextmanager
def use_policy(policy: Optional[PrecisionPolicy]):
    """Scoped :func:`set_policy`."""
    global _override
    prev = _override
    set_policy(policy)
    try:
        yield policy
    finally:
        _override = prev


def override_spec(segment: str) -> Optional[SegmentSpec]:
    """The override policy's spec for ``segment``, or None when no override
    is installed (manifest resolution applies)."""
    if _override is None:
        return None
    return _override.spec_for(segment)


def _ntoas(toas) -> int:
    """The reference's ``len(toas)`` of a :class:`~pint_torch.toa.TOABatch`."""
    return int(toas.ntoas)


def precision_vkey(segment: str, model=None, toas=None) -> tuple:
    """The manifest vkey of one segment's decision.  Model-bound segments
    carry the full parameter/mask signature and the TOA set's version and
    size (any edit falls back to float64); deployment-generic segments
    carry the kernel schema version."""
    d = _require_segment(segment)
    if not d.model_bound:
        return ("precision", segment, 1)
    if model is None or toas is None:
        raise UsageError(
            f"precision segment {segment!r} is model-bound; its vkey "
            "needs (model, toas)")
    from pint_torch.grid import _model_param_sig

    return ("precision", segment, _model_param_sig(model),
            getattr(toas, "_version", 0), _ntoas(toas))


def spec_from_decision(segment: str, value: Any) -> Optional[SegmentSpec]:
    """Validate a manifest decision value into a :class:`SegmentSpec`;
    ``None`` on any malformation (the consumer degrades to float64)."""
    if not isinstance(value, dict):
        return None
    dt = value.get("compute_dtype")
    acc = value.get("accumulation", "native")
    budget = value.get("budget", 0.0)
    rel = value.get("rel_err")
    if dt not in COMPUTE_DTYPES or acc not in ACCUMULATIONS:
        return None
    if not isinstance(budget, (int, float)) or isinstance(budget, bool) \
            or budget < 0:
        return None
    if rel is not None and (not isinstance(rel, (int, float))
                            or isinstance(rel, bool) or rel < 0):
        return None
    try:
        return SegmentSpec(segment=segment, compute_dtype=dt,
                           accumulation=acc, budget=float(budget),
                           rel_err=None if rel is None else float(rel),
                           source="tuned")
    except UsageError:
        return None


def _emit_applied(spec: SegmentSpec) -> None:
    log.debug(f"precision_applied: segment={spec.segment} "
              f"compute_dtype={spec.compute_dtype} "
              f"accumulation={spec.accumulation} source={spec.source} "
              f"budget={spec.budget} rel_err={spec.rel_err}")


def segment_spec(segment: str, model=None, toas=None,
                 vkey: Optional[tuple] = None) -> SegmentSpec:
    """The spec a consumer should run ``segment`` with, resolved override
    -> manifest -> float64 default (see the module docstring)."""
    d = _require_segment(segment)
    o = override_spec(segment)
    if o is not None:
        if o.reduced:
            _emit_applied(o)
        return o
    if config.tune_dir() is None:
        return SegmentSpec(segment=segment)
    if segment == "grid.correction":
        # the grid's correction probe owns this decision under its own
        # manifest key (grid.correction_dtype): one source of truth
        if model is None or toas is None:
            return SegmentSpec(segment=segment)
        from pint_torch import autotune

        dt = autotune.resolve_correction_dtype(model, toas)
        if dt == "float64":
            return SegmentSpec(segment=segment)
        return SegmentSpec(segment=segment, compute_dtype=dt,
                           accumulation="native", budget=d.safe_rel,
                           source="tuned")
    if vkey is None:
        if d.model_bound and (model is None or toas is None):
            return SegmentSpec(segment=segment)
        vkey = precision_vkey(segment, model=model, toas=toas)
    from pint_torch import autotune

    value, source = autotune.resolve(f"precision.{segment}", vkey, None,
                                     requested=False)
    if source != "tuned" or value is None:
        return SegmentSpec(segment=segment)
    spec = spec_from_decision(segment, value)
    if spec is None:
        return SegmentSpec(segment=segment)
    if spec.reduced:
        _emit_applied(spec)
    return spec


def describe_segments(model=None, toas=None) -> Dict[str, dict]:
    """Resolved spec summary per registered segment: model-bound segments
    resolve with the given workload (the float64 default without one)."""
    out: Dict[str, dict] = {}
    for name, d in SEGMENTS.items():
        if d.model_bound and (model is None or toas is None):
            spec = override_spec(name) or SegmentSpec(segment=name)
        else:
            spec = segment_spec(name, model=model, toas=toas)
        out[name] = {"compute_dtype": spec.compute_dtype,
                     "accumulation": spec.accumulation,
                     "source": spec.source, "tag": spec.tag()}
    return out
