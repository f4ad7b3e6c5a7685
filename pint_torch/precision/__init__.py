"""Precision layer: float32/bfloat16 matmul segments under stated error
budgets (port of ``pint_tpu/precision/``).

Three pieces:

* :mod:`~pint_torch.precision.policy` -- :class:`SegmentSpec` descriptors
  (segment name, compute dtype, accumulation mode, admitted error budget)
  of the named hot-path segments, resolved override -> tuning manifest
  (``precision.<segment>`` keys) -> bit-identical float64 default;
* :mod:`~pint_torch.precision.compensated` -- :func:`downcast` and
  :func:`matmul` with ``native`` / ``f64`` / ``two_sum`` / ``two_prod``
  accumulation back to float64, a reduced product running kernel K11
  (:mod:`pint_torch.kernels.compensated_matmul`);
* :mod:`~pint_torch.precision.tune` -- per-segment probes that run the
  consumers float64-vs-reduced on the workload's own operands and persist
  ``precision.<segment>`` decisions only inside each segment's budget.

Consumers: the GLS fitter's normal-equation and Schur Grams
(``gls.design``), the chunked GLS grid (``grid.gram`` and
``grid.correction``), the serve batcher (``serve.gram``) and the
catalogue's batched fit and joint likelihood (``catalog.fit``,
``catalog.lnlike``).
"""

from pint_torch.precision.compensated import (DEFAULT_SPLIT, downcast,
                                              matmul, promote_f64,
                                              two_sum_accumulate)
from pint_torch.precision.policy import (ACCUMULATIONS, COMPUTE_DTYPES,
                                         SEGMENTS, PrecisionPolicy,
                                         SegmentDef, SegmentSpec,
                                         active_policy, describe_segments,
                                         override_spec, precision_vkey,
                                         segment_spec, set_policy,
                                         spec_from_decision, use_policy)
from pint_torch.precision.tune import probe_segment, tune_precision_segments

__all__ = [
    "ACCUMULATIONS", "COMPUTE_DTYPES", "DEFAULT_SPLIT", "SEGMENTS",
    "PrecisionPolicy", "SegmentDef", "SegmentSpec", "active_policy",
    "describe_segments", "downcast", "matmul", "override_spec",
    "precision_vkey", "probe_segment", "promote_f64", "segment_spec",
    "set_policy", "spec_from_decision", "tune_precision_segments",
    "two_sum_accumulate", "use_policy",
]
