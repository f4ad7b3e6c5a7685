"""Catalog shape buckets: ragged TOA counts onto a padded shape ladder
(host copy of ``pint_tpu/catalog/buckets.py:39-153``).

:func:`learn_ladders` walks each dimension's values largest-first and opens
a new rung only when padding to the current rung would waste more than the
budget, never more than ``max_rungs`` rungs; :func:`assign_buckets` rounds
each shape up its ladders with the serve batcher's
:func:`~pint_torch.serving.batcher.bucket_of`.  The reference's
``catalog_bucket`` telemetry event waits for ROADMAP queue A item 8
(``emit`` is accepted and does nothing).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from pint_torch.fitter import UsageError

__all__ = ["learn_ladders", "assign_buckets", "BucketPlan"]


def _learn_one(values: Sequence[int], pad_budget: float,
               max_rungs: int) -> Tuple[int, ...]:
    """Rungs for one dimension, largest-first greedy; the budget doubles
    until at most ``max_rungs`` rungs are needed."""
    vals = sorted({int(v) for v in values}, reverse=True)
    budget = float(pad_budget)
    while True:
        rungs = [vals[0]]
        for v in vals[1:]:
            if (rungs[-1] - v) / rungs[-1] > budget:
                rungs.append(v)
        if len(rungs) <= max_rungs:
            return tuple(sorted(rungs))
        budget *= 2.0


def learn_ladders(shapes: Sequence[Tuple[int, int]],
                  pad_budget: float = 0.25,
                  max_rungs: int = 4) -> Tuple[Tuple[int, ...],
                                               Tuple[int, ...]]:
    """``(ntoa_ladder, nfree_ladder)`` learned from a catalog's ``(n_toas,
    n_free)`` shapes; every shape fits under its ladder's top."""
    shapes = [(int(n), int(k)) for n, k in shapes]
    if not shapes:
        raise UsageError("learn_ladders needs at least one shape")
    if any(n < 1 or k < 1 for n, k in shapes):
        raise UsageError(f"shapes must be positive, got {shapes}")
    if not (0.0 < pad_budget < 1.0):
        raise UsageError(f"pad_budget must be in (0, 1), got {pad_budget}")
    if max_rungs < 1:
        raise UsageError(f"max_rungs must be >= 1, got {max_rungs}")
    return (_learn_one([n for n, _ in shapes], pad_budget, max_rungs),
            _learn_one([k for _, k in shapes], pad_budget, max_rungs))


@dataclass
class BucketPlan:
    """One catalog's bucket assignment and what its padding costs."""

    ntoa_ladder: Tuple[int, ...]
    nfree_ladder: Tuple[int, ...]
    shapes: List[Tuple[int, int]]
    #: (bucket_ntoas, bucket_nfree) -> member indices into ``shapes``
    buckets: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def pad_waste_frac(self) -> float:
        """``1 - sum(n_i k_i) / sum(bn_i bk_i)`` over the members."""
        real = sum(n * k for n, k in self.shapes)
        padded = sum(bn * bk * len(idx)
                     for (bn, bk), idx in self.buckets.items())
        return 1.0 - real / padded if padded else 0.0

    def bucket_of_index(self, i: int) -> Tuple[int, int]:
        for b, idx in self.buckets.items():
            if i in idx:
                return b
        raise KeyError(f"index {i} is in no bucket")

    def to_dict(self) -> dict:
        return {
            "ntoa_ladder": list(self.ntoa_ladder),
            "nfree_ladder": list(self.nfree_ladder),
            "n_buckets": self.n_buckets,
            "pad_waste_frac": self.pad_waste_frac,
            "buckets": {f"{bn}x{bk}": len(idx)
                        for (bn, bk), idx in sorted(self.buckets.items())},
        }


def assign_buckets(shapes: Sequence[Tuple[int, int]],
                   ntoa_ladder: Sequence[int],
                   nfree_ladder: Sequence[int],
                   emit: bool = True) -> BucketPlan:
    """Round every shape up its ladders (past a ladder's top it doubles) and
    group the members per padded shape."""
    from pint_torch.serving.batcher import bucket_of

    shapes = [(int(n), int(k)) for n, k in shapes]
    if not shapes:
        raise UsageError("assign_buckets needs at least one shape")
    plan = BucketPlan(ntoa_ladder=tuple(sorted(int(b) for b in ntoa_ladder)),
                      nfree_ladder=tuple(sorted(int(b)
                                                for b in nfree_ladder)),
                      shapes=shapes)
    if not (plan.ntoa_ladder and plan.nfree_ladder):
        raise UsageError("both ladders need at least one rung")
    for i, (n, k) in enumerate(shapes):
        b = (bucket_of(n, plan.ntoa_ladder),
             bucket_of(k, plan.nfree_ladder))
        plan.buckets.setdefault(b, []).append(i)
    return plan
