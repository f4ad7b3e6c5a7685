"""PredictRequest/PredictResult and the batched evaluation of coalesced
requests on K13 (port of ``pint_tpu/predict/door.py``).

Requests are grouped by the time ladder's rung, chunked at the batch
ladder's top, and each chunk is padded onto the ladders and evaluated by
one launch of K13 (:mod:`pint_torch.kernels.polyco_eval`) on the cache's
device; the integer reference phase is added on the host.  The warm pool
(:func:`warm_predict`, ``pool=``) is ROADMAP queue A item 8 and raises.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_torch import F64
from pint_torch.exceptions import UsageError
from pint_torch.kernels import _build
from pint_torch.kernels.polyco_eval import polyco_eval
from pint_torch.serving.batcher import DEFAULT_BATCH_BUCKETS, bucket_of

__all__ = [
    "DEFAULT_TIME_BUCKETS",
    "PredictRequest",
    "PredictResult",
    "predict_vkey",
    "run_predict_requests",
    "update_epoch_span",
    "warm_predict",
]

#: ladder of the per-request epoch count
DEFAULT_TIME_BUCKETS: Tuple[int, ...] = (16, 64, 256, 1024)

_ITEM8 = "the warm pool is ROADMAP queue A item 8, not ported yet"


@dataclass
class PredictRequest:
    """One phase/frequency prediction request: epochs (MJD, UTC at the
    cache's observatory) inside the predictor's coverage."""

    times_mjd: np.ndarray
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])

    def __post_init__(self):
        t = np.atleast_1d(np.asarray(self.times_mjd, dtype=np.float64))
        if t.ndim != 1 or t.size < 1:
            raise UsageError(
                f"PredictRequest needs a non-empty 1-D array of MJDs, "
                f"got shape {np.asarray(self.times_mjd).shape}")
        self.times_mjd = t

    @property
    def n(self) -> int:
        return int(self.times_mjd.size)


@dataclass
class PredictResult:
    """Predicted absolute phase (int + frac, cycles) and apparent spin
    frequency (Hz) at each requested epoch; ``compiles`` the kernel
    libraries built during the call (0 once they are built)."""

    phase_int: np.ndarray
    phase_frac: np.ndarray
    freq: np.ndarray
    bucket: int
    batch: int
    windows: int = 0
    compiles: int = 0
    latency_ms: Optional[float] = None
    request_id: Optional[str] = None


def predict_vkey() -> tuple:
    """Version key of the predict kernels: schema-only (every
    model-dependent quantity is an operand)."""
    return ("predict_kernel", 1)


def _dispatch(cache, pool, bucket: int, group: List[PredictRequest],
              batch_buckets: Sequence[int]) -> List[PredictResult]:
    """Serve one shape-aligned group: gather each request's operands from
    the cache, pad onto the batch and time ladders, one K13 launch, slice
    per request."""
    if pool is not None:
        raise NotImplementedError(f"predict dispatch with pool=: {_ITEM8}")
    t0 = time.perf_counter()
    builds0 = _build.build_count()
    B = bucket_of(len(group), batch_buckets)
    ncoeff = cache.ncoeff
    dt = np.zeros((B, bucket))
    rf = np.zeros((B, bucket))
    f0 = np.zeros((B, bucket))
    cf = np.zeros((B, bucket, ncoeff))
    rint = np.zeros((B, bucket))
    nwin: List[int] = []
    for i, q in enumerate(group):
        g = cache.gather(q.times_mjd)
        n = q.n
        dt[i, :n] = g["dt"]
        rf[i, :n] = g["rfrac"]
        f0[i, :n] = g["f0"]
        cf[i, :n] = g["coeffs"]
        rint[i, :n] = g["rint"]
        nwin.append(int(len(np.unique(g["windows"]))))
    dev = cache.device
    ip, frac, freq = (a.cpu().numpy() for a in polyco_eval(
        *(torch.tensor(a, dtype=F64, device=dev) for a in (dt, rf, f0, cf))))
    compiles = _build.build_count() - builds0
    wall_ms = 1e3 * (time.perf_counter() - t0)
    out: List[PredictResult] = []
    for i, q in enumerate(group):
        n = q.n
        out.append(PredictResult(
            phase_int=rint[i, :n] + ip[i, :n],
            phase_frac=frac[i, :n].copy(),
            freq=freq[i, :n].copy(),
            bucket=int(bucket), batch=len(group),
            windows=nwin[i],
            compiles=int(compiles) if i == 0 else 0,
            latency_ms=wall_ms,
            request_id=q.request_id))
    return out


def run_predict_requests(cache, pool, requests: Sequence[PredictRequest],
                         time_buckets: Sequence[int] = DEFAULT_TIME_BUCKETS,
                         batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                         ) -> List[PredictResult]:
    """Serve a coalesced predict batch on the cache's device: group by the
    time ladder's rung, chunk each group at the batch ladder's top, one
    padded K13 launch a chunk.  Results come back in request order;
    ``pool`` must be None (ROADMAP queue A item 8)."""
    if pool is not None:
        raise NotImplementedError(f"run_predict_requests(pool=...): "
                                  f"{_ITEM8}")
    for q in requests:
        if not isinstance(q, PredictRequest):
            raise UsageError(
                f"run_predict_requests takes PredictRequest instances, "
                f"got {type(q).__name__}")
    top = max(batch_buckets)
    order = {id(q): i for i, q in enumerate(requests)}
    by_bucket: Dict[int, List[PredictRequest]] = {}
    for q in requests:
        by_bucket.setdefault(bucket_of(q.n, time_buckets), []).append(q)
    paired: List[Tuple[PredictRequest, PredictResult]] = []
    for bucket in sorted(by_bucket):
        qs = by_bucket[bucket]
        for lo in range(0, len(qs), top):
            chunk = qs[lo:lo + top]
            paired.extend(zip(chunk, _dispatch(cache, None, bucket, chunk,
                                               batch_buckets)))
    paired.sort(key=lambda pr: order[id(pr[0])])
    return [r for _, r in paired]


def update_epoch_span(requests) -> Tuple[Optional[float], Optional[float]]:
    """The epoch range an update batch's appends cover (the span the
    streaming hook invalidates by); ``(None, None)`` without appends.  An
    append's ``new_toas`` is a :class:`~pint_torch.toa.TOABatch` or host
    :class:`~pint_torch.toa.TOAs`."""
    lo: Optional[float] = None
    hi: Optional[float] = None
    for q in requests:
        if getattr(q, "kind", "append") != "append":
            continue
        t = q.new_toas
        mjds = np.asarray(t.get_mjds() if hasattr(t, "get_mjds")
                          else t.mjds, dtype=np.float64)
        if not mjds.size:
            continue
        lo = float(mjds.min()) if lo is None else min(lo, float(mjds.min()))
        hi = float(mjds.max()) if hi is None else max(hi, float(mjds.max()))
    return lo, hi


def warm_predict(cache, pool, time_buckets=DEFAULT_TIME_BUCKETS,
                 batch_buckets=DEFAULT_BATCH_BUCKETS):
    """The reference's warm-pool registration of every predict shape:
    ROADMAP queue A item 8 (CUDA graphs per rung), not ported yet."""
    raise NotImplementedError(f"warm_predict: {_ITEM8}")
