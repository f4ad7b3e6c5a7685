"""Streaming timing: incremental GLS updates (port of
``pint_tpu/streaming``).

* :mod:`~pint_torch.streaming.lowrank` -- rank-k Cholesky up/downdates of
  the normal-equation factor on K9 (append = update, quarantine =
  downdate), with the condition guard that falls back to a refactor;
* :mod:`~pint_torch.streaming.cache` -- the epoch-rolling stream state:
  per-block design rows, the living factor on the device, ``O(K^2)``
  rhs/chi2 maintenance;
* :mod:`~pint_torch.streaming.update` -- :class:`StreamingGLS`
  (``GLSFitter.update_toas`` / ``release_quarantined`` delegate here) and
  :func:`stream_updates`, checkpointed and resumable bitwise;
* :mod:`~pint_torch.streaming.door` -- the ``update`` request class.
"""

from pint_torch.streaming.cache import StreamBlock, StreamCache
from pint_torch.streaming.door import (UpdateRequest, UpdateResult,
                                       run_update_requests, stream_vkey,
                                       warm_stream)
from pint_torch.streaming.lowrank import (CONDITION_LIMIT,
                                          DEFAULT_BLOCK_BUCKETS,
                                          FactorUpdate, apply_rank_update,
                                          chol_downdate, chol_update,
                                          factor_condition)
from pint_torch.streaming.update import (DEFAULT_WARM_STEPS, StreamingGLS,
                                         UpdateOutcome, stream_updates)

__all__ = [
    "CONDITION_LIMIT", "DEFAULT_BLOCK_BUCKETS", "DEFAULT_WARM_STEPS",
    "FactorUpdate", "StreamBlock", "StreamCache", "StreamingGLS",
    "UpdateOutcome", "UpdateRequest", "UpdateResult",
    "apply_rank_update", "chol_downdate", "chol_update",
    "factor_condition", "run_update_requests", "stream_updates",
    "stream_vkey", "warm_stream",
]
