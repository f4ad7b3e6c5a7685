"""The ``update`` request class: streaming appends as served traffic (port
of ``pint_tpu/streaming/door.py:148-227``).

:class:`UpdateRequest` / :class:`UpdateResult` are the wire shapes of one
update: an appended TOA block, or a quarantine/release of tracked rows.
:func:`run_update_requests` is one coalescing pass: the appends of a pass
merge into one block (one validation, one rank-k dispatch at the merged
rows' rung, one warm refit), the row operations apply in request order,
and the whole batch is validated before anything is applied.  The warm
pool that :func:`warm_stream` fills in the reference becomes CUDA graphs in
ROADMAP queue A item 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from pint_torch.fitter import UsageError
from pint_torch.streaming.update import StreamingGLS, UpdateOutcome

__all__ = ["UpdateRequest", "UpdateResult", "run_update_requests",
           "stream_vkey", "warm_stream"]

_KINDS = ("append", "quarantine", "release")


@dataclass
class UpdateRequest:
    """One streaming update: either an appended block (``new_toas``) or a
    quarantine/release of tracked rows (``kind``, ``block_id``, ``rows``)."""

    new_toas: Optional[object] = None     #: TOA batch to append
    kind: str = "append"
    block_id: Optional[int] = None        #: cache block (row operations)
    rows: Optional[Sequence[int]] = None  #: local rows (row operations)
    request_id: Optional[str] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise UsageError(f"UpdateRequest kind {self.kind!r} not in "
                             f"{_KINDS}")
        if self.kind == "append":
            if self.new_toas is None or self.new_toas.ntoas < 1:
                raise UsageError(
                    "append UpdateRequest needs a non-empty new_toas block")
        elif self.block_id is None or self.rows is None \
                or len(self.rows) == 0:
            raise UsageError(
                f"{self.kind} UpdateRequest needs block_id and a non-empty "
                "rows list")

    @property
    def n_rows(self) -> int:
        return self.new_toas.ntoas if self.kind == "append" \
            else len(self.rows)


@dataclass
class UpdateResult:
    """Outcome of one served update request."""

    kind: str
    outcome: UpdateOutcome         #: the engine's full report
    chi2: float
    params: dict                   #: updated physical parameter values
    quarantined: int = 0
    fallback: Optional[str] = None
    batch: int = 1                 #: coalesced batch size dispatched
    #: True on the coalesced batch's first member only: per-operation
    #: accounting gates on it so that a sum over requests counts once
    first_in_batch: bool = True
    #: hand-kernel builds of the dispatch, on its first member only
    compiles: int = 0
    latency_ms: Optional[float] = None
    request_id: Optional[str] = None


def stream_vkey(engine: StreamingGLS) -> tuple:
    """Version key of one stream's kernels: its frame key (model
    parameter signature and frame width) and the kernel schema."""
    return ("stream_kernel", 1) + tuple(map(repr, engine.cache.vkey))


def warm_stream(engine, pool, block_sizes=None, steps=None):
    """The reference's warm-pool registration of the stream kernels; the
    port's warm layer (CUDA graphs per append rung) is ROADMAP queue A
    item 8."""
    raise NotImplementedError(
        "warm_stream: the warm pool of the stream kernels (CUDA graphs per "
        "append rung) is ROADMAP queue A item 8")


def run_update_requests(engine: StreamingGLS,
                        requests: Sequence[UpdateRequest]
                        ) -> List[UpdateResult]:
    """One coalescing pass over update requests: appends merged into one
    block and applied first, row operations in request order; results in
    request order, coalesced members sharing the batch's outcome.  Every
    request is checked against a simulated alive state before anything is
    applied."""
    from pint_torch.toa import merge_TOAs

    planned: dict = {}
    for q in requests:
        if not isinstance(q, UpdateRequest):
            raise UsageError(
                f"the update door takes UpdateRequest, got "
                f"{type(q).__name__}")
        if q.kind == "append":
            continue
        blk = engine.cache._block(q.block_id)
        alive = planned.setdefault(q.block_id, blk.alive.copy())
        rows = sorted(set(int(i) for i in q.rows))
        if rows[0] < 0 or rows[-1] >= len(blk.r):
            raise UsageError(
                f"request {q.request_id!r}: rows {rows} out of range "
                f"for block {q.block_id} ({len(blk.r)} rows)")
        want_alive = q.kind == "quarantine"
        for i in rows:
            if alive[i] != want_alive:
                raise UsageError(
                    f"request {q.request_id!r}: block {q.block_id} "
                    f"row {i} is {'already' if want_alive else 'not'} "
                    f"{'downdated' if want_alive else 'quarantined'} "
                    "once the batch's earlier operations apply")
            alive[i] = not want_alive
    out: List[Optional[UpdateResult]] = [None] * len(requests)
    appends = [i for i, q in enumerate(requests) if q.kind == "append"]
    if appends:
        block = requests[appends[0]].new_toas if len(appends) == 1 \
            else merge_TOAs([requests[i].new_toas for i in appends])
        o = engine.update_toas(block)
        for j, i in enumerate(appends):
            out[i] = UpdateResult(
                kind="append", outcome=o, chi2=o.chi2, params=o.params,
                quarantined=o.quarantined if j == 0 else 0,
                fallback=o.fallback, batch=len(appends),
                first_in_batch=j == 0,
                compiles=o.compiles if j == 0 else 0,
                latency_ms=o.latency_ms,
                request_id=requests[i].request_id)
    for i, q in enumerate(requests):
        if q.kind == "append":
            continue
        o = (engine.quarantine_rows(q.block_id, q.rows)
             if q.kind == "quarantine"
             else engine.release_quarantined(q.block_id, q.rows))
        out[i] = UpdateResult(
            kind=q.kind, outcome=o, chi2=o.chi2, params=o.params,
            fallback=o.fallback, compiles=o.compiles,
            latency_ms=o.latency_ms, request_id=q.request_id)
    return out  # type: ignore[return-value]
