"""Warm-started incremental refits: the streaming engine (port of
``pint_tpu/streaming/update.py``).

:class:`StreamingGLS` wraps a converged :class:`~pint_torch.gls_fitter.
GLSFitter` and turns "new TOAs arrived" into ``O(k K^2)`` of work:

1. the ingestion gate -- every appended block is validated (collect
   policy): bad rows go to the stream's pen without touching the factor;
2. the rank-k factor work -- the certified rows become one
   :class:`~pint_torch.streaming.cache.StreamCache` append (K9, the block
   padded up the append-block-size ladder);
3. warm Gauss-Newton -- ``steps`` steps against the held factor from the
   previous solution, the parameters and uncertainties written back to the
   fitter's model.

:meth:`StreamingGLS.quarantine_rows` downdates certified rows,
:meth:`StreamingGLS.release_quarantined` re-admits them as a rank-k
update (never a rebuild), :meth:`StreamingGLS.apply_validation` turns a
re-validation pass into exactly those downdates and updates.
:func:`stream_updates` runs a sequence of batches with per-batch
persistence through :class:`~pint_torch.runtime.checkpoint.
SweepCheckpoint`: a cut stream resumes from its last completed batch with
bitwise the same state.  The lifecycle telemetry events of the reference
wait for ROADMAP queue A item 8; the counters stay (``rebuilds`` here, the
cache's ``fallbacks`` and ``last_refused_condition``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pint_torch.fitter import UsageError
from pint_torch.streaming.cache import StreamCache
from pint_torch.streaming.lowrank import DEFAULT_BLOCK_BUCKETS

__all__ = ["UpdateOutcome", "StreamingGLS", "stream_updates",
           "DEFAULT_WARM_STEPS"]

#: warm Gauss-Newton steps per update: the second is iterative refinement
#: of the first
DEFAULT_WARM_STEPS = 2


@dataclass
class UpdateOutcome:
    """What one stream operation did."""

    kind: str                     #: append | downdate | release
    block: int                    #: rows in the arriving/operated block
    quarantined: int = 0          #: rows the ingestion gate penned
    steps: int = 0                #: warm GN steps run
    chi2: float = float("nan")    #: augmented-system chi2 after
    dx_final: float = float("nan")  #: |dx| of the last warm step
    fallback: Optional[str] = None  #: refactor reason (None: rank-k)
    #: hand-kernel builds during the operation (the reference's fresh XLA
    #: compiles)
    compiles: int = 0
    latency_ms: Optional[float] = None
    block_id: Optional[int] = None  #: cache block the rows landed in
    params: Dict[str, float] = field(default_factory=dict)


def _builds() -> int:
    from pint_torch.kernels import _build

    return _build.build_count()


class StreamingGLS:
    """The streaming engine of one GLS fit (module docstring), on the
    fitter's device."""

    def __init__(self, fitter, block_buckets: Optional[Sequence[int]] = None,
                 steps: int = DEFAULT_WARM_STEPS):
        from pint_torch.gls_fitter import GLSFitter

        if not isinstance(fitter, GLSFitter):
            raise UsageError(
                f"StreamingGLS wraps a GLSFitter, got "
                f"{type(fitter).__name__} (the rank-k paths rewrite the "
                "Woodbury normal-equation factor, which only the GLS "
                "family builds)")
        if block_buckets is None:
            # the tuning manifest's append-block-size ladder, else the
            # static one
            from pint_torch import autotune

            tuned = autotune.resolve_update_blocks()
            block_buckets = tuned if tuned is not None \
                else DEFAULT_BLOCK_BUCKETS
        self.fitter = fitter
        self.steps = int(steps)
        if self.steps < 1:
            raise UsageError(f"steps must be >= 1, got {steps}")
        certified = fitter.batch.certified(fitter.model)
        self.cache = StreamCache(fitter.model, certified,
                                 block_buckets=block_buckets)
        #: the quarantine pen: penned blocks awaiting repair, by pen id ->
        #: (batch, reasons)
        self.pen: Dict[int, tuple] = {}
        self._next_pen_id = 0

    @property
    def rebuilds(self) -> int:
        """Full refactors paid so far."""
        return self.cache.rebuilds

    def _finish(self, out: UpdateOutcome, builds0: int,
                t0: float) -> UpdateOutcome:
        out.compiles = _builds() - builds0
        out.latency_ms = 1e3 * (time.perf_counter() - t0)
        return out

    def _warm_refit(self, out: UpdateOutcome,
                    steps: Optional[int] = None) -> UpdateOutcome:
        nsteps = self.steps if steps is None else int(steps)
        dxn = self.cache.warm_steps(nsteps)
        out.steps = nsteps
        out.dx_final = float(dxn[-1])
        out.chi2 = self.cache.chi2
        sol = self.cache.solution()
        errs = self.cache.errors()
        model = self.fitter.model
        for i, p in enumerate(self.cache.params):
            if p == "Offset":
                continue
            par = model[p]
            par.value = sol[p]
            par.uncertainty = float(errs[i])
            self.fitter.errors[p] = float(errs[i])
        self.fitter.resids.noise_ampls = self.cache.noise_ampls()
        out.params = sol
        return out

    def _pen(self, batch, report) -> None:
        self.pen[self._next_pen_id] = (
            batch.quarantined(self.fitter.model),
            [r for r, q in zip(report.reasons_by_row(), report.mask) if q])
        self._next_pen_id += 1

    def update_toas(self, new_toas, steps: Optional[int] = None
                    ) -> UpdateOutcome:
        """Append one block: the validate/quarantine gate, a rank-k update
        for the certified rows, a warm refit.  Bad rows land in the pen; an
        empty certified block returns without touching the factor."""
        t0, b0 = time.perf_counter(), _builds()
        if new_toas.ntoas < 1:
            raise UsageError("update_toas needs a non-empty TOA block")
        report = new_toas.validate(policy="collect")
        certified = new_toas.certified(self.fitter.model)
        out = UpdateOutcome(kind="append", block=new_toas.ntoas,
                            quarantined=report.n_quarantined)
        if report.n_quarantined:
            self._pen(new_toas, report)
        if certified.ntoas == 0:
            out.chi2 = self.cache.chi2
            return self._finish(out, b0, t0)
        block, fallback = self.cache.append(certified)
        out.block_id = block.block_id
        out.fallback = fallback
        out = self._warm_refit(out, steps=steps)
        self._sync_fitter_toas()
        return self._finish(out, b0, t0)

    def _sync_fitter_toas(self) -> None:
        """The fitter's views: ``batch_full`` the tracked union (its
        quarantine mask mirroring the factor's rows), ``batch`` its
        certified complement."""
        self.cache.sync_container_mask()
        self.fitter.batch_full = self.cache.toas
        self.fitter.batch = self.cache.toas.certified()

    def quarantine_rows(self, block_id: int, rows: Sequence[int]
                        ) -> UpdateOutcome:
        """Quarantine certified rows: a rank-k downdate of exactly those
        rows, then a warm refit."""
        t0, b0 = time.perf_counter(), _builds()
        rows = list(rows)
        if not rows:
            raise UsageError("quarantine_rows needs at least one row")
        out = UpdateOutcome(kind="downdate", block=len(rows),
                            block_id=block_id)
        out.fallback = self.cache.downdate_rows(block_id, rows)
        out = self._warm_refit(out)
        self._sync_fitter_toas()
        return self._finish(out, b0, t0)

    def release_quarantined(self, block_id: int, rows: Sequence[int]
                            ) -> UpdateOutcome:
        """Release repaired rows: a rank-k update of exactly those rows,
        never a rebuild, then a warm refit."""
        t0, b0 = time.perf_counter(), _builds()
        rows = list(rows)
        if not rows:
            raise UsageError("release_quarantined needs at least one row")
        out = UpdateOutcome(kind="release", block=len(rows),
                            block_id=block_id)
        out.fallback = self.cache.release_rows(block_id, rows)
        self.cache._block(block_id).validator_downdated[
            list(map(int, rows))] = False
        out = self._warm_refit(out)
        self._sync_fitter_toas()
        return self._finish(out, b0, t0)

    def apply_validation(self, toas=None) -> List[UpdateOutcome]:
        """A re-validation pass (collect policy) over the tracked union as
        downdates (certified rows now failing) and updates (rows this
        validator downdated that now pass); the baseline is the engine's
        own alive rows."""
        toas = toas if toas is not None else self.cache.toas
        report = toas.validate(policy="collect")
        mask = report.mask
        blocks = self.cache.blocks
        alive = np.concatenate([b.alive for b in blocks]) \
            if blocks else np.zeros(0, dtype=bool)
        vdown = np.concatenate([b.validator_downdated for b in blocks]) \
            if blocks else np.zeros(0, dtype=bool)
        if len(mask) != len(alive):
            raise UsageError(
                f"validated container has {len(mask)} rows; the stream "
                f"tracks {len(alive)} -- apply_validation takes the "
                "stream's own certified union")
        outcomes: List[UpdateOutcome] = []
        quarantined = np.nonzero(mask & alive)[0]
        released = np.nonzero(~mask & ~alive & vdown)[0]
        for block_id, rows in self._rows_to_blocks(quarantined):
            outcomes.append(self.quarantine_rows(block_id, rows))
            self.cache._block(block_id).validator_downdated[rows] = True
        for block_id, rows in self._rows_to_blocks(released):
            outcomes.append(self.release_quarantined(block_id, rows))
        self._sync_fitter_toas()
        return outcomes

    def _rows_to_blocks(self, global_rows) -> List[Tuple[int, List[int]]]:
        """Global tracked-union rows as (block_id, local rows) groups."""
        out: Dict[int, List[int]] = {}
        offsets = []
        off = 0
        for blk in self.cache.blocks:
            offsets.append((off, off + len(blk.r), blk))
            off += len(blk.r)
        for g in sorted(set(int(i) for i in global_rows)):
            for lo, hi, blk in offsets:
                if lo <= g < hi:
                    out.setdefault(blk.block_id, []).append(g - lo)
                    break
            else:
                raise UsageError(
                    f"row {g} is outside the stream's {off} tracked rows")
        return sorted(out.items())


def _invoke_stream(engine: StreamingGLS, batch, index: int):
    """The per-batch apply call (a seam a test can interpose)."""
    return engine.update_toas(batch)


#: per-block state saved once (immutable after ingest) and in every chunk
_BLOCK_STATIC = ("M", "r", "w", "x")
_BLOCK_MUTABLE = ("alive", "vdown")


def _chunk_payload(engine: StreamingGLS, saved_ids: set) -> dict:
    """One chunk: the factor and meta state, every block's mutable row
    state, and the full arrays of only the blocks not yet saved."""
    full = engine.cache.state_dict()
    out = {k: v for k, v in full.items()
           if k == "block_ids" or not k.startswith("block_")}
    for blk in engine.cache.blocks:
        tag = f"block_{blk.block_id}"
        for key in _BLOCK_MUTABLE:
            out[f"{tag}_{key}"] = full[f"{tag}_{key}"]
        if blk.block_id not in saved_ids:
            for key in _BLOCK_STATIC:
                out[f"{tag}_{key}"] = full[f"{tag}_{key}"]
    sol = engine.cache.solution()
    out["model_values"] = np.array(
        [sol[p] for p in engine.cache.params if p != "Offset"])
    return out


def stream_updates(engine: StreamingGLS, batches: Sequence,
                   checkpoint: Optional[str] = None) -> List[UpdateOutcome]:
    """Apply ``batches`` to ``engine`` in order; with ``checkpoint`` each
    completed batch saves the stream state as one
    :class:`~pint_torch.runtime.checkpoint.SweepCheckpoint` chunk and a
    rerun resumes after the last completed one, bitwise.  The fingerprint
    carries the stream's frame key and the batch sizes."""
    from pint_torch.runtime.checkpoint import SweepCheckpoint, fingerprint_of
    from pint_torch.toa import merge_TOAs

    outcomes: List[UpdateOutcome] = []
    ckpt = None
    start = 0
    saved_ids: set = set()
    if checkpoint is not None:
        fp = fingerprint_of(vkey=repr(engine.cache.vkey),
                            batches=[int(b.ntoas) for b in batches])
        ckpt = SweepCheckpoint(checkpoint, fp, len(batches))
        done = ckpt.completed()
        while start < len(batches) and start in done:
            start += 1
        if start:
            # incremental chunks: accumulate ascending, newest wins
            state: dict = {}
            for j in range(start):
                state.update(ckpt.load(j))
            saved_ids = {int(k[len("block_"):-len("_M")]) for k in state
                         if k.startswith("block_") and k.endswith("_M")}
            engine.cache.load_state({k: np.asarray(v)
                                     for k, v in state.items()
                                     if k != "model_values"})
            vals = np.asarray(state["model_values"])
            for p, v in zip([p for p in engine.cache.params
                             if p != "Offset"], vals):
                engine.fitter.model[p].value = float(v)
            # the certified union through the same gate the original pass
            # used, and the penned rows re-penned
            union = engine.cache.toas
            for b in batches[:start]:
                rep = b.validate(policy="collect")
                cert = b.certified(engine.fitter.model)
                if cert.ntoas:
                    union = merge_TOAs([union, cert])
                if rep.n_quarantined:
                    engine._pen(b, rep)
            engine.cache._toas = union
            engine._sync_fitter_toas()
    for i in range(start, len(batches)):
        outcomes.append(_invoke_stream(engine, batches[i], i))
        if ckpt is not None:
            ckpt.save(i, **_chunk_payload(engine, saved_ids))
            saved_ids.update(b.block_id for b in engine.cache.blocks)
    return outcomes
