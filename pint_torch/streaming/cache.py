"""Epoch-rolling stream state: the fitter's linearized system as a living
factor (port of ``pint_tpu/streaming/cache.py``).

A :class:`StreamCache` freezes one linearization frame -- the normalized,
Jacobi-equilibrated Woodbury-form system ``(params, norm, phiinv)`` of the
certified TOAs at stream start -- and maintains under appends and
quarantine downdates what a warm Gauss-Newton step needs, on the device
between operations:

* ``L``, the Cholesky factor of ``A = M^T W M + diag(phiinv)``, rewritten
  per block by K9 (:mod:`pint_torch.kernels.chol_rank_update`) instead of
  refactored;
* ``b``, the right-hand side ``M^T W r`` at the current state, advanced in
  ``O(K^2)`` per step by ``b' = b - (A - diag(phiinv)) dx``;
* ``chi2``, the augmented-system chi2, advanced the same way;
* ``x``, the cumulative frame solution offset.

Each appended block keeps its frame-normalized design rows, its residuals
at the frame's reference model and its weights (what a later quarantine
downdate needs).  Rows are evaluated through
:func:`~pint_torch.gls_fitter.linearized_system` at the pristine reference
model with a retained sentinel row riding along; a column-layout change or
sentinel drift, or the rank-k condition guard refusing the updated
factor, triggers a full refactor (``rebuilds``), never a silently wrong
factor.  The host reads ``(ok, cond)`` per ingest and nothing else of the
factor.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_torch import F64
from pint_torch.fitter import UsageError
from pint_torch.streaming.lowrank import (CONDITION_LIMIT,
                                          DEFAULT_BLOCK_BUCKETS,
                                          factor_condition, ingest_kernel,
                                          refusal_reason)

__all__ = ["StreamBlock", "StreamCache", "FRAME_DRIFT_RTOL", "bucket_rows",
           "step_kernel", "err_kernel"]

#: relative drift of the sentinel design row past which the frozen frame
#: is stale and the cache refactors
FRAME_DRIFT_RTOL = 1e-6


def _block_rows(model, batch):
    """``(M_raw, r, w, params, norm)`` for one block through
    ``linearized_system``, the block's own normalization undone and no
    mean subtracted (a per-block mean is not in the Offset column's
    span)."""
    from pint_torch.gls_fitter import linearized_system
    from pint_torch.residuals import Residuals

    resids = Residuals(batch, model, subtract_mean=False)
    M, r, w, _, params, norm = linearized_system(model, batch, resids=resids)
    return M * norm, r, w, params, norm


@dataclass
class StreamBlock:
    """One ingested block's row state."""

    block_id: int
    M: torch.Tensor          #: (k, K) frame-normalized design rows
    r: torch.Tensor          #: (k,) residuals at the frame's reference [s]
    w: torch.Tensor          #: (k,) white-noise weights 1/Nvec
    x_ingest: torch.Tensor   #: (K,) frame solution offset at ingest
    alive: np.ndarray        #: (k,) False = downdated (quarantined)
    #: True where the validator downdated the row (``apply_validation``):
    #: only those rows auto-release when a later pass finds them clean
    validator_downdated: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.validator_downdated is None:
            self.validator_downdated = np.zeros(len(self.r), dtype=bool)

    @property
    def n_alive(self) -> int:
        return int(np.sum(self.alive))


def step_kernel(steps: int):
    """``(L, b, chi2, phiinv, x) -> (b', chi2', x', dx_norms (steps,))``:
    ``steps`` Gauss-Newton steps against the held factor (reference
    ``cache.py:116``), each ``dx = A^-1 (b - phiinv x)`` through the factor
    and the rhs and chi2 advanced by ``(A - D) dx = L (L^T dx) - phiinv dx``
    without touching the rows."""
    steps = int(steps)
    if steps < 1:
        raise UsageError(f"step_kernel needs steps >= 1, got {steps}")

    def kern(L, b, chi2, phiinv, x):
        norms = []
        for _ in range(steps):
            dx = torch.cholesky_solve((b - phiinv * x)[:, None], L)[:, 0]
            bd = L @ (L.T @ dx) - phiinv * dx
            chi2 = chi2 - 2.0 * torch.dot(dx, b) + torch.dot(dx, bd)
            b, x = b - bd, x + dx
            norms.append(torch.linalg.vector_norm(dx))
        return b, chi2, x, torch.stack(norms)

    return kern


def err_kernel():
    """``(L, norm) -> sqrt(diag(A^-1)) / norm``: the frame's physical
    1-sigma errors (reference ``cache.py:153``)."""
    def kern(L, norm):
        eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
        Ainv = torch.cholesky_solve(eye, L)
        return torch.sqrt(torch.clamp(torch.diagonal(Ainv), min=0.0)) / norm

    return kern


def bucket_rows(k: int, ladder: Sequence[int]) -> int:
    """The block-size rung ``k`` rows dispatch at (the serving
    :func:`~pint_torch.serving.batcher.bucket_of` rounding)."""
    from pint_torch.serving.batcher import bucket_of

    return bucket_of(k, ladder)


def _warn(msg: str) -> None:
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


class StreamCache:
    """The living factor state of one streamed GLS fit (module
    docstring), on ``model``'s device."""

    def __init__(self, model, toas,
                 block_buckets: Sequence[int] = DEFAULT_BLOCK_BUCKETS,
                 cond_limit: float = CONDITION_LIMIT):
        self.model = model
        self.block_buckets = tuple(sorted(int(b) for b in block_buckets))
        if not self.block_buckets or self.block_buckets[0] < 1:
            raise UsageError(
                f"block ladder needs positive rungs, got {block_buckets}")
        self.cond_limit = float(cond_limit)
        #: full refactors paid (frame mismatch, condition guard)
        self.rebuilds = 0
        #: guarded factor updates refused (each one also a rebuild)
        self.fallbacks = 0
        #: the condition proxy of the last refused update (None when the
        #: last operation's rank-k path stood or the refusal was a frame
        #: drift that never reached the kernel)
        self.last_refused_condition: Optional[float] = None
        self.updates = 0
        self._next_block_id = 0
        self._rebuild(toas)

    # -- frame construction ---------------------------------------------------
    def _rebuild(self, toas) -> None:
        """Full refactor: freeze a fresh frame at the model's current state
        over ``toas`` (the certified union)."""
        from pint_torch.gls_fitter import build_augmented_system
        from pint_torch.grid import _model_param_sig
        from pint_torch.residuals import Residuals
        from pint_torch.runtime.solve import hardened_cholesky

        resids = Residuals(toas, self.model, subtract_mean=False)
        M, params, norm, phiinv, Nvec, dims = build_augmented_system(
            self.model, toas)
        #: the pristine frame-reference model: every later block evaluates
        #: its rows here and ingests with the full cumulative offset
        self.ref_model = self.model.copy()
        r = resids.time_resids
        w = 1.0 / Nvec
        self.params = tuple(params)
        self.noise_dims = dims
        self.K = int(M.shape[1])
        # Jacobi equilibration on top of the column normalization: a unit
        # Gram diagonal
        s = torch.sqrt(torch.sum((M * w[:, None]) * M, dim=0) + phiinv)
        s = torch.where(s > 0, s, torch.ones_like(s))
        M = M / s
        self.norm = norm * s
        self.phiinv = phiinv / s**2
        self.ref_values = {p: self.model.value(p) for p in self.params
                           if p != "Offset"}
        self.vkey = (_model_param_sig(self.model), self.K)
        A = (M.T * w) @ M + torch.diag(self.phiinv)
        self.L, _, _ = hardened_cholesky(A, name="stream frame Gram")
        self.b = M.T @ (w * r)
        self._chi2 = torch.sum(w * r * r)
        self.x = torch.zeros(self.K, dtype=F64, device=M.device)
        self.blocks: List[StreamBlock] = [StreamBlock(
            block_id=self._take_block_id(), M=M, r=r, w=w,
            x_ingest=torch.zeros_like(self.x),
            alive=np.ones(len(r), dtype=bool))]
        self._toas = toas
        # the sentinel row the drift guard re-derives per append, compared
        # per column against the column's own rms magnitude
        first = np.zeros(toas.ntoas, dtype=bool)
        first[0] = True
        self._sentinel_toas = toas.select(first, self.model)
        self._sentinel_row = M[0].clone()
        self._col_scale = torch.clamp(torch.sqrt(torch.mean(M * M, dim=0)),
                                      min=1e-300)
        self.last_condition = factor_condition(self.L)

    def _take_block_id(self) -> int:
        i = self._next_block_id
        self._next_block_id += 1
        return i

    @property
    def chi2(self) -> float:
        """The augmented-system chi2 at the current state."""
        return float(self._chi2)

    @property
    def toas(self):
        """The certified union this cache's factor describes."""
        return self._toas

    @property
    def n_rows(self) -> int:
        return sum(b.n_alive for b in self.blocks)

    # -- per-block entry --------------------------------------------------------
    def frame_rows(self, toas):
        """``(M, r, w, drift_reason)`` for a block in the frozen frame:
        rows through ``linearized_system`` with the sentinel riding along,
        re-normalized onto the frame's columns; ``drift_reason`` non-None
        when they are not frame-consistent."""
        from pint_torch.toa import merge_TOAs

        union = merge_TOAs([self._sentinel_toas, toas])
        M_raw, r, w, params, _ = _block_rows(self.ref_model, union)
        if M_raw.shape[1] != self.K or tuple(params) != self.params:
            return (M_raw, r, w,
                    f"column layout changed ({M_raw.shape[1]} cols / "
                    f"{len(params)} params vs frame {self.K} / "
                    f"{len(self.params)})")
        M = M_raw / self.norm
        sent = M[0]
        scale = torch.maximum(torch.abs(self._sentinel_row), self._col_scale)
        drift = float(torch.max(torch.abs(sent - self._sentinel_row) / scale))
        reason = None
        if drift > FRAME_DRIFT_RTOL:
            reason = (f"sentinel design row drifted {drift:.3e} "
                      f"(> {FRAME_DRIFT_RTOL:g}) from the frozen frame")
        return M[1:], r[1:], w[1:], reason

    # -- the kernel -------------------------------------------------------------
    def _ingest(self, M, r, w, downdate: bool, dx_since) -> Tuple[bool, str]:
        """One padded rank-k pass (K9 ``stream_ingest``); ``(ok, reason)``.
        The state is not changed when the guard refuses."""
        k = len(r)
        pad = bucket_rows(k, self.block_buckets) - k
        if pad:
            M = torch.cat([M, M.new_zeros((pad, self.K))])
            r = torch.cat([r, r.new_zeros(pad)])
            w = torch.cat([w, w.new_zeros(pad)])
        sign = -1.0 if downdate else 1.0
        L2, b2, chi22, ok, cond = ingest_kernel(sign)(
            self.L, self.b, self._chi2, M, r, w, dx_since)
        finite_ok = bool(ok)
        cond = float(cond) if finite_ok else float("inf")
        reason = refusal_reason(finite_ok, cond, self.cond_limit, downdate)
        if reason is not None:
            self.last_refused_condition = cond
            return False, reason
        self.L, self.b, self._chi2 = L2, b2, chi22
        self.last_condition = cond
        self.updates += 1
        return True, ""

    # -- public stream operations ------------------------------------------------
    def append(self, toas) -> Tuple[StreamBlock, Optional[str]]:
        """Ingest one certified block: frame rows and a rank-k update, or
        on frame drift or a guard refusal a full refactor of the union.
        Returns ``(block, fallback_reason)``, the reason None on the
        incremental path."""
        from pint_torch.toa import merge_TOAs

        if toas.ntoas < 1:
            raise UsageError("append needs at least one TOA")
        self.last_refused_condition = None
        M, r, w, drift = self.frame_rows(toas)
        union = merge_TOAs([self._toas, toas])
        dx_since = self.x.clone()
        if drift is None:
            ok, reason = self._ingest(M, r, w, downdate=False,
                                      dx_since=dx_since)
        else:
            ok, reason = False, drift
        if not ok:
            self.fallbacks += 1
            self.rebuilds += 1
            _warn(f"stream cache: rank-k append refused ({reason}); "
                  "refactoring the full certified set")
            # the certified survivors and the new block, never the rows a
            # downdate removed
            alive = np.concatenate([b.alive for b in self.blocks])
            survivors = self._toas if bool(np.all(alive)) \
                else self._toas.select(alive, self.model)
            self._rebuild(merge_TOAs([survivors, toas]))
            # the appended rows stay their own block
            self._split_tail_block(toas.ntoas)
            return self.blocks[-1], reason
        block = StreamBlock(
            block_id=self._take_block_id(), M=M, r=r - M @ dx_since, w=w,
            x_ingest=self.x.clone(), alive=np.ones(len(r), dtype=bool))
        self.blocks.append(block)
        self._toas = union
        return block, None

    def _split_tail_block(self, k: int) -> None:
        """Split the last ``k`` rows of the post-rebuild block into a
        block of their own with a fresh id."""
        whole = self.blocks[-1]
        if k >= len(whole.r):
            return
        head = StreamBlock(
            block_id=whole.block_id, M=whole.M[:-k], r=whole.r[:-k],
            w=whole.w[:-k], x_ingest=whole.x_ingest,
            alive=whole.alive[:-k],
            validator_downdated=whole.validator_downdated[:-k])
        tail = StreamBlock(
            block_id=self._take_block_id(), M=whole.M[-k:],
            r=whole.r[-k:], w=whole.w[-k:],
            x_ingest=whole.x_ingest.clone(), alive=whole.alive[-k:],
            validator_downdated=whole.validator_downdated[-k:])
        self.blocks[-1:] = [head, tail]

    def _row_op(self, block_id: int, rows, downdate: bool) -> Optional[str]:
        block = self._block(block_id)
        self.last_refused_condition = None
        rows = np.asarray(sorted(set(int(i) for i in rows)))
        if rows.size == 0:
            return None
        if rows.min() < 0 or rows.max() >= len(block.r):
            raise UsageError(
                f"rows {rows.tolist()} out of range for block "
                f"{block_id} ({len(block.r)} rows)")
        if downdate and not np.all(block.alive[rows]):
            raise UsageError(
                f"block {block_id}: some of rows {rows.tolist()} are "
                "already downdated")
        if not downdate and np.any(block.alive[rows]):
            raise UsageError(
                f"block {block_id}: some of rows {rows.tolist()} are "
                "not quarantined")
        idx = torch.as_tensor(rows, device=block.M.device)
        ok, reason = self._ingest(
            block.M[idx], block.r[idx], block.w[idx], downdate=downdate,
            dx_since=self.x - block.x_ingest)
        block.alive[rows] = not downdate
        if ok:
            return None
        self.fallbacks += 1
        self.rebuilds += 1
        _warn(f"stream cache: rank-k {'downdate' if downdate else 'update'}"
              f" refused ({reason}); refactoring the surviving rows")
        self._refactor_from_blocks()
        return reason

    def downdate_rows(self, block_id: int,
                      rows: Sequence[int]) -> Optional[str]:
        """Quarantine = downdate: remove ``rows`` of one block from the
        factor; the fallback reason when the guard forced a refactor."""
        return self._row_op(block_id, rows, downdate=True)

    def release_rows(self, block_id: int,
                     rows: Sequence[int]) -> Optional[str]:
        """Release = update: re-admit downdated rows of one block; never a
        rebuild unless the condition guard refuses."""
        return self._row_op(block_id, rows, downdate=False)

    def _block(self, block_id: int) -> StreamBlock:
        for b in self.blocks:
            if b.block_id == block_id:
                return b
        raise UsageError(f"no stream block with id {block_id}")

    def sync_container_mask(self) -> None:
        """Mirror the factor's alive rows onto the tracked union's
        quarantine mask, so a fresh fit of the container certifies exactly
        the rows the factor holds."""
        alive = np.concatenate([b.alive for b in self.blocks]) \
            if self.blocks else np.zeros(0, dtype=bool)
        dead = ~alive
        if not dead.any():
            self._toas.set_quarantine(None)
        else:
            self._toas.set_quarantine(
                dead, [["downdated by the streaming engine"] if d else []
                       for d in dead])

    def _refactor_from_blocks(self) -> None:
        """Rebuild the factor from the retained rows (alive only, residuals
        advanced to the current state) without re-deriving the frame."""
        from pint_torch.runtime.solve import hardened_cholesky

        A = torch.diag(self.phiinv)
        b = torch.zeros_like(self.x)
        chi2 = torch.zeros((), dtype=F64, device=self.x.device)
        for blk in self.blocks:
            if not np.any(blk.alive):
                continue
            idx = torch.as_tensor(np.flatnonzero(blk.alive),
                                  device=blk.M.device)
            M, w = blk.M[idx], blk.w[idx]
            r = blk.r[idx] - M @ (self.x - blk.x_ingest)
            A = A + (M.T * w) @ M
            b = b + M.T @ (w * r)
            chi2 = chi2 + torch.sum(w * r * r)
        self.L, _, _ = hardened_cholesky(A, name="stream refactor Gram")
        self.b, self._chi2 = b, chi2
        self.last_condition = factor_condition(self.L)

    def warm_steps(self, steps: int = 2) -> np.ndarray:
        """``steps`` warm Gauss-Newton steps; the per-step ``|dx|``.  The
        rhs, chi2 and offset advance in place."""
        self.b, self._chi2, self.x, dxn = step_kernel(steps)(
            self.L, self.b, self._chi2, self.phiinv, self.x)
        return dxn.cpu().numpy()

    def errors(self) -> np.ndarray:
        """Physical 1-sigma parameter errors at the current factor."""
        return err_kernel()(self.L, self.norm).cpu().numpy()

    def solution(self) -> Dict[str, float]:
        """Physical parameter values at the current state (frame
        reference plus offset; Offset excluded)."""
        dx = (self.x / self.norm).cpu().numpy()
        return {p: self.ref_values[p] + float(dx[i])
                for i, p in enumerate(self.params) if p != "Offset"}

    def noise_ampls(self) -> Dict[str, torch.Tensor]:
        """Maximum-likelihood GP amplitudes of the current state, by
        component."""
        ntm = len(self.params)
        dx = self.x / self.norm
        return {comp: dx[ntm + off:ntm + off + size]
                for comp, (off, size) in (self.noise_dims or {}).items()}

    # -- checkpoint state ---------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        """The resumable state as named host arrays (what
        :meth:`load_state` restores is bitwise what was saved)."""
        def h(t):
            return t.detach().cpu().numpy()

        out = {"L": h(self.L), "b": h(self.b),
               "chi2": h(self._chi2).reshape(1),
               "x": h(self.x), "norm": h(self.norm), "phiinv": h(self.phiinv),
               "frame_sentinel": h(self._sentinel_row),
               "frame_refs": np.array(
                   [self.ref_values[p] for p in self.params
                    if p != "Offset"]),
               "counters": np.array([self.rebuilds, self.fallbacks,
                                     self.updates, self._next_block_id],
                                    dtype=np.int64),
               "block_ids": np.array([b.block_id for b in self.blocks],
                                     dtype=np.int64)}
        for blk in self.blocks:
            tag = f"block_{blk.block_id}"
            out[f"{tag}_M"] = h(blk.M)
            out[f"{tag}_r"] = h(blk.r)
            out[f"{tag}_w"] = h(blk.w)
            out[f"{tag}_x"] = h(blk.x_ingest)
            out[f"{tag}_alive"] = blk.alive
            out[f"{tag}_vdown"] = blk.validator_downdated
        return out

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        """Restore a :meth:`state_dict` payload; the saved frame (width,
        sentinel row, reference values) must be this cache's bitwise, else
        :class:`~pint_torch.runtime.checkpoint.CheckpointError`."""
        from pint_torch.runtime.checkpoint import CheckpointError

        dev = self.x.device

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   device=dev)

        L = np.asarray(state["L"], dtype=np.float64)
        if L.shape != (self.K, self.K):
            raise UsageError(
                f"stream state factor is {L.shape}, frame is "
                f"({self.K}, {self.K}) -- not this stream's checkpoint")
        sent, refs = state.get("frame_sentinel"), state.get("frame_refs")
        own_refs = np.array([self.ref_values[p] for p in self.params
                             if p != "Offset"])
        if sent is None or refs is None \
                or not np.array_equal(np.asarray(sent),
                                      self._sentinel_row.cpu().numpy()) \
                or not np.array_equal(np.asarray(refs), own_refs):
            raise CheckpointError(
                "stream checkpoint was saved in a different linearization "
                "frame (a mid-stream fallback rebuild re-froze it, or this "
                "is another stream's state); refusing to mix frames -- "
                "replay the stream from source data instead")
        self.L, self.b = t(L), t(state["b"])
        self._chi2 = t(np.asarray(state["chi2"]).ravel()[0])
        self.x, self.norm = t(state["x"]), t(state["norm"])
        self.phiinv = t(state["phiinv"])
        counters = np.asarray(state["counters"], dtype=np.int64)
        self.rebuilds, self.fallbacks = int(counters[0]), int(counters[1])
        self.updates, self._next_block_id = (int(counters[2]),
                                             int(counters[3]))
        self.blocks = []
        for bid in np.asarray(state["block_ids"], dtype=np.int64):
            tag = f"block_{int(bid)}"
            vdown = state.get(f"{tag}_vdown")
            self.blocks.append(StreamBlock(
                block_id=int(bid), M=t(state[f"{tag}_M"]),
                r=t(state[f"{tag}_r"]), w=t(state[f"{tag}_w"]),
                x_ingest=t(state[f"{tag}_x"]),
                alive=np.asarray(state[f"{tag}_alive"], dtype=bool),
                validator_downdated=np.asarray(vdown, dtype=bool)
                if vdown is not None else None))
