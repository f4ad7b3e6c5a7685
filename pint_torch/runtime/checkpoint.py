"""Run identity and the chunk store for checkpoints (port of
``pint_tpu/runtime/checkpoint.py``: ``fingerprint_of`` :175,
``SweepCheckpoint`` :191, and ``CheckpointError`` of
``pint_tpu/exceptions.py:197``).

A checkpointed run stores the fingerprint of its definition; resuming
against a different definition raises :class:`CheckpointError` rather than
continuing the wrong run.  :class:`SweepCheckpoint` keeps one ``.npz`` of
named arrays per completed chunk beside a ``meta.json``::

    meta.json          {"version": 2, "nchunks": N, "fingerprint": sha1,
                        "sidecar": {...}}
    chunk_00000.npz    ...

Chunk writes are atomic (a temporary file and a rename).  The reference's
retry policy, which classifies device loss for its service shell, is not
part of the port.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional

import numpy as np

from pint_torch.exceptions import CheckpointError

__all__ = ["CheckpointError", "fingerprint_of", "SweepCheckpoint"]


def fingerprint_of(**kw) -> str:
    """Stable sha1 of a run definition.  Values may be numpy arrays
    (hashed by dtype/shape/bytes) or json-serializable scalars/tuples."""
    h = hashlib.sha1()
    for k in sorted(kw):
        v = kw[k]
        h.update(k.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(json.dumps(v, sort_keys=True, default=str).encode())
    return h.hexdigest()


class SweepCheckpoint:
    """One run's on-disk chunk store (module docstring).  The informational
    ``sidecar`` is never compared on resume; the fingerprint and the chunk
    count are."""

    def __init__(self, path: str, fingerprint: str, nchunks: int,
                 sidecar: Optional[dict] = None):
        self.path = path
        self.fingerprint = fingerprint
        self.nchunks = int(nchunks)
        os.makedirs(path, exist_ok=True)
        self._meta_path = os.path.join(path, "meta.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fingerprint \
                    or meta.get("nchunks") != self.nchunks:
                raise CheckpointError(
                    f"{path}: existing checkpoint belongs to a different "
                    "run (fingerprint/chunk-count mismatch); refusing to mix "
                    "them -- delete the directory to start over")
            self.meta = meta
            if sidecar is not None and meta.get("sidecar") != sidecar:
                self.update_sidecar(sidecar)
        else:
            self.meta = {"version": 2, "nchunks": self.nchunks,
                         "fingerprint": fingerprint,
                         "sidecar": sidecar or {}}
            self._write_meta()

    def _write_meta(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta, f, default=str)
        os.replace(tmp, self._meta_path)

    def update_sidecar(self, sidecar: dict) -> None:
        """Replace the sidecar, keeping the previous one in
        ``sidecar_history``."""
        prev = self.meta.get("sidecar")
        if prev:
            self.meta.setdefault("sidecar_history", []).append(prev)
        self.meta["sidecar"] = sidecar
        self._write_meta()

    def _chunk_path(self, i: int) -> str:
        return os.path.join(self.path, f"chunk_{i:05d}.npz")

    def has(self, i: int) -> bool:
        return os.path.exists(self._chunk_path(i))

    def completed(self) -> List[int]:
        return [i for i in range(self.nchunks) if self.has(i)]

    def load(self, i: int) -> dict:
        try:
            with np.load(self._chunk_path(i), allow_pickle=False) as d:
                return {k: d[k] for k in d.files}
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"{self.path}: chunk {i} is corrupt ({e}); delete "
                f"{self._chunk_path(i)} to recompute it") from e

    def save(self, i: int, **arrays) -> None:
        tmp = self._chunk_path(i) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, self._chunk_path(i))
