"""Run identity for checkpoints (port of ``pint_tpu/runtime/checkpoint.py``:
``fingerprint_of`` :175, and ``CheckpointError`` of
``pint_tpu/exceptions.py:197``).

A checkpointed run stores the fingerprint of its definition; resuming
against a different definition raises :class:`CheckpointError` rather than
continuing the wrong run.  The reference's retry policy, which classifies
device loss for its service shell, is not part of the port.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

__all__ = ["CheckpointError", "fingerprint_of"]


class CheckpointError(Exception):
    """A checkpoint is unusable: fingerprint mismatch, corrupt file, or
    incompatible layout."""


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
