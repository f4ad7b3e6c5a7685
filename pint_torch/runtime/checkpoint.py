"""Checkpointed chunk executor: persist, retry with backoff, resume (port
of ``pint_tpu/runtime/checkpoint.py``: ``_is_device_failure`` :54,
``RetryPolicy`` :64, ``_call_with_timeout`` :89, ``with_retries`` :138,
``fingerprint_of`` :175, ``SweepCheckpoint`` :191 and ``checkpointed_map``
:266).

A long sweep is split into chunks; each completed chunk is persisted at
once, a failed chunk is retried with exponential backoff and an optional
per-attempt timeout, and after a crash the sweep resumes from the last
completed chunk.  A resumed sweep evaluates the same chunks on the same
inputs, so the stitched surface is the uninterrupted one bit for bit.
The store is a directory::

    meta.json          {"version": 2, "nchunks": N, "fingerprint": sha1,
                        "sidecar": {...}, "block": B}
    chunk_00000.npz    one npz of named arrays per completed chunk
    chunk_00001.npz    ...

The fingerprint hashes the sweep's definition; resuming against another
definition raises :class:`CheckpointError` rather than mixing surfaces.
The fingerprint is the reference's, which leaves out how the sweep is cut
into chunks; a caller that cuts the items into blocks of its own size
passes that ``block`` too, which the store keeps beside the fingerprint
and compares on resume (the reference's store has no such key and would
stitch chunks cut at other boundaries).
The informational ``sidecar`` (device identity) is never compared.  Chunk
writes are atomic (a temporary file and a rename).  The reference's
telemetry events and counters are ROADMAP queue A item 8 and not emitted.
"""

from __future__ import annotations

import concurrent.futures as _cf
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from pint_torch.exceptions import (CheckpointError, DeviceLostError,
                                   SweepChunkFailure)
from pint_torch.logging import log

__all__ = ["CheckpointError", "RetryPolicy", "SweepCheckpoint",
           "checkpointed_map", "with_retries", "fingerprint_of"]


def _is_device_failure(exc: BaseException) -> bool:
    """Retryable device-side failures, by the reference's predicate: a
    :class:`DeviceLostError`, an exception named ``XlaRuntimeError``, or a
    ``RuntimeError`` whose message mentions "device".

    A hand kernel's :class:`~pint_torch.kernels.KernelLaunchError` is a
    ``RuntimeError`` and is judged by its message like any other.  A
    sticky CUDA error (an illegal address, a device-side assert) leaves
    the context unusable, so every retry fails again and the chunk ends
    in :class:`SweepChunkFailure` after the last attempt: loud, as it
    should be."""
    if isinstance(exc, DeviceLostError):
        return True
    name = type(exc).__name__
    return name == "XlaRuntimeError" or (
        isinstance(exc, RuntimeError) and "device" in str(exc).lower())


@dataclass
class RetryPolicy:
    """Retry, backoff and timeout policy for one sweep chunk (or one
    batched lnposterior evaluation)."""

    max_retries: int = 3
    backoff_base: float = 0.5      #: seconds before the first retry
    backoff_factor: float = 2.0    #: exponential growth per retry
    timeout: Optional[float] = None  #: per-attempt wall-clock limit [s]
    #: which exceptions are retried; every other one propagates at once
    retryable: Callable[[BaseException], bool] = field(
        default=_is_device_failure)


#: a per-attempt timeout counts as retryable under either spelling
_TIMEOUT_ERRORS = (TimeoutError, _cf.TimeoutError)


def _caller_stream():
    """The calling thread's current CUDA stream, or None where CUDA is
    not in use."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_stream()
    return None


def _call_with_timeout(fn: Callable, timeout: Optional[float]):
    """``fn()``, abandoned after ``timeout`` seconds: the attempt runs on
    a daemon thread (a timed-out call cannot be killed, and a non-daemon
    worker would block interpreter exit) and counts as failed.

    PyTorch's current CUDA stream is per thread and the hand kernels
    launch on it, so the attempt runs on the caller's stream: its kernels
    and copies stay ordered with the caller's work."""
    if timeout is None:
        return fn()
    stream = _caller_stream()
    result: dict = {}
    done = threading.Event()

    def runner():
        try:
            if stream is None:
                result["value"] = fn()
            else:
                import torch

                with torch.cuda.stream(stream):
                    result["value"] = fn()
        except BaseException as e:  # noqa: BLE001 -- relayed to the caller
            result["error"] = e
        finally:
            done.set()

    threading.Thread(target=runner, daemon=True,
                     name="pint-torch-chunk-attempt").start()
    if not done.wait(timeout):
        raise TimeoutError(f"attempt exceeded {timeout} s")
    if "error" in result:
        raise result["error"]
    return result["value"]


def with_retries(fn: Callable, policy: Optional[RetryPolicy] = None,
                 what: str = "chunk"):
    """``fn()`` under the retry policy.  Retryable failures (the policy's
    predicate, or this policy's own per-attempt timeout) back off
    exponentially and run again; after ``max_retries`` retries the last
    failure is raised as :class:`SweepChunkFailure`, chained.  Any other
    exception propagates unchanged on the first attempt."""
    policy = policy or RetryPolicy()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_retries + 1):
        if attempt:
            delay = policy.backoff_base * policy.backoff_factor ** (attempt - 1)
            log.warning(f"{what}: attempt {attempt} failed "
                        f"({type(last).__name__}: {last}); retrying in "
                        f"{delay:.2f}s")
            if delay > 0:
                time.sleep(delay)
        try:
            return _call_with_timeout(fn, policy.timeout)
        except _TIMEOUT_ERRORS as e:
            # only this policy's timeout is retryable by itself; a
            # TimeoutError of fn's own goes through the predicate
            if policy.timeout is None and not policy.retryable(e):
                raise
            last = e
        except Exception as e:
            if not policy.retryable(e):
                raise
            last = e
    raise SweepChunkFailure(
        f"{what}: failed after {policy.max_retries + 1} attempts "
        f"(last: {type(last).__name__}: {last})") from last


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
    ``sidecar`` is never compared on resume; the fingerprint, the chunk
    count and, where given, the ``block`` size are."""

    def __init__(self, path: str, fingerprint: str, nchunks: int,
                 sidecar: Optional[dict] = None,
                 block: Optional[int] = None):
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
            if block is not None and meta.get("block") != block:
                raise CheckpointError(
                    f"{path}: existing checkpoint was cut into blocks of "
                    f"{meta.get('block')}, this run into blocks of {block}; "
                    "refusing to stitch chunks cut at other boundaries -- "
                    "delete the directory to start over")
            self.meta = meta
            if sidecar is not None and meta.get("sidecar") != sidecar:
                self.update_sidecar(sidecar)
        else:
            self.meta = {"version": 2, "nchunks": self.nchunks,
                         "fingerprint": fingerprint,
                         "sidecar": sidecar or {}}
            if block is not None:
                self.meta["block"] = block
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
        self.meta["version"] = 2
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


def _invoke(fn: Callable, chunk, index: int):
    """The per-chunk call (one place for a test to interpose a failure)."""
    return fn(chunk)


def checkpointed_map(fn: Callable, chunks: Sequence,
                     checkpoint: Optional[str] = None,
                     fingerprint: Optional[dict] = None,
                     retry: Optional[RetryPolicy] = None,
                     sidecar: Optional[dict] = None,
                     block: Optional[int] = None) -> List[dict]:
    """Map ``fn`` (chunk -> dict of numpy arrays) over ``chunks`` with
    per-chunk persistence, retry and resume.  With ``checkpoint`` (a
    directory) completed chunks are loaded instead of recomputed;
    ``fingerprint`` (keyword arguments of :func:`fingerprint_of`) and
    ``block`` (the size the caller cut the chunks at, if any) guard
    against resuming another sweep, ``sidecar`` is informational.
    Without ``checkpoint`` the retry policy still applies."""
    ckpt = None
    if checkpoint is not None:
        fp = fingerprint_of(**(fingerprint or {}))
        ckpt = SweepCheckpoint(checkpoint, fp, len(chunks), sidecar=sidecar,
                               block=block)
        done = ckpt.completed()
        if done:
            log.info(f"sweep checkpoint {checkpoint}: resuming with "
                     f"{len(done)}/{len(chunks)} chunks already complete")
    out: List[dict] = []
    for i, chunk in enumerate(chunks):
        if ckpt is not None and ckpt.has(i):
            out.append(ckpt.load(i))
            continue
        res = with_retries(lambda: _invoke(fn, chunk, i), retry,
                           what=f"sweep chunk {i}/{len(chunks)}")
        res = {k: np.asarray(v) for k, v in res.items()}
        if ckpt is not None:
            ckpt.save(i, **res)
        out.append(res)
    return out
