"""Tuning-manifest persistence: decisions that survive the process (port of
``pint_tpu/autotune/manifest.py``).

A tuned decision is worth something only if the next process picks it up,
and it is safe only if it can never replay for a workload or device it was
not tuned on:

* every decision is keyed by the sha256 digest of canonical material -- the
  decision's name, the workload version key (``vkey``, repr-stringified
  process-stable values) and the executing device's fingerprint
  (:meth:`TuningManifest.fingerprint`: platform, device name, compute
  capability, torch and CUDA versions) -- the same material and digest as
  the reference's, so a document either package writes at one fingerprint
  is read by the other;
* a lookup re-derives the material and compares it field by field with
  what the entry stored: a collision, a hand-edited file or a fingerprint
  drift degrades to "no decision" with a reason, never to a wrong value,
  and a decision recorded on the CPU never replays on the card;
* an unreadable or schema-mismatched manifest degrades the same way.

The on-disk document is ``<tune_dir>/tuning.json``, tagged
:data:`~pint_torch.autotune.records.TUNE_MANIFEST_SCHEMA`.  Everything
here is host-side file and JSON work.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform as _platform
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from pint_torch import config
from pint_torch.autotune.records import TUNE_MANIFEST_SCHEMA
from pint_torch.exceptions import UsageError
from pint_torch.logging import log

__all__ = ["TuningDecision", "TuningManifest", "manifest",
           "reset_manifest_singleton", "decision_key", "enabled"]

#: filename of the consolidated manifest under the configured tune dir
MANIFEST_BASENAME = "tuning.json"


def decision_key(name: str, vkey: Any, fingerprint: dict) -> Tuple[dict, str]:
    """(canonical key material, sha256 digest) of one decision.  ``vkey`` is
    repr-stringified: callers pass process-stable plain tuples, ints and
    strings."""
    material = {
        "schema": TUNE_MANIFEST_SCHEMA,
        "name": str(name),
        "vkey": repr(vkey),
        "fingerprint": fingerprint,
    }
    blob = json.dumps(material, sort_keys=True, separators=(",", ":"))
    return material, hashlib.sha256(blob.encode()).hexdigest()


@dataclass
class TuningDecision:
    """One tuned configuration choice plus its evidence trail."""

    name: str                    #: "grid.chunk" | "gls.solve_rung" | ...
    value: Any                   #: the tuned value (JSON-serializable)
    static_default: Any          #: what the untuned path would use
    vkey: Any                    #: workload version key (process-stable)
    basis: str = "cost"          #: cost | cost+measured | measured | probe
    #: candidate evidence: one dict per enumerated configuration
    candidates: List[dict] = field(default_factory=list)
    #: str(candidate value) -> measured metric
    measured: dict = field(default_factory=dict)
    reason: str = ""             #: why this value / why the static one
    created_unix: float = 0.0

    def __post_init__(self):
        if not self.created_unix:
            self.created_unix = time.time()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "value": self.value,
            "static_default": self.static_default,
            "vkey": repr(self.vkey),
            "basis": self.basis,
            "candidates": list(self.candidates),
            "measured": dict(self.measured),
            "reason": self.reason,
            "created_unix": self.created_unix,
        }


def device_fingerprint() -> dict:
    """The identity of the device the port computes on: the card when
    PyTorch sees one (its name, compute capability, the torch and CUDA
    versions), else the host CPU (its architecture and a hash of its ISA
    flags, as a CPU-compiled artifact is tied to the host)."""
    import torch

    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        return {"platform": "cuda",
                "device_kind": torch.cuda.get_device_name(0),
                "compute_capability": f"{major}.{minor}",
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda}
    fp = {"platform": "cpu", "device_kind": _platform.machine(),
          "torch_version": torch.__version__}
    try:
        with open("/proc/cpuinfo") as f:
            flags = next(ln for ln in f
                         if ln.startswith(("flags", "Features")))
        fp["cpu_flags"] = hashlib.sha1(flags.encode()).hexdigest()[:12]
    except (OSError, StopIteration):
        fp["cpu_flags"] = _platform.node()
    return fp


class TuningManifest:
    """Filesystem-backed store of tuned decisions for one device.

    ``path`` may be the configured tune *directory* (the manifest lives at
    ``<path>/tuning.json``) or an explicit ``.json`` file path.
    Construction validates writability with a typed :class:`UsageError`
    only when the caller intends to record (``writable=True``); read-only
    consumers accept a missing file as an empty manifest."""

    def __init__(self, path: str, writable: bool = True):
        path = os.path.abspath(str(path))
        if path.endswith(".json"):
            self.path = path
            parent = os.path.dirname(path) or "."
        else:
            self.path = os.path.join(path, MANIFEST_BASENAME)
            parent = path
        if writable:
            try:
                os.makedirs(parent, exist_ok=True)
            except OSError as e:
                raise UsageError(
                    f"tuning-manifest dir {parent!r} cannot be created: "
                    f"{e}") from e
            if not os.access(parent, os.W_OK):
                raise UsageError(
                    f"tuning-manifest dir {parent!r} is not writable "
                    "(PINT_TORCH_TUNE_DIR / set_tune_dir)")
        #: parsed-document memo keyed by (mtime_ns, size): any writer
        #: changes the stat signature and invalidates it
        self._doc_cache: Optional[Tuple[tuple, Optional[dict],
                                        Optional[str]]] = None

    @staticmethod
    def fingerprint() -> dict:
        """The executing device's identity (:func:`device_fingerprint`)."""
        return device_fingerprint()

    # -- document I/O -------------------------------------------------------

    def _read_doc(self) -> Tuple[Optional[dict], Optional[str]]:
        """(document, degrade reason): exactly one is non-None, except for
        an absent file, which is (None, None), an empty manifest."""
        try:
            st = os.stat(self.path)
        except OSError:
            return None, None
        sig = (st.st_mtime_ns, st.st_size)
        if self._doc_cache is not None and self._doc_cache[0] == sig:
            return self._doc_cache[1], self._doc_cache[2]
        doc, reason = self._parse_doc()
        self._doc_cache = (sig, doc, reason)
        return doc, reason

    def _parse_doc(self) -> Tuple[Optional[dict], Optional[str]]:
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return None, f"manifest unreadable: {type(e).__name__}: {e}"
        if not isinstance(doc, dict):
            return None, "manifest is not a JSON object"
        if doc.get("schema") != TUNE_MANIFEST_SCHEMA:
            return None, (f"manifest schema {doc.get('schema')!r} != "
                          f"{TUNE_MANIFEST_SCHEMA!r}")
        if not isinstance(doc.get("decisions"), dict):
            return None, "manifest carries no decisions object"
        return doc, None

    def _write_doc(self, doc: dict) -> None:
        tmp = self.path + f".tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)

    # -- store --------------------------------------------------------------

    def record(self, decision: TuningDecision) -> str:
        """Persist one decision under its derived key; returns the entry's
        digest.  The document is read, modified and replaced atomically."""
        fp = self.fingerprint()
        material, digest = decision_key(decision.name, decision.vkey, fp)
        doc, reason = self._read_doc()
        if doc is None:
            if reason is not None:
                log.warning(f"tuning manifest {self.path!r}: rewriting "
                            f"degraded document ({reason})")
            doc = {"schema": TUNE_MANIFEST_SCHEMA,
                   "created_unix": time.time(),
                   "fingerprint": fp,
                   "decisions": {}}
        entry = dict(material)
        entry["decision"] = decision.to_dict()
        entry["stored_unix"] = time.time()
        doc["decisions"][digest] = entry
        doc["updated_unix"] = time.time()
        try:
            self._write_doc(doc)
        finally:
            self._doc_cache = None
        return digest

    # -- load ---------------------------------------------------------------

    def lookup(self, name: str, vkey: Any
               ) -> Tuple[Optional[dict], Optional[str]]:
        """(decision body, None) on a verified hit, else (None, reason): the
        entry's stored key material must equal the freshly derived one
        field by field (name, vkey, device fingerprint)."""
        doc, reason = self._read_doc()
        if doc is None:
            return None, reason or f"no tuning manifest at {self.path}"
        material, digest = decision_key(name, vkey, self.fingerprint())
        entry = doc["decisions"].get(digest)
        if entry is None:
            return None, (f"no tuned decision for {name!r} at this "
                          "vkey/device fingerprint")
        stored = {k: entry.get(k) for k in material}
        if stored != material:
            drift = [k for k in material if stored.get(k) != material[k]]
            return None, (f"tuned decision {name!r}: stored key material "
                          f"mismatch on {drift} (stale entry)")
        body = entry.get("decision")
        if not isinstance(body, dict) or "value" not in body:
            return None, f"tuned decision {name!r}: malformed body"
        return body, None

    def digest(self) -> Optional[str]:
        """Short content digest of the decisions, or None when empty."""
        doc, _ = self._read_doc()
        if doc is None or not doc.get("decisions"):
            return None
        blob = json.dumps(doc["decisions"], sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def to_dict(self) -> Optional[dict]:
        doc, _ = self._read_doc()
        return doc


#: module singleton keyed by the configured dir
_manifest_singleton: Optional[Tuple[str, TuningManifest]] = None


def manifest() -> Optional[TuningManifest]:
    """The process's :class:`TuningManifest` for the configured tune dir,
    or ``None`` when persistence is off (:func:`pint_torch.config.
    tune_dir`)."""
    global _manifest_singleton
    d = config.tune_dir()
    if d is None:
        return None
    if _manifest_singleton is None or _manifest_singleton[0] != d:
        _manifest_singleton = (d, TuningManifest(d))
    return _manifest_singleton[1]


def reset_manifest_singleton() -> None:
    """Drop the memoized instance."""
    global _manifest_singleton
    _manifest_singleton = None


def enabled() -> bool:
    return config.tune_dir() is not None
