"""The trained flow as a posterior: draws and log-probabilities (port of
``pint_tpu/amortized/posterior.py``).

:class:`AmortizedPosterior` holds a trained flow (architecture, weights,
prior transform, provenance) and its two functions:

* **draw** -- ``(params, keys (batch, 2)) -> (batch, n, ndim)``: each row
  of keys draws its own base samples (the reference's stream, made on the
  host by :mod:`pint_torch.amortized._prng`), pushed through the flow and
  the prior transform on the device;
* **log_prob** -- ``(params, points (batch, n, ndim)) -> (batch, n)``: the
  exact flow density through the analytic coupling inverse, ``-inf``
  outside a uniform prior's box.

Both are plain functions cached by the reference's registry key ``(flow
digest, transform digest, precision key, n)``, and :meth:`serve_vkey` /
:meth:`ident` are the reference's identity.  The serve door that registers
them (``TimingService.register_posterior``, the warm pool, the AOT cache)
is ROADMAP queue A item 8.

:meth:`AmortizedPosterior.save` / :meth:`load` keep the reference's format
(:data:`FLOW_MANIFEST_SCHEMA`, the sidecar's fields, the weights as npz
leaves in the reference's pytree order): a flow saved by either package
loads in the other, which is how trained weights cross between them.  The
sidecar is verified field by field on load; any mismatch raises
:class:`~pint_torch.exceptions.CheckpointError`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from pint_torch import F64
from pint_torch.amortized import _prng
from pint_torch.amortized.elbo import AmortizedVI
from pint_torch.amortized.flows import (Flow, FlowConfig, PriorTransform,
                                        leaves, unflatten)
from pint_torch.exceptions import CheckpointError, UsageError

__all__ = ["AmortizedPosterior", "FLOW_MANIFEST_SCHEMA"]

#: the saved flow's schema, the reference's: files cross between packages
FLOW_MANIFEST_SCHEMA = "pint_tpu.amortized.flow/1"

#: the draw and log-prob functions, one per (flow digest, transform digest,
#: precision key, n)
_DRAW_FN: Dict[tuple, Any] = {}
_LOGPROB_FN: Dict[tuple, Any] = {}


class AmortizedPosterior:
    """A trained flow posterior: draws, log-probabilities, persistence."""

    def __init__(self, flow: Flow, transform: PriorTransform, params,
                 param_labels: Sequence[str], vkey: tuple = (),
                 _vkey_repr: Optional[str] = None):
        if flow.cfg.ndim != transform.ndim:
            raise UsageError(
                f"flow ndim {flow.cfg.ndim} != transform ndim "
                f"{transform.ndim}")
        if len(param_labels) != flow.cfg.ndim:
            raise UsageError(
                f"{len(param_labels)} labels for ndim {flow.cfg.ndim}")
        self.flow = flow
        self.transform = transform
        self.params = params
        self.param_labels = tuple(str(p) for p in param_labels)
        self.vkey = tuple(vkey)
        # a loaded posterior carries the sidecar's stored repr verbatim
        self._vkey_repr = _vkey_repr if _vkey_repr is not None \
            else repr(self.vkey)

    @classmethod
    def from_training(cls, vi: AmortizedVI, result) -> "AmortizedPosterior":
        """Bundle a finished :func:`~pint_torch.amortized.train.train_flow`
        run."""
        return cls(flow=vi.flow, transform=vi.transform,
                   params=result.params, param_labels=vi.param_labels,
                   vkey=vi.vkey)

    @property
    def ndim(self) -> int:
        return self.flow.cfg.ndim

    @property
    def device(self) -> torch.device:
        return self.params["loc"].device

    def serve_vkey(self) -> tuple:
        """Version key of this posterior's functions: schema, flow and
        transform digests, precision key and the training posterior's
        identity."""
        return ("amortized_posterior", 1, self.flow.cfg.digest(),
                self.transform.digest(), self.flow.spec.key(),
                self._vkey_repr)

    def ident(self) -> str:
        """Short identity of everything the functions bake in."""
        return hashlib.sha256(repr(self.serve_vkey()).encode()
                              ).hexdigest()[:12]

    # -- the draw and log-prob functions ------------------------------------
    def _registry_key(self, n: int) -> tuple:
        return (self.flow.cfg.digest(), self.transform.digest(),
                self.flow.spec.key(), int(n))

    def draw_kernel(self, n: int):
        """``(params, keys (batch, 2) uint32) -> (batch, n, ndim)``, one
        sample stream per key row."""
        if n < 1:
            raise UsageError(f"draw count must be >= 1, got {n}")
        key = self._registry_key(n)
        fn = _DRAW_FN.get(key)
        if fn is None:
            flow, transform, ndim = self.flow, self.transform, self.ndim

            def fn(params, keys):
                dev = params["loc"].device
                z = torch.as_tensor(np.stack([
                    _prng.normal(k, (n, ndim)) for k in np.asarray(
                        keys, dtype=np.uint32)]), dtype=F64, device=dev)
                with torch.no_grad():
                    u, _ = flow.forward(params, z)
                    x, _ = transform.constrain(u)
                return x

            _DRAW_FN[key] = fn
        return fn

    def logprob_kernel(self, n: int):
        """``(params, points (batch, n, ndim)) -> (batch, n)``."""
        if n < 1:
            raise UsageError(f"query count must be >= 1, got {n}")
        key = self._registry_key(n)
        fn = _LOGPROB_FN.get(key)
        if fn is None:
            flow, transform = self.flow, self.transform

            def fn(params, pts):
                with torch.no_grad():
                    u, lj_inv, inb = transform.unconstrain(pts)
                    z, ld_inv = flow.inverse(params, u)
                    logq = flow.base_logpdf(z) + ld_inv + lj_inv
                    return torch.where(inb, logq, -torch.inf)

            _LOGPROB_FN[key] = fn
        return fn

    # -- host conveniences --------------------------------------------------
    def draw(self, n: int, seed: int = 0) -> np.ndarray:
        """``(n, ndim)`` posterior draws from ``PRNGKey(seed)``."""
        keys = _prng.prng_key(int(seed))[None, :]
        return self.draw_kernel(int(n))(self.params, keys)[0].cpu().numpy()

    def log_prob(self, points) -> np.ndarray:
        """``(n,)`` flow log-densities at ``points (n, ndim)``."""
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        if pts.shape[-1] != self.ndim:
            raise UsageError(
                f"points are (n, {self.ndim}); got {pts.shape}")
        t = torch.as_tensor(pts[None, ...], dtype=F64, device=self.device)
        return self.logprob_kernel(pts.shape[0])(self.params,
                                                 t)[0].cpu().numpy()

    # -- persistence (the reference's manifest) -----------------------------
    def _manifest(self, leaf_names: List[str],
                  weights_sha256: str) -> dict:
        return {
            "schema": FLOW_MANIFEST_SCHEMA,
            "config": self.flow.cfg.to_dict(),
            "transform": self.transform.to_dict(),
            "param_labels": list(self.param_labels),
            "vkey": self._vkey_repr,
            "spec_key": list(self.flow.spec.key()),
            "leaves": leaf_names,
            "weights_sha256": weights_sha256,
        }

    def save(self, path: str) -> str:
        """Persist the trained flow: ``<path>.npz`` (weight leaves) +
        ``<path>.json`` (identity sidecar carrying the npz's sha256), each
        replaced atomically."""
        flat = leaves(self.params)
        names = [f"leaf_{i:03d}" for i in range(len(flat))]
        arrays = {nm: lf.detach().cpu().numpy()
                  for nm, lf in zip(names, flat)}
        npz, sidecar = path + ".npz", path + ".json"
        tmp = npz + ".tmp.npz"
        np.savez(tmp, **arrays)
        with open(tmp, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        os.replace(tmp, npz)
        tmp = sidecar + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._manifest(names, digest), f, sort_keys=True)
        os.replace(tmp, sidecar)
        return npz

    @classmethod
    def load(cls, path: str, expect_vkey: Optional[tuple] = None,
             device=None) -> "AmortizedPosterior":
        """Load a saved flow onto ``device`` (None: the card), verifying the
        sidecar field by field against the weights; any mismatch,
        truncation or (with ``expect_vkey``) identity drift raises
        :class:`~pint_torch.exceptions.CheckpointError`."""
        from pint_torch import resolve_device
        from pint_torch.precision import SegmentSpec

        dev = resolve_device(device)
        npz, sidecar = path + ".npz", path + ".json"
        try:
            with open(sidecar, encoding="utf-8") as f:
                man = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointError(
                f"{sidecar}: unreadable/invalid flow sidecar ({e})") from e
        if man.get("schema") != FLOW_MANIFEST_SCHEMA:
            raise CheckpointError(
                f"{sidecar}: schema {man.get('schema')!r} != "
                f"{FLOW_MANIFEST_SCHEMA!r}")
        for key in ("config", "transform", "param_labels", "vkey",
                    "spec_key", "leaves", "weights_sha256"):
            if key not in man:
                raise CheckpointError(f"{sidecar}: missing field {key!r}")
        cfg = FlowConfig.from_dict(man["config"])
        transform = PriorTransform.from_dict(man["transform"])
        labels = [str(p) for p in man["param_labels"]]
        if expect_vkey is not None and man["vkey"] != repr(
                tuple(expect_vkey)):
            raise CheckpointError(
                f"{sidecar}: flow was trained for vkey {man['vkey']}, "
                f"caller expects {tuple(expect_vkey)!r} -- a stale or "
                "foreign flow must not serve this workload")
        try:
            with open(npz, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
        except OSError as e:
            raise CheckpointError(
                f"{npz}: unreadable flow weights ({e})") from e
        if digest != man["weights_sha256"]:
            raise CheckpointError(
                f"{npz}: weight digest {digest[:12]} does not match the "
                f"sidecar's {str(man['weights_sha256'])[:12]} -- torn save "
                "or foreign weights; refusing to serve a mismatched "
                "posterior")
        try:
            with np.load(npz, allow_pickle=False) as d:
                arrays = {k: d[k] for k in d.files}
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"{npz}: unreadable flow weights ({e})") from e
        if sorted(arrays) != sorted(man["leaves"]):
            raise CheckpointError(
                f"{npz}: weight leaves {sorted(arrays)} do not match the "
                f"sidecar's {sorted(man['leaves'])}")
        # always pin the sidecar's stored spec: the ambient policy must not
        # serve another precision than the one verified here
        spec_key = tuple(man["spec_key"])
        try:
            spec = SegmentSpec(segment="flow.coupling",
                               compute_dtype=str(spec_key[0]),
                               accumulation=str(spec_key[1]))
        except (IndexError, UsageError) as e:
            raise CheckpointError(
                f"{sidecar}: malformed spec_key {spec_key!r} ({e})") from e
        flow = Flow(cfg, spec=spec)
        template = leaves(flow.init("cpu"))
        if len(template) != len(man["leaves"]):
            raise CheckpointError(
                f"{npz}: {len(man['leaves'])} stored leaves for an "
                f"architecture with {len(template)}")
        loaded = [arrays[nm] for nm in man["leaves"]]
        for tpl, got, nm in zip(template, loaded, man["leaves"]):
            if tuple(tpl.shape) != np.shape(got):
                raise CheckpointError(
                    f"{npz}: leaf {nm} has shape {np.shape(got)}, "
                    f"architecture expects {tuple(tpl.shape)}")
        params = unflatten([torch.as_tensor(a, dtype=F64, device=dev)
                            for a in loaded], flow.n_coupling_layers)
        return cls(flow=flow, transform=transform, params=params,
                   param_labels=labels, _vkey_repr=str(man["vkey"]))
