"""Flow training: a host-side Adam loop around one reverse-mode step
(port of ``pint_tpu/amortized/train.py``).

One step is the reference's: ``-ELBO`` at the step's base samples, its
gradient by ``torch.autograd.grad`` (through the flow, the prior transform
and the posterior's hand kernels' ``backward``), then Adam's moments and
update in the reference's order of operations.  The host loop owns:

* **the random stream** -- each step's base samples come from the
  reference's key chain (``split`` per step from ``PRNGKey(seed)``, then a
  float64 ``normal``), repeated on the host by
  :mod:`pint_torch.amortized._prng`: a fixed seed gives the reference's
  samples, and the same trace on every run;
* **checkpoint/resume** -- steps are grouped into chunks persisted through
  :class:`~pint_torch.runtime.checkpoint.SweepCheckpoint` under the
  reference's fingerprint fields; a crashed run resumes from the last
  completed chunk (the key rides in the chunk) and continues bitwise;
* **telemetry** -- none: the reference's ``flow_train`` event (every
  ``log_every`` steps) is emitted only with telemetry on, which the port
  does not have yet (``pint_torch.config``, ROADMAP queue A item 8).

``plan=`` (the sample axis sharded over a device mesh) is ROADMAP queue A
item 9 and raises.  A reduced ``flow.coupling`` precision spec runs the
coupling matmuls on K11 and their gradient on K11's backward kernel
(:class:`~pint_torch.kernels.compensated_matmul.CompensatedMatmul`), as
the reference's ``value_and_grad`` differentiates its reduced matmul.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from pint_torch import F64
from pint_torch.amortized import _prng
from pint_torch.amortized.elbo import AmortizedVI
from pint_torch.amortized.flows import leaves, unflatten
from pint_torch.exceptions import UsageError
from pint_torch.logging import log

__all__ = ["TrainConfig", "TrainResult", "train_flow"]


@dataclass(frozen=True)
class TrainConfig:
    """Adam schedule + sample budget for one training run."""

    steps: int = 300
    n_samples: int = 64        #: MC samples per ELBO estimate
    lr: float = 1e-2
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    seed: int = 0
    #: steps per persisted checkpoint chunk
    checkpoint_chunk: int = 50
    #: the reference's flow_train telemetry cadence (steps; telemetry is
    #: ROADMAP queue A item 8)
    log_every: int = 25

    def __post_init__(self):
        if self.steps < 1:
            raise UsageError(f"steps must be >= 1, got {self.steps}")
        if self.n_samples < 1:
            raise UsageError(
                f"n_samples must be >= 1, got {self.n_samples}")
        if self.lr <= 0:
            raise UsageError(f"lr must be > 0, got {self.lr}")
        if self.checkpoint_chunk < 1:
            raise UsageError(f"checkpoint_chunk must be >= 1, got "
                             f"{self.checkpoint_chunk}")

    def to_dict(self) -> dict:
        return {"steps": self.steps, "n_samples": self.n_samples,
                "lr": self.lr, "beta1": self.beta1, "beta2": self.beta2,
                "eps": self.eps, "seed": self.seed,
                "checkpoint_chunk": self.checkpoint_chunk}


@dataclass
class TrainResult:
    """Outcome of one (possibly resumed) training run."""

    params: Any                      #: trained flow parameters (tensors)
    elbo_trace: np.ndarray           #: (steps,) per-step ELBO estimates
    steps: int
    resumed_steps: int = 0           #: steps replayed from a checkpoint
    config: Optional[TrainConfig] = None

    @property
    def elbo_final(self) -> float:
        return float(self.elbo_trace[-1])


def _div(a, c: float):
    """``a / c`` as a division (on the card torch multiplies by a Python
    float's reciprocal)."""
    return a / torch.full_like(a, c)


def adam_update(params, m, v, t, g, cfg: TrainConfig):
    """The reference's Adam update of flat leaf lists from the gradient
    ``g`` (of ``-ELBO``), in its order of operations: ``(params, m, v,
    t)``."""
    b1, b2, lr, eps = cfg.beta1, cfg.beta2, cfg.lr, cfg.eps
    t = t + 1
    m = [b1 * mi + (1.0 - b1) * gi for mi, gi in zip(m, g)]
    v = [b2 * vi_ + (1.0 - b2) * gi * gi for vi_, gi in zip(v, g)]
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    params = [p.detach() - lr * _div(mi, c1)
              / (torch.sqrt(_div(vi_, c2)) + eps)
              for p, mi, vi_ in zip(params, m, v)]
    return params, m, v, t


def loss_and_grad(vi: AmortizedVI, params, z):
    """``(-ELBO, its gradient)`` at flat leaves ``params`` and base samples
    ``z``, by ``torch.autograd.grad``."""
    ps = [p.detach().requires_grad_(True) for p in params]
    loss = -vi.elbo_fn()(unflatten(ps, vi.flow.n_coupling_layers), z)
    return loss.detach(), list(torch.autograd.grad(loss, ps))


def adam_step(vi: AmortizedVI, cfg: TrainConfig):
    """The training step: ``(params, m, v, t, z) -> (params, m, v, t,
    elbo)`` with params, m and v flat leaf lists -- the loss, its gradient
    and the reference's Adam update."""
    def step(params, m, v, t, z):
        loss, g = loss_and_grad(vi, params, z)
        return (*adam_update(params, m, v, t, g, cfg), float(-loss))

    return step


def _state_arrays(params, m, v, t, key, elbos: List[float]) -> dict:
    """The training state as the named numpy arrays one checkpoint chunk
    persists (leaves in the reference's pytree order)."""
    out = {"t": np.asarray(int(t)), "key": np.asarray(key),
           "elbos": np.asarray(elbos, dtype=np.float64)}
    for tag, flat in (("p", params), ("m", m), ("v", v)):
        for i, leaf in enumerate(flat):
            out[f"{tag}_{i:03d}"] = leaf.detach().cpu().numpy()
    return out


def _state_from_arrays(d: dict, device) -> tuple:
    def flat(tag):
        keys = sorted(k for k in d if k.startswith(f"{tag}_"))
        return [torch.as_tensor(d[k], dtype=F64, device=device)
                for k in keys]

    return (flat("p"), flat("m"), flat("v"), int(d["t"]),
            np.asarray(d["key"], dtype=np.uint32), list(d["elbos"]))


def train_flow(vi: AmortizedVI, cfg: Optional[TrainConfig] = None,
               checkpoint: Optional[str] = None,
               plan=None) -> TrainResult:
    """Train ``vi``'s flow by maximizing the reparameterized ELBO on the
    posterior's device.

    ``checkpoint`` names a directory: completed chunks
    (``cfg.checkpoint_chunk`` steps each) persist there and a crashed run
    resumes bitwise (the chunk carries the key).  The fingerprint binds
    the flow architecture, the prior specs, the labels, the schedule and
    the posterior's vkey: resuming another problem raises
    :class:`~pint_torch.exceptions.CheckpointError`."""
    cfg = cfg or TrainConfig()
    if plan is not None:
        raise NotImplementedError(
            "train_flow(plan=...): the sample axis over a device mesh is "
            "ROADMAP queue A item 9")
    n = cfg.n_samples
    dev = vi.device
    step_fn = adam_step(vi, cfg)
    params = leaves(vi.flow.init(dev))
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    t = 0
    key = _prng.prng_key(cfg.seed)
    elbos: List[float] = []

    ckpt = None
    nchunks = -(-cfg.steps // cfg.checkpoint_chunk)
    if checkpoint is not None:
        from pint_torch.runtime.checkpoint import (SweepCheckpoint,
                                                   fingerprint_of)

        fp = fingerprint_of(flow=vi.flow.cfg.to_dict(),
                            specs=repr(vi.transform.specs),
                            labels=vi.param_labels,
                            train=cfg.to_dict(), n_padded=n,
                            vkey=repr(vi.vkey))
        ckpt = SweepCheckpoint(checkpoint, fp, nchunks,
                               sidecar={"what": "flow_train"})

    resumed = 0
    for i in range(nchunks):
        lo = i * cfg.checkpoint_chunk
        hi = min(cfg.steps, lo + cfg.checkpoint_chunk)
        if ckpt is not None and ckpt.has(i):
            params, m, v, t, key, chunk_elbos = _state_from_arrays(
                ckpt.load(i), dev)
            elbos.extend(chunk_elbos)
            resumed += hi - lo
            continue
        for _ in range(lo, hi):
            key, sub = _prng.split(key)
            z = torch.as_tensor(_prng.normal(sub, (n, vi.ndim)), dtype=F64,
                                device=dev)
            params, m, v, t, elbo = step_fn(params, m, v, t, z)
            elbos.append(elbo)
        if ckpt is not None:
            ckpt.save(i, **_state_arrays(params, m, v, t, key,
                                         elbos[lo:hi]))
    if resumed:
        log.info(f"train_flow: resumed {resumed}/{cfg.steps} steps from "
                 f"{checkpoint}")
    trace = np.asarray(elbos, dtype=np.float64)
    if not np.isfinite(trace[-1]):
        log.warning(f"train_flow: final ELBO is {trace[-1]} -- the flow "
                    "did not converge to a usable posterior")
    return TrainResult(params=unflatten(params, vi.flow.n_coupling_layers),
                       elbo_trace=trace, steps=cfg.steps,
                       resumed_steps=resumed, config=cfg)
