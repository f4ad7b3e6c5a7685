"""Normalizing-flow layers on tensors: affine couplings, fixed permutations
and the prior-aligned output map (port of ``pint_tpu/amortized/flows.py``).

The flow maps a standard-normal base through ``n_layers`` RealNVP affine
couplings into an unconstrained space ``u``; :class:`PriorTransform`
carries ``u`` into the parameter space (a sigmoid into each uniform prior's
box, an affine map for a normal prior).  Every flow sample is inside the
prior's support, and at the identity initialization (output layers zero)
the flow is the prior-transformed standard normal.

Each coupling conditions on a fixed seeded index subset (``perm[:d//2]``)
and transforms the complement.  The permutations and the initial weights
come from numpy's ``default_rng(seed)`` in the reference's order, so
:meth:`Flow.init` is the reference's bitwise.  The coupling matmuls go
through :func:`pint_torch.precision.matmul` under the ``flow.coupling``
segment (float64 by default: a plain ``@``); the log-scales are
tanh-clamped at ``s_cap``.  ``x.at[..., idx].set(y)`` becomes an
out-of-place ``index_copy`` on device index tensors, and ``jnp.clip`` a
``minimum`` of a ``maximum``, whose gradient at a tie is one half, as
``jnp.clip``'s (``torch.clamp`` would give 1): a uniform box only ulps
wide (a spin frequency's) puts many samples on its edges.

Parameters are a dict ``{"layers": [{"W1", "b1", "Ws", "bs", "Wt", "bt"},
...], "loc", "log_scale"}`` of float64 tensors; :func:`leaves` flattens it
in the order of JAX's pytree flatten (sorted keys), the order checkpoints
and saved flows store.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from pint_torch import F64
from pint_torch.exceptions import UsageError

__all__ = ["FlowConfig", "PriorTransform", "Flow", "leaves", "unflatten",
           "LAYER_KEYS"]

_LOG_2PI = 1.8378770664093453  # log(2*pi)
#: a coupling layer's keys, in sorted (pytree) order
LAYER_KEYS = ("W1", "Ws", "Wt", "b1", "bs", "bt")


def leaves(params) -> List[Any]:
    """The parameter leaves in the reference's pytree order: each layer's
    :data:`LAYER_KEYS`, then ``loc``, ``log_scale``."""
    out = [layer[k] for layer in params["layers"] for k in LAYER_KEYS]
    return out + [params["loc"], params["log_scale"]]


def unflatten(flat: Sequence, n_layers: int) -> Dict[str, Any]:
    """The inverse of :func:`leaves` for ``n_layers`` coupling layers."""
    flat = list(flat)
    k = len(LAYER_KEYS)
    if len(flat) != k * n_layers + 2:
        raise UsageError(f"{len(flat)} leaves for {n_layers} coupling "
                         f"layers (want {k * n_layers + 2})")
    layers = [dict(zip(LAYER_KEYS, flat[i * k:(i + 1) * k]))
              for i in range(n_layers)]
    return {"layers": layers, "loc": flat[-2], "log_scale": flat[-1]}


@dataclass(frozen=True)
class FlowConfig:
    """Architecture of one flow: dimensionality, depth, width, and the seed
    the permutations and initialization derive from (identity material:
    :meth:`digest` keys the serve kernels and the saved manifest)."""

    ndim: int
    n_layers: int = 4
    hidden: int = 32
    seed: int = 0
    #: log-scale clamp: ``s_cap * tanh(s / s_cap)``
    s_cap: float = 4.0

    def __post_init__(self):
        if self.ndim < 1:
            raise UsageError(f"FlowConfig.ndim must be >= 1, got "
                             f"{self.ndim}")
        if self.n_layers < 0:
            raise UsageError(f"FlowConfig.n_layers must be >= 0, got "
                             f"{self.n_layers}")
        if self.hidden < 1:
            raise UsageError(f"FlowConfig.hidden must be >= 1, got "
                             f"{self.hidden}")
        if self.s_cap <= 0:
            raise UsageError(f"FlowConfig.s_cap must be > 0, got "
                             f"{self.s_cap}")

    def to_dict(self) -> dict:
        return {"ndim": self.ndim, "n_layers": self.n_layers,
                "hidden": self.hidden, "seed": self.seed,
                "s_cap": self.s_cap}

    @classmethod
    def from_dict(cls, d: dict) -> "FlowConfig":
        try:
            return cls(ndim=int(d["ndim"]), n_layers=int(d["n_layers"]),
                       hidden=int(d["hidden"]), seed=int(d["seed"]),
                       s_cap=float(d["s_cap"]))
        except (KeyError, TypeError, ValueError) as e:
            raise UsageError(f"malformed FlowConfig dict: {e}") from e

    def digest(self) -> str:
        """Process-stable identity of the architecture."""
        return hashlib.sha256(json.dumps(
            self.to_dict(), sort_keys=True).encode()).hexdigest()[:16]


class PriorTransform:
    """The fixed output map onto the prior families of
    :meth:`pint_torch.models.priors.Prior.jax_spec`: ``("uniform", lo,
    hi)`` or ``("normal", mu, sigma)`` per parameter.  :meth:`constrain`
    maps ``u`` into parameter space with its log-Jacobian;
    :meth:`unconstrain` is the inverse, with an in-support mask (a uniform
    box's edges included)."""

    def __init__(self, specs: Sequence[tuple]):
        if not specs:
            raise UsageError("PriorTransform needs at least one prior "
                             "spec")
        is_uniform, a, b = [], [], []
        for i, spec in enumerate(specs):
            if spec is None or len(spec) != 3:
                raise UsageError(
                    f"prior spec {i} is {spec!r}; expected ('uniform', "
                    "lo, hi) or ('normal', mu, sigma) -- only the "
                    "vectorizable families are flow-compatible")
            kind, p, q = spec
            if kind == "uniform":
                if not float(q) > float(p):
                    raise UsageError(
                        f"prior spec {i}: uniform needs hi > lo, got "
                        f"({p}, {q})")
                is_uniform.append(True)
                a.append(float(p))
                b.append(float(q) - float(p))
            elif kind == "normal":
                if not float(q) > 0:
                    raise UsageError(
                        f"prior spec {i}: normal needs sigma > 0, got "
                        f"{q}")
                is_uniform.append(False)
                a.append(float(p))
                b.append(float(q))
            else:
                raise UsageError(
                    f"prior spec {i}: unknown family {kind!r} (known: "
                    "uniform, normal)")
        self.specs = tuple(tuple(s) for s in specs)
        self._is_uniform = np.asarray(is_uniform, dtype=bool)
        self._a = np.asarray(a, dtype=np.float64)
        self._b = np.asarray(b, dtype=np.float64)
        # clamp bounds in the original spec values (a narrow box's lo +
        # width * sigmoid(u) can overshoot hi by an ulp)
        self._lo = np.where(self._is_uniform, self._a, -np.inf)
        self._hi = np.where(self._is_uniform,
                            [float(s[2]) for s in self.specs], np.inf)
        self._dev: Dict[torch.device, tuple] = {}

    @property
    def ndim(self) -> int:
        return len(self._a)

    def digest(self) -> str:
        """Process-stable identity of the transform (its bounds are the
        constants of the draw and log-prob functions)."""
        return hashlib.sha256(repr(self.specs).encode()).hexdigest()[:16]

    def _consts(self, device):
        c = self._dev.get(device)
        if c is None:
            c = tuple(torch.as_tensor(v, device=device) for v in (
                self._is_uniform, self._a, self._b, self._lo, self._hi))
            self._dev[device] = c
        return c

    def constrain(self, u):
        """``u (..., ndim)`` -> ``(x, log_jac)``, ``log_jac`` the
        per-sample ``sum log |dx_i/du_i|``."""
        uni, a, b, lo, hi = self._consts(u.device)
        su = torch.sigmoid(u)
        x = torch.where(uni, a + b * su, a + b * u)
        x = torch.minimum(torch.maximum(x, lo), hi)
        lsg = torch.nn.functional.logsigmoid
        lj = torch.where(uni, torch.log(b) + lsg(u) + lsg(-u),
                         torch.log(b))
        return x, torch.sum(lj, dim=-1)

    def unconstrain(self, x):
        """``x (..., ndim)`` -> ``(u, log_jac_inv, in_support)``: the
        inverse map, its per-sample ``sum log |du_i/dx_i|`` and whether
        every uniform coordinate lies in its box (edges included: a draw
        whose sigmoid saturates lands on the edge, and is the flow's own)."""
        uni, a, b, _, _ = self._consts(x.device)
        p = (x - a) / b
        inb = torch.all(torch.where(uni, (p >= 0.0) & (p <= 1.0),
                                    torch.ones_like(uni)), dim=-1)
        tiny = torch.finfo(F64).tiny
        pc = torch.minimum(torch.maximum(p, torch.full_like(p, tiny)),
                           torch.full_like(p, 1.0 - 1e-16))
        u = torch.where(uni, torch.log(pc) - torch.log1p(-pc), p)
        lj = torch.where(uni, -torch.log(b) - torch.log(pc)
                         - torch.log1p(-pc), -torch.log(b))
        return u, torch.sum(lj, dim=-1), inb

    def to_dict(self) -> dict:
        return {"specs": [list(s) for s in self.specs]}

    @classmethod
    def from_dict(cls, d: dict) -> "PriorTransform":
        try:
            return cls([tuple(s) for s in d["specs"]])
        except (KeyError, TypeError) as e:
            raise UsageError(f"malformed PriorTransform dict: {e}") from e


class Flow:
    """A RealNVP flow: the parameters a plain dict of tensors (module
    docstring), the forward and inverse maps methods closing over the
    architecture (permutations, precision spec).

    ``spec`` is the resolved ``flow.coupling``
    :class:`~pint_torch.precision.SegmentSpec`; ``None`` resolves override
    -> manifest -> the float64 default at construction."""

    def __init__(self, cfg: FlowConfig, spec=None):
        self.cfg = cfg
        if spec is None:
            from pint_torch.precision import segment_spec

            spec = segment_spec("flow.coupling")
        self.spec = spec
        # fixed seeded permutations: layer i conditions on perm[:d//2] and
        # transforms perm[d//2:]; ndim 1 has no coupling split
        rng = np.random.default_rng(cfg.seed)
        d = cfg.ndim
        self._splits: List[Tuple[np.ndarray, np.ndarray]] = []
        if d >= 2:
            for _ in range(cfg.n_layers):
                perm = rng.permutation(d)
                self._splits.append((perm[: d // 2].copy(),
                                     perm[d // 2:].copy()))
        self._init_rng_state = rng.bit_generator.state
        self._idx: Dict[torch.device, list] = {}

    @property
    def n_coupling_layers(self) -> int:
        return len(self._splits)

    @staticmethod
    def base_logpdf(z):
        """Standard-normal log-density of the base samples, per sample."""
        return -0.5 * torch.sum(z * z, dim=-1) \
            - 0.5 * z.shape[-1] * _LOG_2PI

    def _indices(self, device):
        idx = self._idx.get(device)
        if idx is None:
            idx = [tuple(torch.as_tensor(i, dtype=torch.long, device=device)
                         for i in split) for split in self._splits]
            self._idx[device] = idx
        return idx

    # -- parameters ---------------------------------------------------------
    def init(self, device=None) -> Dict[str, Any]:
        """Identity-initialized parameters on ``device`` (None: the card):
        the conditioner's hidden layer small seeded random weights, the s/t
        output layers zero -- the reference's numpy draws, bitwise."""
        from pint_torch import resolve_device

        device = resolve_device(device)
        rng = np.random.default_rng()
        rng.bit_generator.state = self._init_rng_state
        cfg = self.cfg
        layers = []
        for idx_a, idx_b in self._splits:
            d_in, d_out = len(idx_a), len(idx_b)
            layers.append({
                "W1": rng.normal(size=(d_in, cfg.hidden))
                / np.sqrt(max(d_in, 1)),
                "b1": np.zeros(cfg.hidden),
                "Ws": np.zeros((cfg.hidden, d_out)),
                "bs": np.zeros(d_out),
                "Wt": np.zeros((cfg.hidden, d_out)),
                "bt": np.zeros(d_out),
            })
        tree = {"layers": layers, "loc": np.zeros(cfg.ndim),
                "log_scale": np.zeros(cfg.ndim)}
        return unflatten([torch.as_tensor(v, dtype=F64, device=device)
                          for v in leaves(tree)], len(layers))

    # -- the maps -----------------------------------------------------------
    def _net(self, layer, h_in):
        """The coupling conditioner: one tanh hidden layer -> (s, t), s
        tanh-clamped at ``s_cap``."""
        from pint_torch.precision import matmul as _pmatmul

        h = torch.tanh(_pmatmul(h_in, layer["W1"], self.spec) + layer["b1"])
        s_raw = _pmatmul(h, layer["Ws"], self.spec) + layer["bs"]
        t = _pmatmul(h, layer["Wt"], self.spec) + layer["bt"]
        cap = torch.full_like(s_raw, self.cfg.s_cap)
        return cap * torch.tanh(s_raw / cap), t

    def forward(self, params, z):
        """Base -> unconstrained: ``z (..., ndim)`` -> ``(u, logdet)``,
        ``logdet = log |du/dz|`` per sample."""
        x = z
        logdet = torch.zeros(x.shape[:-1], dtype=F64, device=x.device)
        for layer, (ia, ib) in zip(params["layers"],
                                   self._indices(x.device)):
            s, t = self._net(layer, x.index_select(-1, ia))
            yb = x.index_select(-1, ib) * torch.exp(s) + t
            x = x.index_copy(-1, ib, yb)
            logdet = logdet + torch.sum(s, dim=-1)
        scale = torch.exp(params["log_scale"])
        u = params["loc"] + scale * x
        return u, logdet + torch.sum(params["log_scale"])

    def inverse(self, params, u):
        """Unconstrained -> base: ``u (..., ndim)`` -> ``(z, logdet_inv)``,
        ``logdet_inv = log |dz/du|`` (the exact inverse of
        :meth:`forward`)."""
        x = (u - params["loc"]) * torch.exp(-params["log_scale"])
        logdet = torch.zeros(x.shape[:-1], dtype=F64, device=x.device) \
            - torch.sum(params["log_scale"])
        for layer, (ia, ib) in zip(reversed(params["layers"]),
                                   reversed(self._indices(x.device))):
            s, t = self._net(layer, x.index_select(-1, ia))
            xb = (x.index_select(-1, ib) - t) * torch.exp(-s)
            x = x.index_copy(-1, ib, xb)
            logdet = logdet - torch.sum(s, dim=-1)
        return x, logdet
