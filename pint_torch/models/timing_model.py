"""TimingModel and the Component bases (port of
``pint_tpu/models/timing_model.py``).

The model is a container of components plus a flat parameter table.
Evaluation is a pure function of a value tensor ``values`` of shape
(B, n_free) -- B is 1 for a fit and the chunk of points for a grid -- and
returns the Phase and the total delay, each (B, N).  Free parameters enter
the components as (B, 1) tensors, everything else as Python floats (epochs
as :class:`~pint_torch.dd.DD` pairs of floats), so one code path serves the
fit and the batched grid.  Design matrices come from ``torch.func.jacfwd``
of the fractional phase, through the hand kernels' ``jvp`` rules.

Components see the accumulated delay of the components before them, in the
reference's fixed category order (:data:`DEFAULT_ORDER`).
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from pint_torch import F64
from pint_torch.dd import DD
from pint_torch.phase import Phase

__all__ = ["Param", "Component", "DelayComponent", "PhaseComponent",
           "NoiseComponent", "TimingModel", "DEFAULT_ORDER",
           "OFFSET_PRIOR_WEIGHT"]

#: variance [s^2] of the uninformative prior on the marginalized overall
#: phase offset (``augment_basis_for_offset``); the reference's value, kept
#: as it is because it is part of every checked chi2
OFFSET_PRIOR_WEIGHT = 1e10

#: delay/phase evaluation order (reference ``timing_model.py:63-88``)
DEFAULT_ORDER = [
    "astrometry", "jump_delay", "troposphere", "solar_system_shapiro",
    "solar_wind", "solar_windx", "dispersion_constant", "dispersion_dmx",
    "dispersion_jump", "chromatic_constant", "chromatic_cmx",
    "pulsar_system", "frequency_dependent", "fdjump", "absolute_phase",
    "spindown", "glitch", "piecewise_spindown", "phase_jump", "wave",
    "wavex", "dmwavex", "cmwavex", "ifunc",
]


@dataclass
class Param:
    """One model parameter.  ``value`` is a float, an (hi, lo) float pair
    for an epoch (``kind == "mjd"``), or None when unset."""

    name: str
    component: str
    kind: str = "float"          # float | mjd | mask | int | str | bool
    value: object = None
    frozen: bool = True
    units: str = ""
    uncertainty: Optional[float] = None
    continuous: bool = True
    key: Optional[str] = None
    key_value: List[str] = field(default_factory=list)


class Component:
    """Base: a group of parameters contributing delay, phase or noise."""

    category = ""
    kind = ""
    component_types: Dict[str, type] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.__dict__.get("register", False):
            Component.component_types[cls.__name__] = cls

    def __init__(self, config: Optional[dict] = None,
                 context: Optional[dict] = None):
        #: static structure resolved on the host (term counts, indices)
        self.config = dict(config or {})
        #: per-TOA host-built data (masks), tensors on the model's device
        self.context = dict(context or {})
        self.params: List[str] = []
        self._parent: Optional["TimingModel"] = None

    def build_context(self, batch) -> dict:
        return self.context


class DelayComponent(Component):
    kind = "delay"

    def barycentric_freq(self, pv, batch):
        """Doppler-corrected frequency when an astrometry component
        provides it; topocentric otherwise."""
        parent = self._parent
        if parent is not None:
            for comp in parent.components.values():
                if hasattr(comp, "barycentric_radio_freq"):
                    return comp.barycentric_radio_freq(pv, batch)
        return batch.freq

    def delay_func(self, pv, batch, ctx, acc_delay):
        raise NotImplementedError


class PhaseComponent(Component):
    kind = "phase"

    def phase_func(self, pv, batch, ctx, delay) -> Phase:
        raise NotImplementedError


class NoiseComponent(Component):
    kind = "noise"
    introduces_correlated_errors = False


def stack_params(pv, names: Sequence[str], device) -> torch.Tensor:
    """(B, len(names)) tensor of parameter values: free parameters are
    (B, 1) tensors, the rest floats broadcast to every row."""
    cols = [pv.get(n, 0.0) for n in names]
    B = max((c.shape[0] for c in cols if torch.is_tensor(c)), default=1)
    return torch.cat([c.expand(B, 1) if torch.is_tensor(c)
                      else torch.full((B, 1), float(c), dtype=F64,
                                      device=device)
                      for c in cols], dim=1)


class TimingModel:
    """Components in the reference's dict order plus the parameter table
    (``params`` in the reference's parameter order)."""

    def __init__(self, name: str, components: List[Component],
                 params: Dict[str, Param], device):
        self.name = name
        self.device = torch.device(device)
        self.components: Dict[str, Component] = {}
        for c in components:
            self.components[type(c).__name__] = c
            c._parent = self
        self.params_table: Dict[str, Param] = params
        for p in params.values():
            comp = self.components.get(p.component)
            if comp is not None:
                comp.params.append(p.name)
        self._cache: dict = {}

    def copy(self) -> "TimingModel":
        """An independent model: its own parameter table and component
        objects, sharing the read-only configs and contexts."""
        comps = [type(c)(c.config, c.context) for c in self.components.values()]
        params = {n: dataclasses.replace(p, key_value=list(p.key_value))
                  for n, p in self.params_table.items()}
        return TimingModel(self.name, comps, params, self.device)

    # -- structure -----------------------------------------------------------
    def sorted_components(self, kind: str) -> List[Component]:
        comps = [c for c in self.components.values() if c.kind == kind]
        order = {cat: i for i, cat in enumerate(DEFAULT_ORDER)}
        return sorted(comps, key=lambda c: order.get(c.category, len(order)))

    @property
    def delay_components(self):
        return self.sorted_components("delay")

    @property
    def phase_components(self):
        return self.sorted_components("phase")

    @property
    def noise_components(self):
        return [c for c in self.components.values() if c.kind == "noise"]

    def __getitem__(self, name) -> Param:
        return self.params_table[name]

    @property
    def free_params(self) -> List[str]:
        return [n for n, p in self.params_table.items()
                if p.component != "TimingModel" and not p.frozen]

    def design_param_names(self) -> Tuple[str, ...]:
        """Free, continuous, non-epoch, non-noise parameters: the timing
        design-matrix columns after the offset."""
        return tuple(
            n for n, p in self.params_table.items()
            if p.component != "TimingModel" and not p.frozen and p.continuous
            and p.kind != "mjd"
            and getattr(self.components.get(p.component), "kind", "") != "noise")

    @property
    def has_correlated_errors(self) -> bool:
        return any(c.introduces_correlated_errors
                   for c in self.noise_components)

    def value(self, name) -> float:
        v = self.params_table[name].value
        return float(v) if v is not None else 0.0

    # -- evaluation ----------------------------------------------------------
    def const_pv(self) -> dict:
        """Current values: floats, epochs as DD pairs of floats (the
        reference's ``_const_pv``)."""
        out = {}
        for comp in self.components.values():
            for n in comp.params:
                p = self.params_table[n]
                if p.kind in ("str", "bool"):
                    continue
                if p.kind == "mjd":
                    hi, lo = p.value if p.value is not None else (0.0, 0.0)
                    out[n] = DD(float(hi), float(lo))
                else:
                    out[n] = float(p.value) if p.value is not None else 0.0
        return out

    def free_values(self, names: Sequence[str]) -> torch.Tensor:
        """(1, len(names)) tensor of the current values."""
        return torch.tensor([[self.value(n) for n in names]], dtype=F64,
                            device=self.device)

    def evaluate(self, values: torch.Tensor, free_names: Sequence[str],
                 batch, const_pv: Optional[dict] = None):
        """(Phase, delay), each (B, N), at ``values`` (B, len(free_names))
        (reference ``_get_compiled.eval_fn``, ``timing_model.py:643-654``)."""
        pv = dict(self.const_pv() if const_pv is None else const_pv)
        for i, nm in enumerate(free_names):
            pv[nm] = values[:, i:i + 1]
        N = batch.ntoas
        acc = torch.zeros((1, N), dtype=F64, device=batch.device)
        for comp in self.delay_components:
            acc = acc + comp.delay_func(pv, batch, comp.build_context(batch),
                                        acc)
        zeros = torch.zeros((1, N), dtype=F64, device=batch.device)
        phase = Phase(zeros, zeros)
        for comp in self.phase_components:
            phase = phase + comp.phase_func(pv, batch,
                                            comp.build_context(batch), acc)
        B = values.shape[0]
        return (Phase(phase.int_.expand(B, N), phase.frac.expand(B, N)),
                acc.expand(B, N))

    def jac_frac(self, values, free_names, batch, const_pv=None):
        """d frac / d values: (N, n) for one point (``values`` (1, n))."""
        def frac(v):
            return self.evaluate(v, free_names, batch, const_pv)[0].frac

        J = jacfwd(frac)(values)  # (1, N, 1, n)
        return J[0, :, 0, :]

    def phase(self, batch) -> Phase:
        free = tuple(self.free_params)
        ph, _ = self.evaluate(self.free_values(free), free, batch)
        return Phase(ph.int_[0], ph.frac[0])

    def delay(self, batch) -> torch.Tensor:
        free = tuple(self.free_params)
        return self.evaluate(self.free_values(free), free, batch)[1][0]

    def _frozen_fingerprint(self, free) -> tuple:
        free_set = set(free)
        return tuple((n, p.value) for n, p in self.params_table.items()
                     if n not in free_set and p.kind not in ("str", "bool"))

    def _jac_frac_linear_cached(self, batch, free) -> torch.Tensor:
        """d frac / d params with constant (linear) columns cached (reference
        ``timing_model.py:760-857``): the first call costs one Jacobian, the
        second probes a ~1e-3-cycle step to split the columns, later calls
        re-derive only the nonlinear ones."""
        from pint_torch.utils import (classify_linear_columns,
                                      linearity_probe_steps)

        values = self.free_values(free)
        vals_np = values[0].cpu().numpy()
        store = self._cache.setdefault("lincols", weakref.WeakKeyDictionary())
        per_batch = store.setdefault(batch, {})
        frozen = self._frozen_fingerprint(free)
        entry = per_batch.get(free)
        if entry is not None and entry["frozen"] != frozen:
            entry = None
        if entry is not None and entry["dp"] is not None and np.any(
                np.abs(vals_np - entry["values0"]) > entry["dp"]):
            entry = None

        def seed(v):
            J0 = self.jac_frac(v, free, batch)
            per_batch[free] = {"frozen": frozen, "J0": J0,
                               "values0": v[0].cpu().numpy(), "dp": None,
                               "nl": None}
            return J0

        if entry is None:
            return seed(values)
        if entry["nl"] is None:
            J0_np = entry["J0"].cpu().numpy()
            dp = linearity_probe_steps(J0_np)
            if np.any(np.abs(vals_np - entry["values0"]) > dp):
                return seed(values)
            dp_eff = np.where(np.isfinite(dp), dp, 0.0)
            for _ in range(4):
                probe = torch.tensor((entry["values0"] + dp_eff)[None, :],
                                     dtype=F64, device=self.device)
                J1 = self.jac_frac(probe, free, batch).cpu().numpy()
                if np.all(np.isfinite(J1)):
                    break
                dp_eff = dp_eff / 8.0
            entry["nl"] = classify_linear_columns(J0_np, J1)
            entry["dp"] = np.where(dp_eff > 0, dp_eff, dp)
        J = entry["J0"].clone()
        nl = entry["nl"]
        if len(nl):
            nl_t = torch.as_tensor(nl, dtype=torch.long, device=self.device)

            def frac_of(sub):
                v = values.clone()
                v = v.index_copy(1, nl_t, sub)
                return self.evaluate(v, free, batch)[0].frac

            Jnl = jacfwd(frac_of)(values[:, nl_t])  # (1, N, 1, k)
            J[:, nl_t] = Jnl[0, :, 0, :]
        return J

    def designmatrix(self, batch, incoffset: bool = True,
                     reuse_linear: bool = False):
        """(M, names): columns -d phase / d param / F0, after an offset
        column 1/F0 (reference ``timing_model.py:859-888``)."""
        free = self.design_param_names()
        if reuse_linear:
            J = self._jac_frac_linear_cached(batch, free)
        else:
            J = self.jac_frac(self.free_values(free), free, batch)
        F0 = self.value("F0")
        cols = [-J / F0]
        names = list(free)
        if incoffset:
            cols.insert(0, torch.full((J.shape[0], 1), 1.0 / F0, dtype=F64,
                                      device=J.device))
            names.insert(0, "Offset")
        return torch.cat(cols, dim=1), names

    # -- noise ---------------------------------------------------------------
    def scaled_toa_uncertainty(self, batch) -> np.ndarray:
        """EFAC/EQUAD-scaled TOA uncertainties in seconds (host float64)."""
        err = batch.error_us.cpu().numpy() * 1e-6
        for c in self.noise_components:
            if hasattr(c, "scale_toa_sigma"):
                err = c.scale_toa_sigma(self, batch, err)
        return err

    def noise_basis_by_component(self, batch):
        """(bases, weights, {component: (offset, size)}), host numpy, in the
        reference's component order; cached per batch and noise values."""
        comps = [(n, c) for n, c in self.components.items()
                 if c.kind == "noise" and hasattr(c, "basis_weight_pair")]
        pkey = tuple((n, p, str(self.params_table[p].value))
                     for n, c in comps for p in c.params)
        cache = self._cache.setdefault("noise_basis",
                                       weakref.WeakKeyDictionary())
        hit = cache.get(batch)
        if hit is not None and hit[0] == pkey:
            return hit[1]
        Us, ws, dims = [], [], {}
        off = 0
        for name, c in comps:
            U, w = c.basis_weight_pair(self, batch)
            Us.append(U)
            ws.append(w)
            dims[name] = (off, U.shape[1])
            off += U.shape[1]
        cache[batch] = (pkey, (Us, ws, dims))
        return Us, ws, dims

    def noise_model_basis_weight(self, batch):
        Us, ws, _ = self.noise_basis_by_component(batch)
        if not Us:
            return None, None
        return np.hstack(Us), np.concatenate(ws)

    def augment_basis_for_offset(self, U, w, n: Optional[int] = None):
        """Marginalize the overall phase offset: a ones column with the
        :data:`OFFSET_PRIOR_WEIGHT` prior (reference
        ``timing_model.py:1223``)."""
        n = len(U) if n is None else n
        return (np.hstack([np.asarray(U), np.ones((n, 1))]),
                np.concatenate([np.asarray(w), [OFFSET_PRIOR_WEIGHT]]))
