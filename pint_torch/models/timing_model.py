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
reference's fixed category order (:data:`DEFAULT_ORDER`).  The wideband DM
the model predicts is the sum of the DM-bearing delay components'
``dm_func`` (:meth:`TimingModel.total_dm`), its design matrix
``torch.func.jacfwd`` of that sum, column-aligned with the timing one.
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
           "OFFSET_PRIOR_WEIGHT", "TOP_LEVEL_PARAMS"]

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


#: the model's own parameters, ahead of the components' (reference
#: ``timing_model.py:298-319``): (name, kind, units, default value); the
#: fitters' ``update_model`` writes START, FINISH, NTOA, EPHEM, DMDATA,
#: CHI2, CHI2R, TRES and DMRES
TOP_LEVEL_PARAMS = (
    ("PSR", "str", "", None), ("EPHEM", "str", "", None),
    ("CLOCK", "str", "", None), ("UNITS", "str", "", None),
    ("TIMEEPH", "str", "", None), ("T2CMETHOD", "str", "", None),
    ("BINARY", "str", "", None), ("DILATEFREQ", "bool", "", False),
    ("PLANET_SHAPIRO", "bool", "", False), ("START", "mjd", "", None),
    ("FINISH", "mjd", "", None), ("RM", "float", "rad m^-2", None),
    ("INFO", "str", "", None), ("CHI2", "float", "", None),
    ("CHI2R", "float", "", None), ("TRES", "float", "us", None),
    ("DMRES", "float", "pc/cm3", None), ("NTOA", "int", "", None),
    ("EPHVER", "int", "", None), ("DMDATA", "str", "", None))


@dataclass
class Param:
    """One model parameter.  ``value`` is a float, an (hi, lo) float pair
    for an epoch (``kind == "mjd"``), a pair of floats (``kind ==
    "pair"``: WAVEk's sine and cosine amplitudes, IFUNCk's MJD and
    offset), or None when unset."""

    name: str
    component: str
    kind: str = "float"    # float | mjd | pair | mask | int | str | bool
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
        """The component's per-TOA context for ``batch``: its own, built
        for the model's TOAs, unless the batch carries its own (the TZR
        row)."""
        if batch.contexts is not None:
            return batch.contexts.get(type(self).__name__, {})
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
    (``params`` in the reference's parameter order: the model's own
    :data:`TOP_LEVEL_PARAMS` first, with ``top_level``'s values where
    ``params`` lacks them, then the components')."""

    def __init__(self, name: str, components: List[Component],
                 params: Dict[str, Param], device,
                 top_level: Optional[dict] = None):
        self.name = name
        self.device = torch.device(device)
        self.components: Dict[str, Component] = {}
        for c in components:
            self.components[type(c).__name__] = c
            c._parent = self
        top = dict(top_level or {})
        table: Dict[str, Param] = {}
        for pname, kind, units, default in TOP_LEVEL_PARAMS:
            value = top.get(pname, default)
            if kind == "mjd" and value is not None:
                value = (float(value[0]), float(value[1]))
            table[pname] = params.get(pname) or Param(
                pname, "TimingModel", kind, value, units=units)
        table.update((n, p) for n, p in params.items() if n not in table)
        self.params_table: Dict[str, Param] = table
        for p in table.values():
            comp = self.components.get(p.component)
            if comp is not None:
                comp.params.append(p.name)
        self._cache: dict = {}

    def epoch_value(self, name) -> float:
        """A parameter's value as one float64 (an epoch's hi + lo)."""
        v = self.params_table[name].value
        if v is None:
            return 0.0
        return float(v[0]) + float(v[1]) if isinstance(v, tuple) \
            else float(v)

    def copy(self) -> "TimingModel":
        """An independent model: its own parameter table and component
        objects, sharing the read-only configs and contexts."""
        comps = [type(c)(c.config, c.context) for c in self.components.values()]
        params = {n: dataclasses.replace(p, key_value=list(p.key_value))
                  for n, p in self.params_table.items()}
        return TimingModel(self.name, comps, params, self.device)

    def validate(self) -> None:
        """Each component's own checks of its parameters, where it has
        some (reference ``TimingModel.validate``)."""
        for c in self.components.values():
            if hasattr(c, "validate"):
                c.validate()

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

    def __contains__(self, name) -> bool:
        return name in self.params_table

    @property
    def params(self) -> List[str]:
        """Every parameter name, the model's own first (reference
        ``timing_model.py:416``)."""
        return list(self.params_table)

    @property
    def is_binary(self) -> bool:
        return any(n.startswith("Binary") for n in self.components)

    def get_params_dict(self, which: str = "free",
                        kind: str = "value") -> Dict[str, object]:
        """{name: value | uncertainty | Param} of the free parameters or of
        all the components' (reference ``timing_model.py:483``)."""
        if which == "free":
            names = self.free_params
        elif which == "all":
            names = [n for n, p in self.params_table.items()
                     if p.component != "TimingModel"]
        else:
            raise ValueError(f"Unknown which {which!r}")
        out = {}
        for n in names:
            par = self.params_table[n]
            if kind == "value":
                out[n] = par.value
            elif kind == "uncertainty":
                out[n] = par.uncertainty
            elif kind in ("quantity", "parameter"):
                out[n] = par
            else:
                raise ValueError(f"Unknown kind {kind!r}")
        return out

    def get_params_mapping(self) -> Dict[str, str]:
        """{parameter: component name} (reference
        ``timing_model.py:507``)."""
        return {n: p.component for n, p in self.params_table.items()}

    def set_param_values(self, values: Dict[str, object]) -> None:
        for n, v in values.items():
            self.params_table[n].value = v

    def set_param_uncertainties(self, values: Dict[str, float]) -> None:
        for n, v in values.items():
            self.params_table[n].uncertainty = v

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
                elif p.kind == "pair":
                    out[n] = tuple(p.value) if p.value is not None else 0.0
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

    def phase(self, batch, abs_phase: bool = False) -> Phase:
        """Model phase at each TOA; with ``abs_phase`` and an AbsPhase
        component, minus the TZR TOA's phase (reference
        ``timing_model.py:730-739``)."""
        free = tuple(self.free_params)
        values = self.free_values(free)
        ph, _ = self.evaluate(values, free, batch)
        ph = Phase(ph.int_[0], ph.frac[0])
        if abs_phase and "AbsPhase" in self.components:
            tz, _ = self.evaluate(values, free,
                                  self.components["AbsPhase"].tzr_batch)
            ph = ph - Phase(tz.int_[0], tz.frac[0])
        return ph

    def delay(self, batch) -> torch.Tensor:
        free = tuple(self.free_params)
        return self.evaluate(self.free_values(free), free, batch)[1][0]

    def _frozen_fingerprint(self, free) -> tuple:
        free_set = set(free)
        return tuple((n, p.value) for n, p in self.params_table.items()
                     if n not in free_set and p.kind not in ("str", "bool")
                     and p.component != "TimingModel")

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
        column 1/F0 unless a PhaseOffset fits PHOFF (reference
        ``timing_model.py:859-888``)."""
        incoffset = incoffset and "PhaseOffset" not in self.components
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

    # -- wideband DM (reference ``timing_model.py:909-975``) -----------------
    def dm_components(self) -> List[Component]:
        """The delay components that add DM, in evaluation order."""
        return [c for c in self.delay_components if hasattr(c, "dm_func")]

    def evaluate_dm(self, values: torch.Tensor, free_names: Sequence[str],
                    batch) -> torch.Tensor:
        """Model DM [pc/cm^3], (B, N), at ``values`` (B, len(free_names))."""
        pv = self.const_pv()
        for i, nm in enumerate(free_names):
            pv[nm] = values[:, i:i + 1]
        dm = torch.zeros((1, batch.ntoas), dtype=F64, device=batch.device)
        for comp in self.dm_components():
            dm = dm + comp.dm_func(pv, batch, comp.build_context(batch))
        return dm.expand(values.shape[0], batch.ntoas)

    def total_dm(self, batch) -> torch.Tensor:
        """Model DM at each TOA [pc/cm^3] (reference
        ``timing_model.py:941``)."""
        free = tuple(self.free_params)
        return self.evaluate_dm(self.free_values(free), free, batch)[0]

    def jac_dm(self, values, free_names, batch) -> torch.Tensor:
        """d DM / d values: (N, n) for one point (``values`` (1, n))."""
        J = jacfwd(lambda v: self.evaluate_dm(v, free_names, batch))(values)
        return J[0, :, 0, :]

    def d_dm_d_param(self, batch, param: str) -> torch.Tensor:
        """d(total DM)/d(param), (N,) (reference ``timing_model.py:946``)."""
        return self.jac_dm(self.free_values((param,)), (param,), batch)[:, 0]

    def dm_designmatrix(self, batch):
        """(Md, names): the DM rows of the wideband design matrix,
        column-aligned with :meth:`designmatrix` -- a zero Offset column
        (unless a PhaseOffset fits PHOFF) and zero columns for parameters
        that do not move DM (reference ``timing_model.py:951``)."""
        free = self.design_param_names()
        J = self.jac_dm(self.free_values(free), free, batch)
        names = list(free)
        if "PhaseOffset" not in self.components:
            J = torch.cat([torch.zeros((J.shape[0], 1), dtype=F64,
                                       device=J.device), J], dim=1)
            names.insert(0, "Offset")
        return J, names

    def scaled_dm_uncertainty(self, batch) -> np.ndarray:
        """DMEFAC/DMEQUAD-scaled wideband DM uncertainties [pc/cm^3], host
        float64 (reference ``timing_model.py:966``)."""
        err = batch.dm_error
        if err is None:
            raise ValueError("TOAs have no wideband DM errors (-pp_dme "
                             "flags)")
        err = err.cpu().numpy()
        for c in self.noise_components:
            if hasattr(c, "scale_dm_sigma"):
                err = c.scale_dm_sigma(self, batch, err)
        return err

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

    def toa_covariance_matrix(self, batch) -> torch.Tensor:
        """The dense N x N TOA covariance, diag(sigma^2) plus the
        correlated terms, on the batch's device (reference
        ``timing_model.py:1204``)."""
        dev = batch.device
        sigma = torch.as_tensor(self.scaled_toa_uncertainty(batch),
                                dtype=F64, device=dev)
        cov = torch.diag(sigma**2)
        U, w = self.noise_model_basis_weight(batch)
        if U is not None:
            U = torch.as_tensor(U, dtype=F64, device=dev)
            cov = cov + (U * torch.as_tensor(w, dtype=F64, device=dev)) @ U.T
        return cov

    def noise_model_basis_weight(self, batch):
        Us, ws, _ = self.noise_basis_by_component(batch)
        if not Us:
            return None, None
        return np.hstack(Us), np.concatenate(ws)

    def augment_basis_for_offset(self, U, w, n: Optional[int] = None):
        """Marginalize the overall phase offset: a ones column with the
        :data:`OFFSET_PRIOR_WEIGHT` prior, unless a PhaseOffset fits it
        (reference ``timing_model.py:1223-1242``)."""
        if "PhaseOffset" in self.components:
            return np.asarray(U), np.asarray(w)
        n = len(U) if n is None else n
        return (np.hstack([np.asarray(U), np.ones((n, 1))]),
                np.concatenate([np.asarray(w), [OFFSET_PRIOR_WEIGHT]]))

    # -- the model's API around the noise basis (reference
    # ``timing_model.py:1213-1310``) -----------------------------------------
    def noise_model_designmatrix(self, batch) -> Optional[np.ndarray]:
        """The correlated-noise basis, host numpy, or None."""
        Us, _, _ = self.noise_basis_by_component(batch)
        return np.hstack(Us) if Us else None

    def noise_model_dimensions(self, batch) -> Dict[str, tuple]:
        """{component: (offset, size)} of the noise basis columns."""
        return self.noise_basis_by_component(batch)[2]

    @property
    def ntmpar(self) -> int:
        """Timing design-matrix columns, the implicit offset included."""
        return len(self.design_param_names()) \
            + int("PhaseOffset" not in self.components)

    def full_designmatrix(self, batch):
        """(``[M | noise basis]``, names), on the batch's device."""
        M, names = self.designmatrix(batch)
        U = self.noise_model_designmatrix(batch)
        if U is None:
            return M, names
        return torch.cat([M, torch.as_tensor(U, dtype=F64,
                                             device=M.device)], dim=1), names

    def full_basis_weight(self, batch) -> np.ndarray:
        """Prior weights of the full design matrix's columns: 1e40 (the
        uninformative enterprise value) for the timing columns, the noise
        weights for the basis.  Host numpy only, as the reference requires
        of the 1e40."""
        phi_tm = np.full(self.ntmpar, 1e40)
        _, w = self.noise_model_basis_weight(batch)
        return phi_tm if w is None else np.concatenate([phi_tm, w])

    def dm_covariance_matrix(self, batch) -> torch.Tensor:
        """The wideband DM data's covariance, diag(scaled DM error^2), on
        the batch's device (reference ``timing_model.py:1641``)."""
        sigma = torch.as_tensor(self.scaled_dm_uncertainty(batch), dtype=F64,
                                device=batch.device)
        return torch.diag(sigma**2)

    def total_dispersion_slope(self, batch) -> torch.Tensor:
        """The model's DM as a dispersion slope [s MHz^2] (reference
        ``timing_model.py:580``)."""
        from pint_torch.models.dispersion_model import DMconst

        return self.total_dm(batch) * DMconst

    # -- derivatives (reference ``timing_model.py:1588-1640``) ---------------
    def d_delay_d_param(self, batch, param: str, acc_delay=None
                        ) -> torch.Tensor:
        """d(total delay)/d(param) [s/unit], (N,), by ``torch.func.jacfwd``
        of the delay summed over the delay components in the one
        parameter, through the kernels' jvp rules as the design matrix
        goes -- a frozen parameter too, and an epoch at its float64
        value.  The parameter enters as a (1, 1) tensor, the port's
        one-point shape; the rest are the model's current values."""
        const_pv = self.const_pv()
        comps = self.delay_components
        N = batch.ntoas

        def total_delay(v):
            pv = dict(const_pv)
            pv[param] = v
            acc = torch.zeros((1, N), dtype=F64, device=batch.device)
            for comp in comps:
                acc = acc + comp.delay_func(pv, batch,
                                            comp.build_context(batch), acc)
            return acc

        v0 = torch.tensor([[self.epoch_value(param)]], dtype=F64,
                          device=batch.device)
        return jacfwd(total_delay)(v0)[0, :, 0, 0]

    def _central_difference(self, param: str, h: float, fn):
        par = self.params_table[param]
        v0 = par.value
        out = []
        for v in (self.value(param) + h, self.value(param) - h):
            par.value = v
            out.append(fn())
        par.value = v0
        return (out[0] - out[1]) / (2 * h)

    def d_delay_d_param_num(self, batch, param: str,
                            step: float = 1e-2) -> torch.Tensor:
        """Central-difference delay derivative, the step ``step`` relative
        to the value (absolute at 0) (reference ``timing_model.py:1610``)."""
        v0 = self.value(param)
        h = abs(v0) * step if v0 != 0 else step
        return self._central_difference(param, h, lambda: self.delay(batch))

    def d_toasigma_d_param(self, batch, param: str) -> np.ndarray:
        """d(scaled TOA sigma)/d(param) of a noise parameter by central
        difference of the host scaling (reference
        ``timing_model.py:1627``)."""
        h = max(abs(self.value(param)) * 1e-6, 1e-9)
        return self._central_difference(
            param, h, lambda: self.scaled_toa_uncertainty(batch))

    # -- the derived quantities (reference ``timing_model.py:1004-1137``) ----
    def get_derived_params(self, rms: Optional[float] = None,
                           ntoas: Optional[int] = None,
                           returndict: bool = False):
        """The report of derived quantities with 1-sigma uncertainties;
        ``rms`` [us] and ``ntoas`` add the ELL1 validity check.  Each
        propagated sigma is the norm of ``torch.func.grad`` of the
        closed-form expression times the uncertainties, in float64 on the
        model's device (a singular gradient counts nothing where its
        uncertainty is 0).  Returns the text, or ``(text, dict)`` with
        ``returndict``; the dict's values are (value, sigma) pairs, but
        ``"Binary"``, the binary component's name."""
        import math

        from torch.func import grad

        from pint_torch import derived_quantities as dq
        from pint_torch.utils import ELL1_check

        dev = self.device
        table = self.params_table

        def up(fn, names):
            vals = torch.tensor([self.value(n) for n in names], dtype=F64,
                                device=dev)
            errs = np.array([float(table[n].uncertainty or 0.0)
                             for n in names])
            v = float(fn(*vals))
            if not np.any(errs):
                return v, 0.0
            g = grad(lambda xs: fn(*xs))(vals).cpu().numpy()
            terms = np.where(errs == 0.0, 0.0, g * errs)
            return v, float(np.sqrt(np.sum(terms**2)))

        def fmt(v, e, unit=""):
            u = f" {unit}" if unit else ""
            return f"{v:.12g} +/- {e:.3g}{u}" if e else f"{v:.12g}{u}"

        def has(name):
            return name in table and table[name].value is not None

        out = {}
        s = "Derived Parameters:\n"
        if has("F0"):
            p, pe = up(lambda f0: 1.0 / f0, ["F0"])
            out["P (s)"] = (p, pe)
            s += f"Period = {fmt(p, pe, 's')}\n"
            if has("F1"):
                pd, pde = up(lambda f0, f1: -f1 / f0**2, ["F0", "F1"])
                out["Pdot (s/s)"] = (pd, pde)
                s += f"Pdot = {fmt(pd, pde)}\n"
                f0v, f1v = self.value("F0"), self.value("F1")
                if f1v < 0.0:
                    out["age"] = (dq.pulsar_age(f0v, f1v), 0.0)
                    out["B"] = (dq.pulsar_B(f0v, f1v), 0.0)
                    out["Blc"] = (dq.pulsar_B_lightcyl(f0v, f1v), 0.0)
                    out["Edot"] = (dq.pulsar_edot(f0v, f1v), 0.0)
                    s += (f"Characteristic age = {out['age'][0]:.4g} yr "
                          "(braking index = 3)\n")
                    s += f"Surface magnetic field = {out['B'][0]:.3g} G\n"
                    s += ("Magnetic field at light cylinder = "
                          f"{out['Blc'][0]:.4g} G\n")
                    s += (f"Spindown Edot = {out['Edot'][0]:.4g} erg/s "
                          "(I=1e45 g cm^2)\n")
                else:
                    s += "Not computing Age, B, or Edot since F1 > 0.0\n"
        if "PX" in table and table["PX"].value and not table["PX"].frozen:
            d, de = up(lambda px: 1000.0 / px, ["PX"])
            out["Dist (pc)"] = (d, de)
            s += f"\nParallax distance = {fmt(d, de, 'pc')}\n"
        if self.is_binary:
            binary = next(n for n in self.components if n.startswith("Binary"))
            out["Binary"] = binary
            s += f"\nBinary model {binary}\n"
            bcomp = self.components[binary]
            pb, pbe = bcomp.pb()
            pbe = float(pbe or 0.0)
            out["PB (d)"] = (pb, pbe)
            s += f"Orbital Period  (PB) = {fmt(pb, pbe, 'd')}\n"
            pbdot = bcomp.pbdot_pair()
            if pbdot is not None:
                out["PBDOT (s/s)"] = pbdot
                s += f"Orbital Pdot (PBDOT) = {fmt(*pbdot)}\n"
            ell1 = binary.startswith("BinaryELL1")
            if ell1:
                s += "Conversion from ELL1 parameters:\n"
                ecc = up(lambda e1, e2: torch.hypot(e1, e2), ["EPS1", "EPS2"])
                om = up(lambda e1, e2: torch.remainder(
                    torch.rad2deg(torch.atan2(e1, e2)), 360.0),
                    ["EPS1", "EPS2"])
                out["ECC"], out["OM (deg)"] = ecc, om
                s += f"ECC = {fmt(*ecc)}\nOM  = {fmt(*om, 'deg')}\n"
                t0v = self.epoch_value("TASC") + pb * om[0] / 360.0
                t0e = float(np.hypot(float(table["TASC"].uncertainty or 0.0),
                                     pb * om[1] / 360.0))
                out["T0"] = (t0v, t0e)
                s += f"T0  = {fmt(t0v, t0e)}\n"
                if rms is not None and ntoas is not None:
                    s += ELL1_check(self.value("A1"), ecc[0], rms, ntoas,
                                    outstring=True)
                s += "\n"
            eccv = out["ECC"][0] if ell1 else self.value("ECC")
            tsun = dq.TSUN_S
            if has("A1") and not table["A1"].frozen:
                fm = up(lambda a1: 4.0 * math.pi**2 * a1**3
                        / (tsun * (pb * 86400.0) ** 2), ["A1"])
                out["Mass Function (Msun)"] = fm
                s += f"Mass function = {fmt(*fm, 'Msun')}\n"
                mcmed = dq.companion_mass(pb, self.value("A1"), i_deg=60.0)
                mcmin = dq.companion_mass(pb, self.value("A1"), i_deg=90.0)
                out["Mc,med (Msun)"] = (mcmed, 0.0)
                out["Mc,min (Msun)"] = (mcmin, 0.0)
                s += ("Min / Median Companion mass (assuming Mpsr = 1.4 Msun)"
                      f" = {mcmin:.4f} / {mcmed:.4f} Msun\n")
            if "OMDOT" in table and table["OMDOT"].value:
                mt = up(lambda od: (od * math.pi / 180.0 / 86400.0 / 365.25
                                    / (3.0 * tsun ** (2.0 / 3.0)
                                       * (pb * 86400.0 / (2 * math.pi))
                                       ** (-5.0 / 3.0)
                                       / (1.0 - eccv**2))) ** 1.5, ["OMDOT"])
                out["Mtot (Msun)"] = mt
                s += ("Total mass, assuming GR, from OMDOT is "
                      f"{fmt(*mt, 'Msun')}\n")
            if has("SINI") and 0.0 <= self.value("SINI") < 1.0 and has("M2"):
                if not table["SINI"].frozen:
                    cosi = up(lambda si: torch.sqrt(1.0 - si**2), ["SINI"])
                    inc = up(lambda si: torch.rad2deg(torch.arcsin(si)),
                             ["SINI"])
                    s += "From SINI in model:\n"
                    s += f"    cos(i) = {fmt(*cosi)}\n"
                    s += f"    i = {fmt(*inc, 'deg')}\n"
                mp = dq.pulsar_mass(pb, self.value("A1"), self.value("M2"),
                                    float(np.degrees(np.arcsin(
                                        self.value("SINI")))))
                out["Mp (Msun)"] = (mp, 0.0)
                s += f"Pulsar mass (Shapiro Delay) = {mp:.4f} Msun"
        return (s, out) if returndict else s
