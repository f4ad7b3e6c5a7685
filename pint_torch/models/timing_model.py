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
from pint_torch.exceptions import (MissingComponent, MissingParameter,
                                   UnknownParameter)
from pint_torch.phase import Phase

__all__ = ["Param", "Component", "DelayComponent", "PhaseComponent",
           "NoiseComponent", "TimingModel", "DEFAULT_ORDER",
           "OFFSET_PRIOR_WEIGHT", "TOP_LEVEL_PARAMS", "MissingComponent"]


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
    #: the prior for Bayesian inference; None until read or set
    _prior: object = field(default=None, repr=False, compare=False)
    #: the par-file aliases (``RA`` for ``RAJ``) and the class of the
    #: reference parameter it was read as (``"prefixParameter"``), where
    #: the model was built from par text
    aliases: List[str] = field(default_factory=list)
    ptype: str = ""
    #: an indexed family's prefix (``DMX_`` of DMX_0003), or None
    prefix: Optional[str] = None

    @property
    def prior(self):
        """The parameter's prior (reference ``parameter.py:105``): an
        improper flat prior unless one was set."""
        if self._prior is None:
            from pint_torch.models.priors import Prior, UniformUnboundedRV

            self._prior = Prior(UniformUnboundedRV())
        return self._prior

    @prior.setter
    def prior(self, p):
        self._prior = p

    def prior_pdf(self, value=None, logpdf: bool = False):
        """The prior's density (or its log) at ``value``, the parameter's
        own value by default."""
        v = self.value if value is None else value
        return self.prior.logpdf(v) if logpdf else self.prior.pdf(v)


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

    # -- building from par text (reference ``timing_model.py:107-257``) ---
    @classmethod
    def template(cls) -> "Component":
        """A valueless instance holding every parameter it declares (the
        reference's ``cls()``): what the model builder reads a par file
        into and :class:`AllComponents` searches."""
        c = cls()
        c.__dict__["_params_dict"] = {}
        c.declare()
        return c

    def declare(self) -> None:
        """Add the component's parameters, unset, as
        :mod:`pint_torch.models.parameter` objects (the reference
        component's ``__init__``)."""

    def setup(self) -> None:
        """Grow and check the parameter families read from the par file
        and record the structure in ``config`` (the reference's
        ``setup``)."""

    def validate(self) -> None:
        """Raise where a required parameter is missing or invalid."""

    def finish_config(self) -> None:
        """Record in ``config`` what the evaluation reads from the
        parameters' values at build time (epochs present, term counts);
        the builder calls it after :meth:`TimingModel.validate`."""

    def add_param(self, param, setup: bool = False):
        self.__dict__.setdefault("_params_dict", {})[param.name] = param
        param._component = self
        if param.name not in self.params:
            self.params.append(param.name)
        if setup:
            self.setup()
        return param

    def remove_param(self, name: str) -> None:
        self.__dict__.get("_params_dict", {}).pop(name, None)
        if name in self.params:
            self.params.remove(name)

    def __getattr__(self, name):
        """A parameter by name: the builder's parameter object while the
        component is being built, the model's :class:`Param` after."""
        d = self.__dict__
        pd = d.get("_params_dict")
        if pd is not None and name in pd:
            return pd[name]
        parent = d.get("_parent")
        if parent is not None and name in d.get("params", ()):
            return parent[name]
        raise AttributeError(
            f"{type(self).__name__} has no attribute {name!r}")

    def _param_objs(self) -> Dict[str, object]:
        pd = self.__dict__.get("_params_dict")
        if pd is not None:
            return pd
        return {n: self._parent[n] for n in self.params}

    def match_param_alias(self, key: str) -> Optional[str]:
        """The parameter ``key`` names or aliases, or None."""
        key = key.upper()
        for name, p in self._param_objs().items():
            if hasattr(p, "name_matches"):
                if p.name_matches(key):
                    return name
            elif key == name.upper() or key in (a.upper()
                                                 for a in p.aliases):
                return name
        return None

    def match_param_aliases(self, alias: str) -> str:
        hit = self.match_param_alias(alias)
        if hit is None:
            raise UnknownParameter(
                f"{alias!r} is not a parameter or alias of "
                f"{type(self).__name__}")
        return hit

    @property
    def aliases_map(self) -> Dict[str, str]:
        """{alias or name: parameter name}."""
        out: Dict[str, str] = {}
        for name, p in self._param_objs().items():
            out[name] = name
            for a in p.aliases:
                out[a] = name
        return out

    def get_prefix_mapping_component(self, prefix: str) -> Dict[int, str]:
        """{index: parameter name} of the ``PREFIX<idx>`` parameters."""
        out = {int(n[len(prefix):]): n for n in self.params
               if n.startswith(prefix) and n[len(prefix):].isdigit()}
        return dict(sorted(out.items()))

    def get_params_of_type(self, param_type: str) -> List[str]:
        """Names of the parameters read as class ``param_type``."""
        want = param_type.lower()
        return [n for n, p in self._param_objs().items()
                if _ptype(p).lower() == want]

    @property
    def param_prefixs(self) -> Dict[str, List[str]]:
        """{prefix: [parameter names]} of the indexed families (the
        reference's spelling)."""
        out: Dict[str, List[str]] = {}
        for n, p in self._param_objs().items():
            pre = getattr(p, "prefix", None)
            if pre:
                out.setdefault(pre, []).append(n)
        return out

    def _finish_epoch(self, flag: str, epoch: str) -> None:
        self.config[flag] = self._value(epoch) is not None

    def build_context(self, batch) -> dict:
        """The component's per-TOA context for ``batch``: its own, built
        for the model's TOAs, unless the batch carries its own (the TZR
        row, a subset, TOAs made on the host)."""
        if batch.contexts is not None:
            return batch.contexts.get(type(self).__name__, {})
        return self.context

    def host_context(self, toas) -> dict:
        """The component's per-TOA context for the host table ``toas``
        (:class:`pint_torch.toa.TOAs`; the reference's ``build_context``),
        as host numpy: empty unless the component reads one."""
        return {}

    def _value(self, name):
        pd = self.__dict__.get("_params_dict")
        if pd is not None and name in pd:
            return pd[name].value
        parent = self._parent
        if parent is None or name not in parent:
            return None
        return parent[name].value

    def _parent_param(self, name):
        """The model's parameter ``name`` (another component's), or
        None."""
        parent = self._parent
        return parent[name] if parent is not None and name in parent \
            else None

    def _range_masks(self, toas, indices, r1: str, r2: str,
                     right_open: bool = False):
        """(n, N) float64 0/1 masks of the MJD windows ``[r1_i, r2_i]``
        (``[r1_i, r2_i)`` when ``right_open``), or None without windows
        (the reference's DMX/CMX/SWX/piecewise ``build_context``)."""
        mjds = np.asarray(toas.get_mjds(), dtype=np.float64)
        masks = []
        for i in indices:
            lo = _mjd_float(self._value(f"{r1}{i:04d}"))
            hi = _mjd_float(self._value(f"{r2}{i:04d}"))
            inside = (mjds >= lo) & ((mjds < hi) if right_open
                                     else (mjds <= hi))
            masks.append(inside.astype(np.float64))
        return np.array(masks) if masks else None

    def _select_masks(self, toas, names) -> dict:
        """{name: (N,) float64 0/1} of the mask parameters ``names``."""
        from pint_torch.toa import select_toa_mask

        out = {}
        for j in names:
            m = np.zeros(len(toas))
            m[select_toa_mask(self._parent.params_table[j], toas)] = 1.0
            out[j] = m
        return out


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

    def host_context(self, toas) -> dict:
        """``masks`` {name: (N,) bool} of the component's set mask
        parameters (what the snapshot carries for a noise component)."""
        from pint_torch.toa import select_toa_mask

        table = self._parent.params_table
        masks = {}
        for n in self.params:
            p = table[n]
            if p.kind == "mask" and p.value is not None:
                m = np.zeros(len(toas), dtype=bool)
                m[select_toa_mask(p, toas)] = True
                masks[n] = m
        return {"masks": masks} if masks else {}


def check_contiguous_indices(idxs, component: str, prefix: str,
                             start: int = 0) -> None:
    """MissingParameter unless ``idxs`` is exactly [start, start+1, ...]
    (reference ``timing_model.py:93``): a gap would renumber which
    coefficients are used."""
    expected = list(range(start, start + len(idxs)))
    if sorted(idxs) != expected:
        missing = sorted(set(range(start, max(idxs) + 1)) - set(idxs))
        bad = missing[0] if missing else max(idxs)
        raise MissingParameter(component, f"{prefix}{bad}",
                               f"{prefix} terms must be contiguous from "
                               f"{prefix}{start}")


def _ptype(p) -> str:
    """The parameter class name of a builder parameter or a Param."""
    if isinstance(p, Param):
        return p.ptype or _KIND_PTYPE.get(p.kind, "floatParameter")
    return type(p).__name__


#: the reference parameter class of each Param kind, where a model did not
#: come from par text
_KIND_PTYPE = {"float": "floatParameter", "mjd": "MJDParameter",
               "pair": "pairParameter", "mask": "maskParameter",
               "int": "intParameter", "str": "strParameter",
               "bool": "boolParameter"}


def _mjd_float(v) -> float:
    """An epoch parameter's value as the float64 the reference's
    ``float(longdouble)`` gives: the pair's high word."""
    return float(v[0]) if isinstance(v, tuple) else float(v)


def stack_params(pv, names: Sequence[str], device) -> torch.Tensor:
    """(B, len(names)) tensor of parameter values: free parameters are
    (B, 1) tensors, the rest floats broadcast to every row."""
    cols = [pv.get(n, 0.0) for n in names]
    B = max((c.shape[0] for c in cols if torch.is_tensor(c)), default=1)
    return torch.cat([c.expand(B, 1) if torch.is_tensor(c)
                      else torch.full((B, 1), float(c), dtype=F64,
                                      device=device)
                      for c in cols], dim=1)


def validate_units(model, allow_tcb: bool) -> None:
    """UNITS must be TDB, or TCB where ``allow_tcb`` (the reference's
    ``TimingModel.validate``)."""
    from pint_torch.exceptions import TimingModelError

    units = model["UNITS"].value if "UNITS" in model else None
    if units not in (None, "TDB", "TCB"):
        raise TimingModelError(f"UNITS={units} not supported")
    if units == "TCB" and not allow_tcb:
        raise TimingModelError(
            "TCB par files must be converted to TDB (use convert_tcb_tdb)")


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

    def validate(self, allow_tcb: bool = False) -> None:
        """UNITS (TDB, or TCB with ``allow_tcb``) and each component's own
        checks of its parameters (reference ``timing_model.py:365``)."""
        validate_units(self, allow_tcb)
        for c in self.components.values():
            if hasattr(c, "validate"):
                c.validate()

    # -- registry queries (reference ``timing_model.py:440-610``) ----------
    @property
    def top_level_params(self) -> List[str]:
        return [n for n, p in self.params_table.items()
                if p.component == "TimingModel"]

    @property
    def params_ordered(self) -> List[str]:
        """Alias of :attr:`params` (the reference keeps both)."""
        return self.params

    def get_params_of_type(self, kind: str) -> List[str]:
        """Parameters read as class ``kind`` or a subclass of it
        (``maskParameter``, ``prefixParameter``, ``MJDParameter``,
        ``floatParameter``)."""
        from pint_torch.models import parameter

        cls = {"maskParameter": parameter.maskParameter,
               "prefixParameter": parameter.prefixParameter,
               "MJDParameter": parameter.MJDParameter,
               "floatParameter": parameter.floatParameter}[kind]
        return [n for n, p in self.params_table.items()
                if issubclass(getattr(parameter, _ptype(p)), cls)]

    def get_prefix_mapping(self, prefix: str) -> Dict[int, str]:
        """{index: name} of the ``PREFIX<idx>`` parameters over every
        component; ValueError where no component carries the prefix."""
        out: Dict[int, str] = {}
        for comp in self.components.values():
            out.update(comp.get_prefix_mapping_component(prefix))
        if not out:
            raise ValueError(f"Cannot find prefix {prefix!r} in the model")
        return dict(sorted(out.items()))

    def match_param_aliases(self, key: str) -> str:
        """The parameter a par-file key names or aliases."""
        for n in self.top_level_params:
            p = self.params_table[n]
            if key.upper() in [n.upper()] + [a.upper() for a in p.aliases]:
                return n
        for comp in self.components.values():
            hit = comp.match_param_alias(key)
            if hit:
                return hit
        raise UnknownParameter(f"Unrecognized parfile parameter {key!r}")

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

    @free_params.setter
    def free_params(self, names: Sequence[str]) -> None:
        """Free exactly ``names`` and freeze every other parameter but the
        model's own (reference ``timing_model.py:427-437``); a name the
        model lacks raises :class:`UnknownParameter`.  Every cache keyed on
        the free set (the compiled evaluations' host batches, the design
        matrix's linear columns, the noise bases, the grid's classified
        columns and bundles) lives in ``_cache`` and is dropped."""
        names = set(names)
        unknown = names - set(self.params)
        if unknown:
            raise UnknownParameter(f"Unknown parameters: {sorted(unknown)}")
        for n, p in self.params_table.items():
            if p.component == "TimingModel":
                continue
            p.frozen = n not in names
        self._cache.clear()

    def design_param_names(self, incfrozen: bool = False) -> Tuple[str, ...]:
        """Continuous, non-epoch, non-noise parameters, free ones only
        unless ``incfrozen``: the timing design-matrix columns after the
        offset."""
        return tuple(
            n for n, p in self.params_table.items()
            if p.component != "TimingModel"
            and (incfrozen or not p.frozen) and p.continuous
            and p.kind != "mjd" and not self._is_noise_param(n))

    def _is_noise_param(self, name: str) -> bool:
        """The parameter belongs to a noise component (reference
        ``timing_model.py:900``)."""
        comp = self.components.get(self.params_table[name].component)
        return getattr(comp, "kind", None) == "noise"

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

    def host_contexts(self, toas, device=None) -> dict:
        """Each component's context for the host table ``toas``, by
        component name (the reference's ``_build_context``,
        ``timing_model.py:611``): float64 tensors on ``device`` (the
        model's by default), a noise component's host numpy as the
        snapshot's are."""
        dev = self.device if device is None else torch.device(device)

        def to_dev(x):
            if isinstance(x, dict):
                return {k: to_dev(v) for k, v in x.items()}
            if x is None:
                return None
            return torch.tensor(np.asarray(x, dtype=np.float64), dtype=F64,
                                device=dev)

        return {name: (c.host_context(toas) if c.kind == "noise"
                       else to_dev(c.host_context(toas)))
                for name, c in self.components.items()}

    def batch_of(self, toas):
        """The device batch of ``toas``: a :class:`TOABatch` as it is, a
        host :class:`~pint_torch.toa.TOAs` frozen on the model's device
        with this model's contexts, cached per TOAs object and its
        ``_version`` (the reference's ``_get_compiled`` data cache)."""
        from pint_torch.toa import TOAs

        if not isinstance(toas, TOAs):
            return toas
        data = self._cache.setdefault("host_batches",
                                      weakref.WeakKeyDictionary())
        hit = data.get(toas)
        if hit is None or hit[0] != toas._version:
            hit = (toas._version, toas.to_batch(device=self.device,
                                                model=self))
            data[toas] = hit
        return hit[1]

    def evaluate(self, values: torch.Tensor, free_names: Sequence[str],
                 batch, const_pv: Optional[dict] = None):
        """(Phase, delay), each (B, N), at ``values`` (B, len(free_names))
        (reference ``_get_compiled.eval_fn``, ``timing_model.py:643-654``);
        ``batch`` a :class:`TOABatch` or host TOAs (:meth:`batch_of`)."""
        batch = self.batch_of(batch)
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
        """Total delay [s] at each TOA (a batch or host TOAs)."""
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

    def designmatrix(self, batch, incfrozen: bool = False,
                     incoffset: bool = True, reuse_linear: bool = False):
        """(M, names): columns -d phase / d param / F0, frozen parameters'
        too with ``incfrozen``, after an offset column 1/F0 unless a
        PhaseOffset fits PHOFF (reference ``timing_model.py:859-888``)."""
        incoffset = incoffset and "PhaseOffset" not in self.components
        free = self.design_param_names(incfrozen=incfrozen)
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

    def psr_direction(self) -> np.ndarray:
        """Unit vector SSB -> pulsar (ICRS) at POSEPOCH/PEPOCH (reference
        ``timing_model.py:1187``): the sky position the catalog's
        Hellings-Downs separations are taken from.  Raises
        :class:`MissingComponent` without an astrometry component."""
        for c in self.components.values():
            if hasattr(c, "ssb_to_psb_xyz_ICRS"):
                return np.asarray(c.ssb_to_psb_xyz_ICRS(), dtype=np.float64)
        raise MissingComponent(
            f"{self.name or '?'}: no astrometry component -- cross-pulsar "
            "correlations need a sky position")

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
