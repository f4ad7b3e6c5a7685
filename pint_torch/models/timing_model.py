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
from collections.abc import Mapping
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
    #: the :mod:`pint_torch.models.parameter` object the parameter was
    #: read as (its par-file spelling), or None
    _src: object = field(default=None, repr=False, compare=False)

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

    def validate_toas(self, toas) -> None:
        """Raise where the TOAs lack what the component needs."""

    def finish_config(self) -> None:
        """Record in ``config`` what the evaluation reads from the
        parameters' values at build time (epochs present, term counts);
        the builder calls it after :meth:`TimingModel.validate`."""

    def add_param(self, param, setup: bool = False):
        """Add ``param`` (a :mod:`pint_torch.models.parameter` object, or
        a :class:`Param`): to the template while the component is read
        from par text, else to the model's table as a :class:`Param` of
        this component (appended to :attr:`params`, as the reference's),
        dropping the model's caches; ``setup`` resolves the component's
        structure again."""
        parent = self.__dict__.get("_parent")
        if "_params_dict" in self.__dict__ or not isinstance(parent,
                                                             TimingModel):
            self.__dict__.setdefault("_params_dict", {})[param.name] = param
            param._component = self
            if param.name not in self.params:
                self.params.append(param.name)
            if setup:
                self.setup()
            return param
        rec = _as_record(param, type(self).__name__)
        parent.params_table[rec.name] = rec
        if rec.name not in self.params:
            self.params.append(rec.name)
        parent._reorder()
        if setup:
            self.setup()
            self.finish_config()
        return rec

    def remove_param(self, name: str) -> None:
        """Drop the parameter from the template, or from the model's table
        (dropping the model's caches)."""
        self.__dict__.get("_params_dict", {}).pop(name, None)
        if name in self.params:
            self.params.remove(name)
        parent = self.__dict__.get("_parent")
        if isinstance(parent, TimingModel) \
                and "_params_dict" not in self.__dict__:
            parent.params_table.pop(name, None)
            parent._reorder()

    def __getattr__(self, name):
        """A parameter by name: the builder's parameter object while the
        component is being built, the model's :class:`Param` after."""
        d = self.__dict__
        pd = d.get("_params_dict")
        if pd is not None and name in pd:
            return pd[name]
        parent = d.get("_parent")
        if name == "_params_dict" and isinstance(parent, TimingModel):
            return _ParamView(self)
        if parent is not None and name in d.get("params", ()):
            return parent[name]
        raise AttributeError(
            f"{type(self).__name__} has no attribute {name!r}")

    def _param_obj(self, name):
        """Parameter ``name`` as a :mod:`pint_torch.models.parameter`
        object: the template's own while the component is read from par
        text, else one carrying the table's current state
        (:func:`as_parameter`)."""
        pd = self.__dict__.get("_params_dict")
        if pd is not None:
            return pd[name]
        return as_parameter(self._parent, name)

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
        row, a subset, TOAs made on the host).  One built for another
        structure of the component than the model's now (a DMX window
        removed, a JUMP added; :meth:`TimingModel._context_stale`) raises
        :class:`~pint_torch.exceptions.UsageError`: evaluate the edited
        model on a batch made again from host TOAs
        (:meth:`TimingModel.batch_for`)."""
        name = type(self).__name__
        parent = self._parent
        if parent is not None and parent._context_stale(name, batch):
            from pint_torch.exceptions import UsageError

            raise UsageError(
                f"{name}'s context was built for other parameters than the "
                "model's now; evaluate the edited model on a batch made "
                "from host TOAs (TOAs.to_batch(model=))")
        if batch.contexts is not None:
            return batch.contexts.get(name, {})
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


class _ParamView(Mapping):
    """A built component's parameters as :mod:`pint_torch.models.parameter`
    objects (:func:`as_parameter`), read-only: what a component's
    ``setup`` reads as ``_params_dict`` once the model is built; its
    ``add_param`` writes to the model's table."""

    def __init__(self, comp):
        self._comp = comp

    def __getitem__(self, name):
        if name not in self._comp.params:
            raise KeyError(name)
        return as_parameter(self._comp._parent, name)

    def __iter__(self):
        return iter(list(self._comp.params))

    def __len__(self):
        return len(self._comp.params)


def _as_record(param, component: str) -> Param:
    """A :class:`Param` of ``component`` from a parameter object (the
    builder's conversion) or a copy of a :class:`Param`."""
    if isinstance(param, Param):
        return dataclasses.replace(param, component=component,
                                   key_value=list(param.key_value))
    from pint_torch.models.model_builder import _record

    return _record(param, component)


def _declared(model, name: str):
    """A fresh parameter object of the class and spelling ``name`` is
    declared with: the model's own parameter, a component's declared one,
    or a new member of its declared family."""
    p = model.params_table[name]
    if p.component == "TimingModel":
        from pint_torch.models.model_builder import _top_level_params

        return next(q for q in _top_level_params() if q.name == name)
    comp = model.components[p.component]
    tmpl = type(comp).template()
    pd = tmpl.__dict__["_params_dict"]
    if name in pd:
        return pd[name]
    from pint_torch.models.parameter import (maskParameter, pairParameter,
                                             prefixParameter,
                                             split_prefixed_name)

    for q in pd.values():
        if isinstance(q, maskParameter) and name.startswith(q.origin_name) \
                and name[len(q.origin_name):].isdigit():
            return q.new_param(int(name[len(q.origin_name):]))
    prefix, index = split_prefixed_name(name)
    for q in pd.values():
        if isinstance(q, (prefixParameter, pairParameter)) \
                and q.prefix == prefix:
            out = q.new_param(index)
            out.name = name
            return out
    raise UnknownParameter(f"{name!r} is no parameter {p.component} "
                           "declares")


def as_parameter(model, name: str):
    """The model's parameter ``name`` as a :mod:`pint_torch.models.parameter`
    object with the table's value (an epoch as the longdouble of its
    exact pair), frozen flag, uncertainty and mask selection: what the
    par-file writer and the components' editing methods read."""
    import copy

    p = model.params_table[name]
    obj = copy.copy(p._src if p._src is not None else _declared(model, name))
    v = p.value
    if p.kind == "mjd" and v is not None:
        v = np.longdouble(v[0]) + np.longdouble(v[1])
    elif p.kind == "pair" and v is not None:
        v = tuple(v)
    elif p.kind == "int" and v is not None:
        v = int(v)
    obj.value = v
    obj.frozen = p.frozen
    obj.uncertainty = p.uncertainty
    if p.kind == "mask":
        obj.key, obj.key_value = p.key, list(p.key_value)
    return obj


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
        for name, c in self.components.items():
            if c.context and "_ctx_for" not in c.__dict__:
                c._ctx_for = self._component_signature(name)

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
        comps = []
        for c in self.components.values():
            comps.append(type(c)(c.config, c.context))
            if "_ctx_for" in c.__dict__:
                comps[-1]._ctx_for = c._ctx_for
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
        the free set (the token of the host TOAs' batches, the design
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
        with this model's contexts (the reference's ``_get_compiled`` data
        cache).  The batch is kept on the TOAs object, per model (held
        weakly), edit of the model and ``_version`` of the TOAs, so it
        lives no longer than the TOAs it was frozen from."""
        from pint_torch.toa import TOAs

        if not isinstance(toas, TOAs):
            return toas
        token = self._cache.setdefault("batch_token", object())
        data = toas.__dict__.setdefault("_batches",
                                        weakref.WeakKeyDictionary())
        hit = data.get(self)
        if hit is None or hit[0] is not token or hit[1] != toas._version:
            hit = (token, toas._version,
                   toas.to_batch(device=self.device, model=self))
            data[self] = hit
        return hit[2]

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

    # -- editing (reference ``timing_model.py:329-380,1318-1520,1647-1688``)
    def _edited(self) -> None:
        """Drop what depends on the parameter set and the components: the
        token of the host TOAs' batches, the contexts' signatures, the design
        matrix's linear columns, the noise bases, the grid's bundles and
        captured graphs (all in ``_cache``) and the TZR row with its
        contexts."""
        self._cache.clear()
        tzr = self.components.get("AbsPhase")
        if tzr is not None:
            tzr.__dict__.pop("_host_tzr", None)
            tzr.__dict__.pop("_tzr_toas", None)
            if "tzr_batch" in tzr.context:
                tzr.context = {k: v for k, v in tzr.context.items()
                               if k != "tzr_batch"}

    def _reorder(self) -> None:
        """The table in the reference's parameter order after an edit: the
        model's own parameters, then each component's in its order."""
        table = self.params_table
        names = [n for n, p in table.items() if p.component == "TimingModel"]
        for comp in self.components.values():
            names += [n for n in comp.params if n in table]
        self.params_table = {n: table[n] for n in names}
        self._edited()

    def _context_signature(self) -> tuple:
        """What the components' per-TOA contexts are built from: the
        components, their parameters, each mask's selection and each
        epoch (DMX and SWX windows), cached until an edit."""
        sig = self._cache.get("context_signature")
        if sig is None:
            sig = tuple(
                (name, tuple(
                    (n, p.key, tuple(p.key_value)) if p.kind == "mask"
                    else (n, p.value) if p.kind == "mjd" else n
                    for n, p in ((n, self.params_table[n])
                                 for n in c.params if n in self.params_table)))
                for name, c in self.components.items())
            self._cache["context_signature"] = sig
        return sig

    def _context_signatures(self) -> dict:
        """{component name: its part of :meth:`_context_signature`}, what
        a batch's contexts record as built for (``TOABatch._ctx_sig``)."""
        by = self._cache.get("context_signature_by")
        if by is None:
            by = self._cache["context_signature_by"] = dict(
                self._context_signature())
        return by

    def _component_signature(self, name: str) -> tuple:
        """The part of :meth:`_context_signature` of component ``name``."""
        return self._context_signatures().get(name)

    def _context_current(self, name: str, built) -> bool:
        """Whether ``built`` is component ``name``'s signature now (the
        verdict cached per ``built`` until an edit: every evaluation
        asks)."""
        seen = self._cache.setdefault(("context_current", name), {})
        hit = seen.get(id(built))
        if hit is None or hit[0] is not built:
            hit = seen[id(built)] = (
                built, built == self._component_signature(name))
        return hit[1]

    def _context_stale(self, name: str, batch) -> bool:
        """Whether component ``name``'s per-TOA context for ``batch`` was
        built for another structure of it than the model's now: the
        batch's own context against the signature the batch records for
        it (``TOABatch._ctx_sig``; a component added since then is stale
        where it derives a context, :meth:`Component.host_context`), else
        the component's own against ``_ctx_for``.  A context of unknown
        origin (a snapshot's: no signature) is taken as current."""
        comp = self.components[name]
        if batch.contexts is None:
            built = comp.__dict__.get("_ctx_for")
            return bool(comp.context) and built is not None \
                and not self._context_current(name, built)
        sig = batch._ctx_sig
        if sig is None or type(comp).host_context is Component.host_context:
            return False
        if name not in sig:
            return True
        return sig[name] is not None \
            and not self._context_current(name, sig[name])

    def batch_for(self, toas):
        """:meth:`batch_of`, and a batch whose contexts were built for
        another structure of the model (before an edit) made again from
        the host TOAs it was frozen from with this model's contexts; one
        without host TOAs raises
        :class:`~pint_torch.exceptions.UsageError`."""
        batch = self.batch_of(toas)
        if batch.tzr or not any(self._context_stale(n, batch)
                                for n in self.components):
            return batch
        if batch.host is None:
            from pint_torch.exceptions import UsageError

            raise UsageError(
                "the batch's contexts were built for other parameters than "
                "the model's now and it carries no host TOAs to build them "
                "again from; select the TOAs from a batch made by "
                "TOAs.to_batch")
        pn, dpn = batch.pulse_number, batch.delta_pulse_number
        batch = self.batch_of(batch.host)
        if pn is not None and batch.pulse_number is None:
            object.__setattr__(batch, "pulse_number", pn)
            object.__setattr__(batch, "delta_pulse_number", dpn)
        return batch

    def setup(self) -> None:
        """Each component's structure resolved again from its parameters
        (``setup`` and ``finish_config``) and every cache dropped."""
        for c in self.components.values():
            c.setup()
            c.finish_config()
        self._edited()

    def validate_toas(self, toas) -> None:
        """Each component's check that the TOAs carry what it needs."""
        for c in self.components.values():
            c.validate_toas(toas)

    def add_component(self, comp, order=None, validate: bool = True):
        """Add ``comp``: a component template (``Cls.template()``, its
        parameters entering the table) or a component of another model
        (its parameters copied); ``validate`` runs its ``setup`` and
        ``validate`` (the model's :meth:`setup` resolves the rest)."""
        name = type(comp).__name__
        pd = comp.__dict__.pop("_params_dict", None)
        old = comp.__dict__.get("_parent")
        if pd is not None:
            recs = [_as_record(pd[n], name) for n in comp.params]
        elif isinstance(old, TimingModel) and old is not self:
            recs = [_as_record(old.params_table[n], name)
                    for n in comp.params]
        else:
            recs = []
        self.components[name] = comp
        comp._parent = self
        self.params_table.update((r.name, r) for r in recs)
        self._reorder()
        if validate:
            comp.setup()
            comp.validate()
            comp.finish_config()

    def remove_component(self, name: str) -> None:
        """Drop the component and its parameters."""
        comp = self.components.pop(name)
        for n in comp.params:
            self.params_table.pop(n, None)
        comp._parent = None
        self._reorder()

    def add_param_from_top(self, param, target_component: str,
                           setup: bool = False):
        """Add ``param`` to the component named ``target_component`` ('' is
        the model's own parameters)."""
        if target_component == "":
            rec = _as_record(param, "TimingModel")
            self.params_table[rec.name] = rec
            self._reorder()
            return rec
        if target_component not in self.components:
            raise AttributeError(
                f"Cannot find component {target_component!r} in the model")
        return self.components[target_component].add_param(param,
                                                           setup=setup)

    def remove_param(self, param: str) -> None:
        """Remove ``param`` from whichever component holds it (or the
        model's own parameters)."""
        p = self.params_table.get(param)
        if p is not None and p.component == "TimingModel":
            del self.params_table[param]
            self._reorder()
            return
        for c in self.components.values():
            if param in c.params:
                c.remove_param(param)
                self._edited()
                return
        raise AttributeError(f"Parameter {param!r} is not in the model")

    def find_empty_masks(self, toas, freeze: bool = False) -> List[str]:
        """The free mask parameters that select no TOA of ``toas`` (host
        TOAs, or a batch frozen from them); ``freeze`` freezes them."""
        from pint_torch.logging import log
        from pint_torch.toa import select_toa_mask

        host = _host_of(toas)
        out = []
        for n, p in list(self.params_table.items()):
            if p.kind == "mask" and not p.frozen \
                    and len(select_toa_mask(p, host)) == 0:
                out.append(n)
                if freeze:
                    log.info(f"'{n}' has no TOAs so freezing")
                    p.frozen = True
        if freeze and out:
            self._cache.clear()
        return out

    def delete_jump_and_flags(self, toas, jump_num: int) -> None:
        """Remove JUMP<jump_num> (and the PhaseJump component with its last
        jump) and the TOAs' ``-gui_jump``/``-jump`` flags naming it;
        ``toas`` host TOAs, a batch frozen from them, or None."""
        comp = self.components.get("PhaseJump")
        name = f"JUMP{jump_num}"
        if comp is None or name not in comp.params:
            raise ValueError(f"No {name} in the model")
        comp.remove_param(name)
        comp.setup()
        if not comp.config["jumps"]:
            self.remove_component("PhaseJump")
        if toas is not None:
            host = _host_of(toas)
            for fl in host.flags:
                if fl.get("gui_jump") == str(jump_num):
                    del fl["gui_jump"]
                if fl.get("jump") == str(jump_num):
                    del fl["jump"]
            host._version += 1
        self._edited()

    def add_tzr_toa(self, toas) -> None:
        """An AbsPhase with the TZR on the first TOA where the model has
        none."""
        if "AbsPhase" in self.components:
            return
        from pint_torch.models.absolute_phase import AbsPhase

        host = _host_of(toas)
        self.add_component(AbsPhase.template(), validate=False)
        mjd = float(np.asarray(host.get_mjds())[0])
        self.params_table["TZRMJD"].value = (mjd, 0.0)
        self.params_table["TZRSITE"].value = str(host.obs[0])
        f = float(np.asarray(host.freq_mhz)[0])
        self.params_table["TZRFRQ"].value = f if np.isfinite(f) else 0.0
        self.setup()

    def jump_flags_to_params(self, toas) -> None:
        """JUMP parameters (free, 0) for the TOAs' ``-jump``/``-gui_jump``
        flag values that no JUMP selects yet, each flag normalized to
        ``-jump <i>``."""
        from pint_torch.models.jump import PhaseJump
        from pint_torch.models.parameter import maskParameter

        host = _host_of(toas)
        idxs = set()
        for fl in host.flags:
            for key in ("jump", "gui_jump"):
                if key in fl:
                    idxs.add(int(float(fl[key])))
        if not idxs:
            return
        if "PhaseJump" not in self.components:
            self.add_component(PhaseJump.template(), validate=False)
        comp = self.components["PhaseJump"]
        for i in sorted(idxs):
            for fl in host.flags:
                for key in ("jump", "gui_jump"):
                    if key in fl and int(float(fl[key])) == i:
                        fl["jump"] = str(i)
            # a jump without a key (the component's declared JUMP1) raises
            # AttributeError here, as in the reference
            existing = any(
                self.params_table[p].key.lstrip("-") == "jump"
                and list(self.params_table[p].key_value) == [str(i)]
                for p in self.params if p.startswith("JUMP"))
            if existing:
                continue
            comp.add_param(maskParameter("JUMP", index=i, key="-jump",
                                         key_value=[str(i)], units="s",
                                         value=0.0, frozen=False),
                           setup=True)
        host._version += 1
        self.setup()

    def d_phase_d_toa(self, toas, sample_step: Optional[float] = None
                      ) -> torch.Tensor:
        """The topocentric spin frequency [Hz] at each TOA: the phase's
        central difference in arrival time, half-step ``sample_step`` [s]
        (two spin periods by default), on copies of the host TOAs shifted
        by -h and +h with their observatory states derived again; the
        integer and fractional phases are differenced apart."""
        import copy

        host = _host_of(toas)
        h = 2.0 / self.value("F0") if sample_step is None \
            else float(sample_step)
        phases = []
        for sgn in (-1.0, 1.0):
            t = copy.deepcopy(host)
            t.adjust_TOAs(np.full(t.ntoas, sgn * h))
            if t.ssb_obs_pos_km is not None:
                t.compute_posvels(ephem=t.ephem, planets=t.planets)
            phases.append(self.phase(t, abs_phase=False))
        dp_int = phases[1].int_ - phases[0].int_
        dp_frac = phases[1].frac - phases[0].frac
        return (dp_int + dp_frac) / (2.0 * h)

    def as_parfile(self, comment: Optional[str] = None,
                   format: str = "pint") -> str:
        """Par-file text in the ``pint``, ``tempo`` or ``tempo2`` dialect:
        each set parameter's line, the model's own first, as its
        :mod:`pint_torch.models.parameter` object writes it
        (:func:`as_parameter`)."""
        lines = ["# Created by pint_torch\n" if comment is None
                 else f"# {comment}\n"]
        if format.lower() != "pint":
            lines.append(f"# Format: {format.lower()}\n")
        for n, p in self.params_table.items():
            if p.component != "TimingModel":
                continue
            par = as_parameter(self, n)
            if par.value is not None and par.value != "" \
                    and par.value is not False:
                lines.append(par.as_parfile_line(format))
        for comp in self.components.values():
            for n in comp.params:
                ln = as_parameter(self, n).as_parfile_line(format)
                if ln:
                    lines.append(ln)
        return "".join(lines)

    def write_parfile(self, path: str, comment: Optional[str] = None,
                      format: str = "pint"):
        """Write :meth:`as_parfile` to ``path``."""
        with open(path, "w") as f:
            f.write(self.as_parfile(comment, format=format))

    def compare(self, other: "TimingModel", nodmx: bool = False,
                threshold_sigma: float = 3.0, verbosity: str = "max") -> str:
        """A table of each parameter in both models (value and
        uncertainty), its change in units of each model's uncertainty and
        a mark where either reaches ``threshold_sigma``; ``verbosity``
        ``max`` every parameter, ``med`` changed or significant ones,
        ``min`` significant ones, ``check`` only their names."""
        def _fmt(par):
            if par is None or par.value is None:
                return "--"
            try:
                v = float(par.value)
            except (TypeError, ValueError):
                return str(par.value)
            u = par.uncertainty
            return f"{v:.10g}" + (f" +/- {float(u):.2g}" if u else "")

        rows = [f"{'PARAMETER':<15} {'SELF':>28} {'OTHER':>28} "
                f"{'Diff_Sigma1':>12} {'Diff_Sigma2':>12}"]
        flagged = []
        for p in self.params:
            if self.params_table[p].component == "TimingModel" \
                    or nodmx and p.startswith("DMX"):
                continue
            par1 = as_parameter(self, p)
            par2 = as_parameter(other, p) if p in other else None
            v1, v2 = par1.value, par2.value if par2 is not None else None
            if v1 is None and v2 is None:
                continue
            sig1 = sig2 = None
            try:
                d = float(v2) - float(v1)
                if par1.uncertainty:
                    sig1 = d / float(par1.uncertainty)
                if par2 is not None and par2.uncertainty:
                    sig2 = d / float(par2.uncertainty)
            except (TypeError, ValueError):
                pass
            crossed = any(s is not None and abs(s) >= threshold_sigma
                          for s in (sig1, sig2))
            if crossed:
                flagged.append(p)
            if verbosity == "min" and not crossed:
                continue
            if verbosity == "med" and v1 == v2 and not crossed:
                continue
            if verbosity == "check":
                continue
            s1 = f"{sig1:12.3f}" if sig1 is not None else f"{'--':>12}"
            s2 = f"{sig2:12.3f}" if sig2 is not None else f"{'--':>12}"
            mark = " !" if crossed else ""
            rows.append(f"{p:<15} {_fmt(par1):>28} {_fmt(par2):>28} "
                        f"{s1} {s2}{mark}")
        if verbosity == "check":
            return "\n".join(flagged)
        if flagged:
            rows.append(f"# parameters changed by >= {threshold_sigma} "
                        f"sigma: {', '.join(flagged)}")
        return "\n".join(rows)


def _host_of(toas):
    """The host :class:`~pint_torch.toa.TOAs` of ``toas`` (host TOAs, or a
    batch frozen from them)."""
    from pint_torch.exceptions import UsageError
    from pint_torch.toa import TOAs

    if isinstance(toas, TOAs):
        return toas
    host = getattr(toas, "host", None)
    if host is None:
        raise UsageError("this needs the host TOAs (a batch made by "
                         "TOAs.to_batch carries them; a snapshot's does not)")
    return host
