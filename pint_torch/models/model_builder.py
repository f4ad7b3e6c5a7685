"""Par file -> TimingModel (port of ``pint_tpu/models/model_builder.py``).

The builder reads a par file into one template of each chosen component
(:meth:`Component.template`: the component's parameters as
:mod:`pint_torch.models.parameter` objects), as the reference does:
component choice from the keys present, repeated mask keys (JUMP, EFAC,
ECORR by flag) grown into indexed mask parameters in file order, prefixed
families (F2, DMX_0002, GLF0_2) grown on demand, then each component's
``setup`` and ``validate`` and, with ``allow_tcb=True``, the TCB -> TDB
rewrite.  Only then is the port's :class:`TimingModel` made on the device:
each parameter becomes its :class:`Param` record (an epoch as the exact
(hi, lo) pair of its longdouble value) and each component's ``config``
is what its ``setup`` and ``finish_config`` resolved.  Everything before
that last step is host numpy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from pint_torch.exceptions import UnknownBinaryModel
from pint_torch.io.par import ParLine, parse_parfile
from pint_torch.logging import log
from pint_torch.models.parameter import (MJDParameter, Parameter,
                                         boolParameter, floatParameter,
                                         intParameter,
                                         maskParameter, pairParameter,
                                         prefixParameter,
                                         split_prefixed_name, strParameter)
from pint_torch.models.timing_model import (Component, Param, TimingModel,
                                            validate_units)

__all__ = ["ModelBuilder", "get_model", "get_model_and_toas",
           "parse_parfile", "guess_binary_model",
           "convert_binary_params_dict", "AllComponents", "IGNORE_PARAMS",
           "IGNORE_PREFIX"]

#: par keys silently ignored (reference ``model_builder.py:49``)
IGNORE_PARAMS = {
    "NITS", "IBOOT", "MODE", "PLANET_SHAPIRO2", "GAIN", "EPHVER",
    "DMMODEL", "DMOFF", "DM_SERIES", "TRACK",
}

IGNORE_PREFIX = {"DMXF1_", "DMXF2_", "DMXEP_", "DMXCM_"}


def _top_level_params() -> List[Parameter]:
    """The model's own parameters (reference ``timing_model.py:298-319``)."""
    return [
        strParameter("PSR", description="Pulsar name",
                     aliases=["PSRJ", "PSRB"]),
        strParameter("EPHEM", description="Solar-system ephemeris"),
        strParameter("CLOCK", description="Timescale (e.g. TT(BIPM2021))",
                     aliases=["CLK"]),
        strParameter("UNITS", description="Timescale units (TDB/TCB)"),
        strParameter("TIMEEPH", description="Time ephemeris (FB90/IF99)"),
        strParameter("T2CMETHOD",
                     description="Terrestrial->celestial method"),
        strParameter("BINARY", description="Binary model name"),
        boolParameter("DILATEFREQ", value=False,
                      description="tempo2 DILATEFREQ"),
        boolParameter("PLANET_SHAPIRO", value=False,
                      description="Include planet Shapiro delays"),
        MJDParameter("START", description="Start of fit range"),
        MJDParameter("FINISH", description="End of fit range"),
        floatParameter("RM", units="rad m^-2", description="Rotation measure"),
        strParameter("INFO", description="Info flag"),
        floatParameter("CHI2", units="", description="Fit chi2"),
        floatParameter("CHI2R", units="", description="Reduced chi2"),
        floatParameter("TRES", units="us", description="TOA residual RMS"),
        floatParameter("DMRES", units="pc/cm3",
                       description="DM residual RMS"),
        intParameter("NTOA", description="Number of TOAs"),
        intParameter("EPHVER", description="Ephemeris version (ignored)"),
        strParameter("DMDATA", description="Wideband DM data flag"),
    ]


class _HostModel:
    """The model while it is read from par text: the top-level parameters
    and the component templates, with the reference ``TimingModel``'s
    host interface (``params``, ``[name]``, ``in``, attribute access to a
    parameter, ``validate(allow_tcb)``) that ``setup``, ``validate`` and
    :func:`~pint_torch.models.tcb_conversion.convert_tcb_tdb` use."""

    def __init__(self):
        self.components: Dict[str, Component] = {}
        self._top_params_dict = {p.name: p for p in _top_level_params()}
        self.top_level_params = list(self._top_params_dict)

    def add_component(self, comp: Component) -> None:
        self.components[type(comp).__name__] = comp
        comp._parent = self

    def _find(self, name):
        if name in self._top_params_dict:
            return self._top_params_dict[name]
        for comp in self.components.values():
            if name in comp._params_dict:
                return comp._params_dict[name]
        return None

    def __getitem__(self, name) -> Parameter:
        p = self._find(name)
        if p is None:
            raise KeyError(name)
        return p

    def __contains__(self, name) -> bool:
        return self._find(name) is not None

    def __getattr__(self, name):
        p = self.__dict__.get("_top_params_dict") is not None \
            and self._find(name)
        if not p:
            raise AttributeError(name)
        return p

    @property
    def params(self) -> List[str]:
        out = list(self.top_level_params)
        for comp in self.components.values():
            out += comp.params
        return out

    def validate(self, allow_tcb: bool = False) -> None:
        validate_units(self, allow_tcb)
        for comp in self.components.values():
            comp.validate()


def _record(par: Parameter, component: str) -> Param:
    """The port's :class:`Param` of a parameter read from par text: an
    epoch as the (hi, lo) pair of its longdouble value, an angle in
    radians, a pair as a tuple (the snapshot exporter's conversion)."""
    from pint_torch.dd import dd_from_longdouble

    v = par.value
    if isinstance(par, pairParameter):
        kind = "pair"
        if v is not None:
            v = (float(v[0]), float(v[1]))
    elif isinstance(par, MJDParameter):
        kind = "mjd"
        if v is not None:
            d = dd_from_longdouble(np.longdouble(v))
            v = (float(d.hi), float(d.lo))
    elif isinstance(par, maskParameter):
        kind = "mask"
    elif isinstance(par, strParameter):
        kind, v = "str", None if v is None else str(v)
    elif isinstance(par, boolParameter):
        kind, v = "bool", None if v is None else bool(v)
    elif isinstance(par, intParameter):
        kind = "int"
    else:
        kind = "float"
    if kind in ("float", "mask", "int") and v is not None:
        v = float(v)
    return Param(
        name=par.name, component=component, kind=kind, value=v,
        frozen=bool(par.frozen), units=str(par.units or ""),
        uncertainty=None if par.uncertainty is None
        else float(par.uncertainty),
        continuous=bool(par.continuous), key=getattr(par, "key", None),
        key_value=[str(x) for x in (getattr(par, "key_value", None) or [])],
        aliases=list(par.aliases), ptype=type(par).__name__,
        prefix=getattr(par, "prefix", None), _src=par)


def _top_value(par: Parameter):
    """A top-level parameter's value as the port's table holds it."""
    v = par.value
    if v is None:
        return None
    if isinstance(par, MJDParameter):
        return _record(par, "TimingModel").value
    if isinstance(par, boolParameter):
        return bool(v)
    if isinstance(par, intParameter):
        return int(v)
    if isinstance(par, floatParameter):
        return float(v)
    return str(v)


class ModelBuilder:
    """Assemble a :class:`TimingModel` from parsed par-file entries
    (reference ``model_builder.py:56``)."""

    def __init__(self):
        self.templates: Dict[str, type] = dict(Component.component_types)

    # -- component choice (reference ``model_builder.py:72-177``) ----------
    def choose_components(self, entries, allow_T2: bool = False) -> List[str]:
        keys = set(entries.keys())
        chosen: List[str] = []
        t = self.templates

        def has(*names):
            return any(n in keys for n in names)

        def starts(pre):
            return any(k.startswith(pre) for k in keys)

        if has("RAJ", "RA"):
            chosen.append("AstrometryEquatorial")
        elif has("ELONG", "LAMBDA"):
            chosen.append("AstrometryEcliptic")
        if has("F0"):
            chosen.append("Spindown")
        if any(c.startswith("Astrometry") for c in chosen) \
                and "SolarSystemShapiro" in t:
            chosen.append("SolarSystemShapiro")
        if has("DM") or any(k.startswith("DM") and k[2:].isdigit()
                            for k in keys):
            chosen.append("DispersionDM")
        if starts("DMX_"):
            chosen.append("DispersionDMX")
        if has("DMJUMP"):
            chosen.append("DispersionJump")
        if has("JUMP"):
            chosen.append("PhaseJump")
        if has("TZRMJD"):
            chosen.append("AbsPhase")
        if has("PHOFF"):
            chosen.append("PhaseOffset")
        if has("NE_SW", "NE1AU", "SOLARN0") and "SolarWindDispersion" in t:
            chosen.append("SolarWindDispersion")
        if starts("SWXDM_") and "SolarWindDispersionX" in t:
            chosen.append("SolarWindDispersionX")
        if (has("CM", "TNCHROMIDX")
                or any(k.startswith("CM") and k[2:].isdigit() for k in keys)) \
                and "ChromaticCM" in t:
            chosen.append("ChromaticCM")
        if starts("CMX_") and "ChromaticCMX" in t:
            chosen.append("ChromaticCMX")
        if (starts("GLEP_") or starts("GLF0_")) and "Glitch" in t:
            chosen.append("Glitch")
        if has("WAVE_OM") and "Wave" in t:
            chosen.append("Wave")
        if (has("WXEPOCH") or starts("WXSIN_")) and "WaveX" in t:
            chosen.append("WaveX")
        if (has("DMWXEPOCH") or starts("DMWXSIN_")) and "DMWaveX" in t:
            chosen.append("DMWaveX")
        if (has("CMWXEPOCH") or starts("CMWXSIN_")) and "CMWaveX" in t:
            chosen.append("CMWaveX")
            # TNCHROMIDX lives on ChromaticCM
            if "ChromaticCM" not in chosen and "ChromaticCM" in t:
                chosen.append("ChromaticCM")
        if any(k.startswith("FD") and k[2:].isdigit() for k in keys) \
                and "FD" in t:
            chosen.append("FD")
        if starts("FDJUMPDM") and "FDJumpDM" in t:
            chosen.append("FDJumpDM")
        if any(k.startswith("FD") and "JUMP" in k
               and not k.startswith("FDJUMPDM") for k in keys) \
                and "FDJump" in t:
            chosen.append("FDJump")
        if has("SIFUNC") and "IFunc" in t:
            chosen.append("IFunc")
        if has("CORRECT_TROPOSPHERE") and "TroposphereDelay" in t:
            # always attached: its CORRECT_TROPOSPHERE bool gates the delay
            chosen.append("TroposphereDelay")
        for names, comp in (
                (("EFAC", "T2EFAC", "EQUAD", "T2EQUAD", "TNEQ"),
                 "ScaleToaError"),
                (("DMEFAC", "DMEQUAD"), "ScaleDmError"),
                (("ECORR", "TNECORR"), "EcorrNoise"),
                (("RNAMP", "TNREDAMP"), "PLRedNoise"),
                (("TNDMAMP",), "PLDMNoise"),
                (("TNCHROMAMP",), "PLChromNoise"),
                (("TNSWAMP",), "PLSWNoise")):
            if has(*names) and comp in t:
                chosen.append(comp)
        if "BINARY" in keys:
            chosen.append(self.binary_component_for(
                entries["BINARY"][0].value, keys, allow_T2=allow_T2))
        if starts("PWF0_") and "PiecewiseSpindown" in t:
            chosen.append("PiecewiseSpindown")
        return chosen

    def binary_component_for(self, binary_name: str, keys=(),
                             allow_T2: bool = False) -> str:
        want = f"Binary{binary_name}"
        if want in self.templates:
            return want
        # case-insensitive (par files write ELL1K for ELL1k)
        for t in self.templates:
            if t.lower() == want.lower():
                return t
        if binary_name.upper() == "T2":
            if not allow_T2:
                raise UnknownBinaryModel(
                    "BINARY T2 is not directly supported; pass allow_T2=True "
                    "to substitute the closest implemented model")
            guess = self.guess_t2_model(keys)
            log.warning(f"BINARY T2 approximated by {guess} (allow_T2)")
            return guess
        available = sorted(t for t in self.templates if t.startswith("Binary"))
        raise UnknownBinaryModel(
            f"BINARY {binary_name} is not supported (available: {available})")

    @staticmethod
    def guess_t2_model(keys) -> str:
        """The implemented binary closest to a tempo2 ``T2`` binary, from
        the parameters present (reference ``model_builder.py:181``)."""
        keys = set(keys)
        if "EPS1" in keys or "TASC" in keys:
            if "H3" in keys or "H4" in keys or "STIGMA" in keys:
                return "BinaryELL1H"
            if "LNEDOT" in keys:
                return "BinaryELL1k"
            return "BinaryELL1"
        if "KIN" in keys or "KOM" in keys:
            return "BinaryDDK"
        if "SHAPMAX" in keys:
            return "BinaryDDS"
        if "MTOT" in keys:
            return "BinaryDDGR"
        if "H3" in keys or "STIGMA" in keys:
            return "BinaryDDH"
        if "OMDOT" in keys or "M2" in keys or "GAMMA" in keys:
            return "BinaryDD"
        return "BinaryBT"

    # -- main (reference ``model_builder.py:208-270``) ---------------------
    def _read(self, parfile, allow_tcb: bool = False,
              allow_T2: bool = False) -> _HostModel:
        """The par file read into component templates, set up, validated
        and (``allow_tcb=True``) converted to TDB: the host half of
        :meth:`__call__`."""
        entries = parse_parfile(parfile) if not isinstance(parfile, dict) \
            else parfile
        tm = _HostModel()
        for cname in self.choose_components(entries, allow_T2=allow_T2):
            tm.add_component(Component.component_types[cname].template())
        used: set = set()
        for key, rows in entries.items():  # top-level parameters first
            for p in tm.top_level_params:
                if tm._top_params_dict[p].name_matches(key):
                    tm._top_params_dict[p].from_parfile_fields(rows[0].fields)
                    used.add(key)
                    break
        for key, rows in entries.items():
            if key in used or key in IGNORE_PARAMS \
                    or any(key.startswith(pre) for pre in IGNORE_PREFIX):
                continue
            if self._assign(tm, key, rows):
                used.add(key)
                continue
            log.warning(f"Unrecognized parfile line: {key} {rows[0].fields}")
            diags = getattr(entries, "diagnostics", None)
            if diags is not None:
                diags.warning("par-unknown-param",
                              f"unknown parameter {key} {rows[0].fields}",
                              line=getattr(rows[0], "line", None), quiet=True)
        for comp in tm.components.values():
            comp.setup()
        # True converts the model to TDB, "raw" keeps the TCB model as it
        # is, False refuses it (reference ``model_builder.py:139,168``)
        if allow_tcb not in (True, False, "raw"):
            raise ValueError("allow_tcb must be True, False, or 'raw'")
        tm.validate(allow_tcb=allow_tcb in (True, "raw"))
        if allow_tcb is True and (tm.UNITS.value or "").upper() == "TCB":
            from pint_torch.models.tcb_conversion import convert_tcb_tdb

            convert_tcb_tdb(tm)
        return tm

    def __call__(self, parfile, allow_tcb: bool = False,
                 allow_T2: bool = False, device=None) -> TimingModel:
        from pint_torch import resolve_device

        dev = resolve_device(device)
        tm = self._read(parfile, allow_tcb=allow_tcb, allow_T2=allow_T2)
        params: Dict[str, Param] = {}
        for n in tm.top_level_params:
            par = tm._top_params_dict[n]
            params[n] = _record(par, "TimingModel")
            params[n].value = _top_value(par)
        comps = []
        for name, comp in tm.components.items():
            comp.finish_config()
            for n in comp.params:
                params[n] = _record(comp._params_dict[n], name)
            del comp.__dict__["_params_dict"]
            comp.params = []
            comp._parent = None
            comps.append(comp)
        return TimingModel(tm.PSR.value or "", comps, params, dev)

    def _assign(self, tm: _HostModel, key: str, rows: List[ParLine]) -> bool:
        # 1. a name or alias of some component's parameter
        for comp in tm.components.values():
            hit = comp.match_param_alias(key)
            if hit is not None:
                par = comp._params_dict[hit]
                if isinstance(par, maskParameter):
                    self._assign_masks(comp, par, rows)
                else:
                    par.from_parfile_fields(rows[0].fields)
                return True
        # 2. prefix-family growth (F2, DMX_0002, ...)
        try:
            prefix, index = split_prefixed_name(key)
        except Exception:
            return False
        for comp in tm.components.values():
            exemplar = next(
                (par for par in (comp._params_dict[p] for p in comp.params)
                 if (isinstance(par, prefixParameter)
                     or (isinstance(par, pairParameter) and par.index >= 0))
                 and par.prefix == prefix), None)
            if exemplar is not None:
                newp = exemplar.new_param(index)
                newp.name = key
                newp.index = index
                newp.from_parfile_fields(rows[0].fields)
                comp.add_param(newp)
                return True
        return False

    def _assign_masks(self, comp, exemplar: maskParameter,
                      rows: List[ParLine]) -> None:
        """Each repeated mask line becomes its own indexed parameter, in
        file order."""
        for i, ln in enumerate(rows):
            if i == 0 and exemplar.value in (None, 0.0) and not exemplar.key:
                target = exemplar
            else:
                target = exemplar.new_param(
                    index=self._next_mask_index(comp, exemplar))
                comp.add_param(target)
            target.from_parfile_fields(ln.fields)

    @staticmethod
    def _next_mask_index(comp, exemplar) -> int:
        idxs = [comp._params_dict[p].index for p in comp.params
                if isinstance(comp._params_dict[p], maskParameter)
                and comp._params_dict[p].origin_name == exemplar.origin_name]
        return max(idxs) + 1 if idxs else 1


def get_model(parfile, allow_tcb: bool = False, allow_T2: bool = False,
              device=None) -> TimingModel:
    """The timing model of a par file (a path, par text or an iterable of
    lines) on ``device`` (default ``"cuda"``; reference
    ``model_builder.py:320``)."""
    return ModelBuilder()(parfile, allow_tcb=allow_tcb, allow_T2=allow_T2,
                          device=device)


def get_model_and_toas(parfile, timfile, ephem=None, planets=None,
                       include_bipm=None, allow_tcb=False, allow_T2=False,
                       **kw):
    """The model of ``parfile`` on ``device`` (a keyword, default
    ``"cuda"``) and the host TOAs of ``timfile`` read under its settings
    (reference ``model_builder.py:325``); the other keywords go to
    :func:`~pint_torch.toa.get_TOAs`.  ``toas.to_batch(model=model)``
    moves the TOAs to the device."""
    from pint_torch.toa import get_TOAs

    model = get_model(parfile, allow_tcb=allow_tcb, allow_T2=allow_T2,
                      device=kw.pop("device", None))
    toas = get_TOAs(timfile, model=model, ephem=ephem,
                    planets=planets if planets is not None else False,
                    include_bipm=include_bipm, **kw)
    return model, toas


def guess_binary_model(parfile_dict) -> list:
    """Priority-ordered binary-model guesses for a parsed par-file dict
    (reference ``model_builder.py:34``); the first is the best."""
    keys = {str(k).upper() for k in parfile_dict}
    best = ModelBuilder.guess_t2_model(keys)
    order = ["BinaryELL1H", "BinaryELL1k", "BinaryELL1", "BinaryDDK",
             "BinaryDDS", "BinaryDDGR", "BinaryDDH", "BinaryDD", "BinaryBT"]
    ranked = [best] + [m for m in order if m != best]
    return [m[len("Binary"):] for m in ranked]


def convert_binary_params_dict(parfile_dict, convert_komkin: bool = True,
                               drop_ddk_sini: bool = True,
                               force_binary_model: "str | None" = None):
    """Rewrite a parsed par-file dict's BINARY line to the best-guess
    supported model (reference ``model_builder.py:340``): an unsupported
    binary (T2) becomes the first of :func:`guess_binary_model`; for DDK
    the KIN/KOM angles move between the IAU and DT92 conventions and SINI
    is dropped.  Takes :func:`parse_parfile`'s output or a plain
    {KEY: [value string]} mapping, edits it in place and returns it."""

    def _get(key):
        rows = parfile_dict.get(key)
        if not rows:
            return None
        row = rows[0]
        return " ".join(row.fields) if isinstance(row, ParLine) else str(row)

    def _set(key, value_str: str):
        rows = parfile_dict.get(key)
        if rows and isinstance(rows[0], ParLine):
            parfile_dict[key] = [ParLine(key, value_str.split())]
        else:
            parfile_dict[key] = [value_str]

    binary = _get("BINARY")
    if not binary:
        return parfile_dict
    binary = binary.split()[0]
    if not force_binary_model and f"Binary{binary}" in \
            Component.component_types:
        return parfile_dict
    if force_binary_model:
        guesses = [force_binary_model]
    else:
        guesses = guess_binary_model(parfile_dict)
        log.info(f"Compatible binary models: {', '.join(guesses)}; "
                 f"using {guesses[0]}")
    _set("BINARY", guesses[0])
    if convert_komkin:
        # IAU <-> DT92: KIN' = 180 - KIN, KOM' = 90 - KOM
        for key, zero in (("KIN", 180.0), ("KOM", 90.0)):
            val = _get(key)
            if val is not None:
                fields = val.split()
                fields[0] = repr(zero - float(fields[0]))
                _set(key, " ".join(fields))
    if drop_ddk_sini and guesses[0] == "DDK":
        if parfile_dict.pop("SINI", None) is not None:
            log.info("Dropped SINI from the DDK model (derived from KIN)")
    return parfile_dict


class AllComponents:
    """One valueless template of every registered component, for
    parameter searching (reference ``timing_model.py:1739``)."""

    def __init__(self):
        self.components: Dict[str, Component] = {
            k: v.template() for k, v in Component.component_types.items()}

    @property
    def param_component_map(self) -> Dict[str, List[str]]:
        """{parameter name: [component names]} (aliases excluded)."""
        out: Dict[str, List[str]] = {}
        for cname, comp in self.components.items():
            for p in comp.params:
                out.setdefault(p, []).append(cname)
        return out

    @property
    def component_category_map(self) -> Dict[str, str]:
        return {k: c.category for k, c in self.components.items()}

    @property
    def category_component_map(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for k, c in self.components.items():
            out.setdefault(c.category, []).append(k)
        return out

    @property
    def component_unique_params(self) -> Dict[str, List[str]]:
        """{component: parameters no other component hosts}."""
        p2c = self.param_component_map
        return {k: [p for p in c.params if len(p2c[p]) == 1]
                for k, c in self.components.items()}

    def param_to_unit(self, name: str) -> str:
        """The unit of a parameter or alias."""
        for comp in self.components.values():
            hit = comp.match_param_alias(name)
            if hit is not None:
                return comp._params_dict[hit].units
        pint_name, _ = self.alias_to_pint_param(name)
        prefix, _i = split_prefixed_name(pint_name)
        for comp in self.components.values():
            for p in comp.params:
                if p.startswith(prefix):
                    return comp._params_dict[p].units
        raise ValueError(f"Unknown parameter {name!r}")

    def repeatable_param(self) -> set:
        """Names (and aliases) of the repeatable parameter families."""
        out = set()
        for comp in self.components.values():
            for p in comp.params:
                par = comp._params_dict[p]
                if getattr(par, "repeatable", False):
                    out.add(getattr(par, "prefix", par.name))
                    out.update(a.rstrip("0123456789") if a[-1:].isdigit()
                               else a for a in par.aliases)
        return out

    def search_binary_components(self, system_name: str) -> Component:
        key = f"Binary{system_name}"
        if key in self.components:
            return self.components[key]
        raise UnknownBinaryModel(f"Unknown binary model {system_name!r}")

    def alias_to_pint_param(self, alias: str) -> Tuple[str, str]:
        """(parameter name, the alias) of an alias, prefix and mask indices
        resolved (``T2EFAC2`` -> ``EFAC2``)."""
        from pint_torch.exceptions import PrefixError

        for comp in self.components.values():
            hit = comp.match_param_alias(alias)
            if hit is not None:
                return hit, alias
        try:
            prefix, index = split_prefixed_name(alias)
        except (ValueError, PrefixError):
            raise ValueError(f"{alias!r} is not a parameter or alias")
        if index >= 0:
            for comp in self.components.values():
                hit = comp.match_param_alias(prefix) \
                    or comp.match_param_alias(prefix + "1")
                if hit is not None:
                    base, _ = split_prefixed_name(hit) \
                        if hit[-1].isdigit() else (hit, -1)
                    return f"{base}{index}", alias
        raise ValueError(f"{alias!r} is not a parameter or alias")

