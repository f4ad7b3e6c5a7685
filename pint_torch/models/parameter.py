"""Typed model parameters (port of ``pint_tpu/models/parameter.py``).

Values are stored in canonical par-file units as plain floats (F0 in Hz,
DM in pc/cm^3, PMRA in mas/yr, JUMP in s, angles in **radians**, epochs as
numpy longdouble MJD).  No astropy Quantities: the unit is metadata used at
the par-file boundary and for display.  The model builder turns each into
the port's :class:`~pint_torch.models.timing_model.Param` record (an epoch
as the exact (hi, lo) pair of its longdouble).

Parameter kinds: float/str/bool/int/MJD/Angle plus
* :class:`prefixParameter` — indexed families (F0, F1, ..., DMX_0001),
* :class:`maskParameter` — parameters selecting TOA subsets
  (JUMP -fe 430, EFAC -f L-wide, DMX ranges) with host-side mask resolution,
* :class:`pairParameter`, :class:`funcParameter` for completeness.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

import numpy as np

from pint_torch.exceptions import PrefixError
from pint_torch.io.par import fortran_float

__all__ = [
    "Parameter",
    "floatParameter",
    "strParameter",
    "boolParameter",
    "intParameter",
    "MJDParameter",
    "AngleParameter",
    "prefixParameter",
    "maskParameter",
    "pairParameter",
    "funcParameter",
    "split_prefixed_name",
]

_PREFIX_RE = re.compile(r"^([A-Za-z][A-Za-z0-9_]*?_?)(\d+)$")


def split_prefixed_name(name: str):
    """Split 'F12' -> ('F', 12), 'DMX_0001' -> ('DMX_', 1); raise otherwise."""
    m = _PREFIX_RE.match(name)
    if m is None:
        raise PrefixError(f"Not a prefixed parameter name: {name!r}")
    return m.group(1), int(m.group(2))


def parse_angle(s: str, is_ra: bool = False) -> float:
    """Parse 'hh:mm:ss.s' / 'dd:mm:ss.s' / decimal degrees -> radians."""
    s = s.strip()
    if ":" in s:
        sign = -1.0 if s.lstrip().startswith("-") else 1.0
        parts = s.lstrip("+-").split(":")
        val = abs(float(parts[0]))
        if len(parts) > 1:
            val += float(parts[1]) / 60.0
        if len(parts) > 2:
            val += float(parts[2]) / 3600.0
        val *= sign
        deg = val * 15.0 if is_ra else val
    else:
        deg = fortran_float(s)
        if is_ra and abs(deg) <= 24.0 and ":" not in s:
            # bare number for RA is in hours by tempo convention
            deg = deg * 15.0
    return deg * np.pi / 180.0


def format_angle(rad: float, is_ra: bool = False, ndp: int = 8) -> str:
    deg = rad * 180.0 / np.pi
    if is_ra:
        hours = deg / 15.0 % 24.0
        h = int(hours)
        m = int((hours - h) * 60)
        s = (hours - h - m / 60.0) * 3600.0
        return f"{h:02d}:{m:02d}:{s:0{3 + ndp}.{ndp}f}"
    sign = "-" if deg < 0 else ""
    deg = abs(deg)
    d = int(deg)
    m = int((deg - d) * 60)
    s = (deg - d - m / 60.0) * 3600.0
    return f"{sign}{d:d}:{m:02d}:{s:0{3 + ndp}.{ndp}f}"


class Parameter:
    """Base parameter: name, value, units metadata, frozen flag, aliases."""

    def __init__(self, name: str, value=None, units: str = "", description: str = "",
                 frozen: bool = True, aliases: Optional[List[str]] = None,
                 uncertainty=None, continuous: bool = True, **kw):
        self.name = name
        self.units = units
        self.description = description
        self.frozen = frozen
        self.aliases = aliases or []
        self.uncertainty = uncertainty
        self.continuous = continuous
        self.value = value
        self.use_alias = None  # output name override (use_aliases)
        self._component = None  # set by Component.add_param
        self._prior = None  # lazily defaults to the unbounded uniform

    @property
    def prior(self):
        """Prior distribution for Bayesian inference (reference
        ``parameter.py`` prior hook); defaults to an improper flat prior."""
        if self._prior is None:
            from pint_torch.models.priors import Prior, UniformUnboundedRV

            self._prior = Prior(UniformUnboundedRV())
        return self._prior

    @prior.setter
    def prior(self, p):
        self._prior = p

    def prior_pdf(self, value=None, logpdf: bool = False):
        v = self.value if value is None else value
        return self.prior.logpdf(v) if logpdf else self.prior.pdf(v)

    # -- par-file boundary -------------------------------------------------
    def str2value(self, s: str):
        return fortran_float(s)

    def value2str(self, v) -> str:
        return repr(v)

    def from_parfile_fields(self, fields: List[str]):
        """Set value/fit/uncertainty from raw par-file fields."""
        if not fields:
            return
        self.value = self.str2value(fields[0])
        if len(fields) >= 2:
            f1 = fields[1]
            if f1 in ("0", "1"):
                self.frozen = f1 != "1"
                if len(fields) >= 3:
                    try:
                        self.uncertainty = self.str2value(fields[2])
                    except ValueError:
                        pass
            else:
                try:
                    self.uncertainty = self.str2value(f1)
                except ValueError:
                    pass

    #: spelling swaps for tempo/tempo2 output (reference ``parameter.py:471``)
    _FORMAT_RENAME = {"A1DOT": "XDOT", "STIGMA": "VARSIGMA"}
    #: PINT-only parameters dropped from tempo/tempo2 output
    _PINT_ONLY = {"DMRES", "SWM", "SWP"}

    def as_parfile_line(self, format: str = "pint") -> str:
        fmt = format.lower()
        if fmt not in ("pint", "tempo", "tempo2"):
            raise ValueError(f"parfile format must be pint/tempo/tempo2, "
                             f"not {format!r}")
        if self.value is None:
            return ""
        name, value = self.use_alias or self.name, self.value
        if fmt != "pint":
            if name in self._PINT_ONLY:
                return ""
            name = self._FORMAT_RENAME.get(name, name)
        if fmt == "tempo" and self.name in ("KIN", "KOM"):
            # DT92 -> IAU convention (reference ``parameter.py:497-505``)
            value = (180.0 if self.name == "KIN" else 90.0) - value
        if fmt == "tempo2" and self.name == "ECL" and value != "IERS2003":
            # tempo2 only implements the IERS2003 ecliptic
            value = "IERS2003"
        line = f"{name:<15} {self.value2str(value):>25}"
        if not self.frozen:
            line += " 1"
        if self.uncertainty is not None:
            if self.frozen:
                line += " 0"
            line += f" {self.value2str(self.uncertainty)}"
        if fmt == "tempo2" and self.name == "T2CMETHOD":
            line = "#" + line
        return line + "\n"

    @property
    def quantity(self):
        return self.value

    @property
    def uncertainty_value(self):
        """Bare-float uncertainty (reference ``parameter.py`` exposes both a
        Quantity ``uncertainty`` and this float view; here both are floats)."""
        return self.uncertainty

    @uncertainty_value.setter
    def uncertainty_value(self, v):
        self.uncertainty = v

    #: can this parameter appear multiple times in a par file?
    #: (mask/prefix subclasses override; reference ``parameter.py repeatable``)
    repeatable = False

    def add_alias(self, alias: str) -> None:
        """Register an extra input alias (reference
        ``parameter.py add_alias``)."""
        if alias not in self.aliases:
            self.aliases.append(alias)

    def from_parfile_line(self, line: str) -> bool:
        """Parse one par-file line into this parameter; returns False when
        the key does not match (reference ``parameter.py
        from_parfile_line``)."""
        fields = line.split()
        if not fields or not self.name_matches(fields[0]):
            return False
        self.from_parfile_fields(fields[1:])
        return True

    def set(self, value) -> None:
        """Set the value from a string or number (reference
        ``parameter.py Parameter.set``)."""
        self.value = self.str2value(value) if isinstance(value, str) \
            else value

    def str_quantity(self, quantity) -> str:
        """Reference spelling for :meth:`value2str`."""
        return self.value2str(quantity)

    def help_line(self) -> str:
        """One-line help (reference ``parameter.py help_line``)."""
        out = f"{self.name:<15} {self.description or ''}"
        if self.units:
            out += f" ({self.units})"
        return out

    def __repr__(self):
        fit = "" if self.frozen else " fit"
        return f"{type(self).__name__}({self.name}={self.value}{fit})"

    def name_matches(self, key: str) -> bool:
        key = key.upper()
        return key == self.name.upper() or key in (a.upper() for a in self.aliases)


class floatParameter(Parameter):
    """Float parameter; optional tempo-style unit scaling: par values with
    magnitude above ``scale_threshold`` are multiplied by ``scale_factor``
    (e.g. XDOT given in 1e-12 ls/s; reference ``parameter.py`` unit_scale).
    """

    def __init__(self, *a, unit_scale: bool = False, scale_factor: float = 1e-12,
                 scale_threshold: float = 1e-7, **kw):
        self.unit_scale = unit_scale
        self.scale_factor = scale_factor
        self.scale_threshold = scale_threshold
        super().__init__(*a, **kw)

    def str2value(self, s):
        v = fortran_float(s)
        if self.unit_scale and abs(v) > self.scale_threshold:
            v *= self.scale_factor
        return v

    def value2str(self, v):
        # shortest string that round-trips the float64 exactly (%.15g can
        # drop the 16th digit: an F0 ulp is ~2e-5 cycles over a decade span)
        return repr(float(v))


class strParameter(Parameter):
    def str2value(self, s):
        return s

    def value2str(self, v):
        return str(v)


class boolParameter(Parameter):
    def str2value(self, s):
        return s.upper() in ("Y", "YES", "T", "TRUE", "1")

    def value2str(self, v):
        return "Y" if v else "N"


class intParameter(Parameter):
    def str2value(self, s):
        return int(float(s))

    def value2str(self, v):
        return str(int(v))


class MJDParameter(Parameter):
    """Epoch parameter: value is numpy longdouble MJD (full precision)."""

    def __init__(self, *a, **kw):
        kw.setdefault("units", "MJD")
        super().__init__(*a, **kw)

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        # reference parity: ``model.PEPOCH.value = "54500.0001"`` parses at
        # full longdouble precision
        self._value = self.str2value(v) if isinstance(v, str) else v

    def str2value(self, s):
        return np.longdouble(s.translate(str.maketrans("Dd", "Ee")))

    def value2str(self, v):
        return str(np.longdouble(v))

    @property
    def value_float(self) -> float:
        return float(self.value) if self.value is not None else None


class AngleParameter(Parameter):
    """Angle parameter stored in radians; par IO in h:m:s or d:m:s."""

    def __init__(self, *a, angle_type: str = "dms", **kw):
        self.angle_type = angle_type  # 'hms' (RA), 'dms' (DEC), 'deg', 'rad'
        kw.setdefault("units", {"hms": "hourangle", "dms": "deg"}.get(angle_type, angle_type))
        super().__init__(*a, **kw)

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        # reference parity: ``model.RAJ.value = "04:37:15.9"`` parses
        self._value = self.str2value(v) if isinstance(v, str) else v

    def str2value(self, s):
        if self.angle_type == "hms":
            return parse_angle(s, is_ra=True)
        if self.angle_type == "dms":
            return parse_angle(s, is_ra=False)
        if self.angle_type == "deg":
            return fortran_float(s) * np.pi / 180.0
        return fortran_float(s)

    def value2str(self, v):
        if self.angle_type == "hms":
            return format_angle(v, is_ra=True)
        if self.angle_type == "dms":
            return format_angle(v, is_ra=False)
        if self.angle_type == "deg":
            return f"{v * 180.0 / np.pi:.13f}"
        return f"{v:.15g}"

    def from_parfile_fields(self, fields):
        # uncertainties on angles come in arcsec (dms) / s-of-time (hms)
        if not fields:
            return
        self.value = self.str2value(fields[0])
        rest = fields[1:]
        if rest and rest[0] in ("0", "1"):
            self.frozen = rest[0] != "1"
            rest = rest[1:]
        if rest:
            try:
                err = fortran_float(rest[0])
                scale = np.pi / (180.0 * 3600.0)
                if self.angle_type == "hms":
                    scale *= 15.0
                self.uncertainty = err * scale
            except ValueError:
                pass


class prefixParameter(floatParameter):
    """One member of an indexed family (F2, DMX_0017, GLF0_2...).

    ``prefix`` and ``index`` are derived from the name; components create new
    members on demand while reading par files (reference ``parameter.py:1063``).
    """

    def __init__(self, name: str, *a, **kw):
        self.prefix, self.index = split_prefixed_name(name)
        self.unit_template: Optional[Callable[[int], str]] = kw.pop("unit_template", None)
        self.description_template = kw.pop("description_template", None)
        super().__init__(name, *a, **kw)

    def new_param(self, index: int, **overrides) -> "prefixParameter":
        if self.index >= 0 and "_" in self.prefix:
            nm = f"{self.prefix}{index:04d}"
        else:
            nm = f"{self.prefix}{index}"
        kw = dict(units=self.units, description=self.description, frozen=True)
        kw.update(overrides)
        p = prefixParameter(nm, **kw)
        if self.unit_template:
            p.units = self.unit_template(index)
        return p


class maskParameter(floatParameter):
    """Parameter applying to a flag/observatory/MJD/frequency-selected TOA
    subset (reference ``parameter.py:1433``).

    Par syntax: ``JUMP -fe 430 0.0 1`` or ``JUMP MJD 57000 57100 0.0`` etc.
    ``select_toa_mask(toas)`` resolves to integer indices on the host; the
    components' host contexts hold the masks.
    """

    repeatable = True

    def __init__(self, name: str, index: int = 1, key: Optional[str] = None,
                 key_value: Optional[list] = None, **kw):
        self.prefix = name
        self.index = index
        self.key = key
        self.key_value = list(key_value) if key_value else []
        self.origin_name = name
        super().__init__(f"{name}{index}", **kw)

    def from_parfile_fields(self, fields: List[str]):
        # forms: [key, key_value..., value, (fit), (uncertainty)]
        if not fields:
            return
        key = fields[0].lower()
        if key.startswith("-"):
            self.key = key
            self.key_value = [fields[1]]
            rest = fields[2:]
        elif key in ("mjd", "freq"):
            self.key = key
            self.key_value = [fortran_float(fields[1]), fortran_float(fields[2])]
            rest = fields[3:]
        elif key in ("tel", "name"):
            self.key = key
            self.key_value = [fields[1]]
            rest = fields[2:]
        else:
            # tempo-style "JUMP value" with no selector (rare; tim-file jumps)
            self.key = None
            rest = fields
        if rest:
            self.value = self.str2value(rest[0])
            rest = rest[1:]
        if rest and rest[0] in ("0", "1"):
            self.frozen = rest[0] != "1"
            rest = rest[1:]
        if rest:
            try:
                self.uncertainty = self.str2value(rest[0])
            except ValueError:
                pass

    def as_parfile_line(self, format: str = "pint") -> str:
        if self.value is None:
            return ""
        if self.key is None:
            sel = ""
        elif self.key in ("mjd", "freq"):
            sel = f" {self.key.upper()} {self.key_value[0]} {self.key_value[1]}"
        elif self.key in ("tel", "name"):
            sel = f" {self.key.upper()} {self.key_value[0]}"
        else:
            sel = f" {self.key} {' '.join(str(v) for v in self.key_value)}"
        line = f"{self.origin_name}{sel} {self.value2str(self.value)}"
        if not self.frozen:
            line += " 1"
        if self.uncertainty is not None:
            line += f" {self.value2str(self.uncertainty)}"
        return line + "\n"

    def select_toa_mask(self, toas) -> np.ndarray:
        """Integer indices of the TOAs this parameter applies to."""
        from pint_torch.toa import select_toa_mask

        return select_toa_mask(self, toas)

    def name_matches(self, key: str) -> bool:
        # a bare par-file key ("EFAC", "JUMP") matches the indexed exemplar
        key = key.upper()
        if key == self.origin_name.upper() or key == self.name.upper():
            return True
        return key in (a.upper() for a in self.aliases)

    def compare_key_value(self, other_param) -> bool:
        """True when this mask selects the same TOAs as ``other_param``
        (same key and key values, order-insensitive; reference
        ``parameter.py:2170``)."""
        if getattr(other_param, "key", None) is None and self.key is None:
            return True
        if (self.key or "").lstrip("-") != \
                (getattr(other_param, "key", "") or "").lstrip("-"):
            return False
        return sorted(map(str, self.key_value)) == \
            sorted(map(str, getattr(other_param, "key_value", [])))

    def new_param(self, index: int, **overrides) -> "maskParameter":
        kw = dict(units=self.units, description=self.description, frozen=True,
                  aliases=list(self.aliases))
        kw.update(overrides)
        return maskParameter(self.origin_name, index=index, **kw)


class pairParameter(floatParameter):
    """Parameter whose value is a pair of floats (reference ``parameter.py:1781``).

    Pairs that end in digits (WAVE1, IFUNC3) form prefix families the model
    builder grows on demand, like :class:`prefixParameter`."""

    def __init__(self, name: str, *a, **kw):
        try:
            self.prefix, self.index = split_prefixed_name(name)
        except Exception:
            self.prefix, self.index = name, -1
        super().__init__(name, *a, **kw)

    def str2value(self, s):
        return [fortran_float(x) for x in s.split()]

    def from_parfile_fields(self, fields):
        if len(fields) >= 2:
            self.value = [fortran_float(fields[0]), fortran_float(fields[1])]

    def value2str(self, v):
        return f"{v[0]:.15g} {v[1]:.15g}"

    def new_param(self, index: int, **overrides) -> "pairParameter":
        kw = dict(units=self.units, description=self.description, frozen=True,
                  continuous=self.continuous)
        kw.update(overrides)
        return pairParameter(f"{self.prefix}{index}", **kw)


class funcParameter(floatParameter):
    """Read-only parameter computed live from other model parameters
    (reference ``parameter.py:2372``).

    ``params`` are resolved through the host component's parent model at
    read time, so ``.value``/``.quantity`` always reflect the current
    state; the value is ``None`` while unattached or while any source is
    unset.  With ``inpar=False`` (the default) the par-file line is
    written commented out.
    """

    def __init__(self, name: str, func: Callable = None, params=(),
                 inpar: bool = False, **kw):
        self.func = func
        self.source_params = [p if isinstance(p, str) else p[0]
                              for p in params]
        self.inpar = inpar
        super().__init__(name, **kw)
        self.frozen = True

    def _host_model(self):
        comp = getattr(self, "_component", None)
        return getattr(comp, "_parent", None) if comp is not None else None

    @property
    def value(self):
        model = self._host_model()
        if model is None or self.func is None:
            return None
        try:
            vals = [getattr(model, p).value for p in self.source_params]
        except AttributeError:
            return None
        if any(v is None for v in vals):
            return None
        return self.func(*(float(v) for v in vals))

    @value.setter
    def value(self, v):
        if v is not None:
            raise ValueError(
                f"funcParameter {self.name} is read-only (computed from "
                f"{self.source_params})")

    def as_parfile_line(self, format: str = "pint") -> str:
        line = super().as_parfile_line(format)
        if line and not self.inpar:
            line = "# " + line
        return line

    def evaluate(self, model):
        """Explicit evaluation against a given model (no attachment needed)."""
        vals = [getattr(model, p).value for p in self.source_params]
        return self.func(*vals) if self.func else None
