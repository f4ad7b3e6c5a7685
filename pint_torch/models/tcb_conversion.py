"""TCB <-> TDB conversion of timing models (port of
``pint_tpu/models/tcb_conversion.py``).

The same Irwin & Fukushima 1999 constants as tempo2: parameters scale by
IFTE_K to the power of their effective time dimensionality; epochs
transform linearly about IFTE_MJD0.  The conversion is approximate -- re-fit
afterwards (the reference's caveat).  It acts on a model being read from
par text (the builder's, whose epochs are longdoubles) or on a built
:class:`~pint_torch.models.timing_model.TimingModel` (whose epochs are
exact (hi, lo) pairs), through ``model[name]``.
"""

from __future__ import annotations

import re

import numpy as np

from pint_torch.logging import log
from pint_torch.models.parameter import AngleParameter, MJDParameter

__all__ = ["IFTE_K", "IFTE_MJD0", "scale_parameter",
           "transform_mjd_parameter", "convert_tcb_tdb"]

IFTE_MJD0 = np.longdouble("43144.0003725")
IFTE_KM1 = np.longdouble("1.55051979176e-8")
IFTE_K = np.longdouble(1.0) + IFTE_KM1

#: effective dimensionality rules: exact names, then regex families.
#: The table lists each parameter's frequency-dimensionality (F0 -> 1,
#: F1 -> 2, A1 -> -1 because it enters as a time).  TCB seconds are shorter
#: than TDB seconds by IFTE_K, so frequencies grow under TCB->TDB:
#: x_tdb = x_tcb * K^dim (equivalently x_tcb / K^n with n the
#: time-dimensionality, reference ``tcb_conversion.py`` +
#: ``docs/tcb2tdb-factors.rst``): F0 and DM multiply by K, A1 divides by K.
_EXACT_DIM = {
    "PX": 1, "PMRA": 1, "PMDEC": 1, "PMELONG": 1, "PMELAT": 1,
    "A1": -1, "PB": -1, "OMDOT": 1, "EDOT": 1, "M2": -1, "MTOT": -1,
    "GAMMA": -1, "EPS1DOT": 1, "EPS2DOT": 1, "H3": -1, "H4": -1,
    "NE_SW": 1, "GLTD": -1,
    # dimensionless / angles / unscaled
    "ECC": 0, "OM": 0, "EPS1": 0, "EPS2": 0, "SINI": 0, "SHAPMAX": 0,
    "STIGMA": 0, "KIN": 0, "KOM": 0, "PBDOT": 0, "XPBDOT": 0, "A1DOT": 0,
    "RAJ": 0, "DECJ": 0, "ELONG": 0, "ELAT": 0, "GLPH": 0, "LNEDOT": 0,
}
_FAMILY_DIM = [
    (re.compile(r"^F(\d+)$"), lambda n: n + 1),
    (re.compile(r"^FB(\d+)$"), lambda n: n + 1),
    (re.compile(r"^DM(\d*)$"), lambda n: (n or 0) + 1),
    (re.compile(r"^DMX_\d+$"), lambda n: 1),
    (re.compile(r"^CM(\d*)$"), lambda n: (n or 0) + 1),
    (re.compile(r"^GLF0D?_\d+$"), lambda n: 1),
    (re.compile(r"^GLF1_\d+$"), lambda n: 2),
    (re.compile(r"^GLF2_\d+$"), lambda n: 3),
    (re.compile(r"^JUMP\d*$"), lambda n: -1),
    (re.compile(r"^NE_SW(\d+)$"), lambda n: n + 1),
]


def _effective_dim(name: str):
    if name in _EXACT_DIM:
        return _EXACT_DIM[name]
    for pat, fn in _FAMILY_DIM:
        m = pat.match(name)
        if m:
            g = m.groups()[0] if m.groups() else None
            return fn(int(g) if g else None)
    return None


def _is(par, cls) -> bool:
    """``par`` is a ``cls`` parameter: the builder's object or a built
    model's :class:`Param` read as one."""
    return isinstance(par, cls) or getattr(par, "ptype", None) \
        == cls.__name__ or (cls is MJDParameter
                            and getattr(par, "kind", None) == "mjd")


def scale_parameter(model, param: str, n: int, backwards: bool = False):
    """x_tdb = x_tcb * IFTE_K**n (reference ``tcb_conversion.py:29``)."""
    p = -1 if backwards else 1
    factor = float(IFTE_K ** (p * n))
    if param in model and model[param].value is not None:
        par = model[param]
        par.value = par.value * factor
        if par.uncertainty is not None:
            par.uncertainty = par.uncertainty * factor


def transform_mjd_parameter(model, param: str, backwards: bool = False):
    """t_tdb = (t_tcb - IFTE_MJD0)/IFTE_K + IFTE_MJD0
    (reference ``tcb_conversion.py:70``); a built model's (hi, lo) epoch
    goes through its longdouble and back to the exact pair."""
    from pint_torch.dd import dd_from_longdouble

    factor = IFTE_K if backwards else 1.0 / IFTE_K
    if param in model and model[param].value is not None:
        par = model[param]
        if isinstance(par.value, tuple):
            v = np.longdouble(par.value[0]) + np.longdouble(par.value[1])
            d = dd_from_longdouble((v - IFTE_MJD0) * factor + IFTE_MJD0)
            par.value = (float(d.hi), float(d.lo))
        else:
            v = np.longdouble(par.value)
            par.value = float((v - IFTE_MJD0) * factor + IFTE_MJD0) \
                if not isinstance(par.value, np.longdouble) else \
                (v - IFTE_MJD0) * factor + IFTE_MJD0
        if par.uncertainty is not None:
            par.uncertainty = float(par.uncertainty * float(factor))


def convert_tcb_tdb(model, backwards: bool = False):
    """In-place approximate TCB->TDB (or back) conversion
    (reference ``tcb_conversion.py:98``)."""
    target = "TCB" if backwards else "TDB"
    units = model["UNITS"]
    if units.value == target or (units.value is None and not backwards):
        log.warning("Model already in target units; doing nothing")
        return model
    log.warning("Converting TCB<->TDB: the transformation is approximate; "
                "re-fit the resulting model")
    for name in model.params:
        if name in model.top_level_params:
            continue
        par = model[name]
        if par.value is None:
            continue
        if _is(par, MJDParameter):
            transform_mjd_parameter(model, name, backwards)
            continue
        if _is(par, AngleParameter):
            continue
        dim = _effective_dim(name)
        if dim:
            scale_parameter(model, name, dim, backwards)
    units.value = target
    model.validate(allow_tcb=backwards)
    return model


def compute_effective_dimensionality(param_name: str) -> int:
    """Effective time-dimensionality n of a parameter for TCB<->TDB scaling
    (x_tdb = x_tcb * IFTE_K**n).

    The reference computes n from the astropy unit of
    ``quantity * scaling_factor`` (``parameter.py:2600``); this build keys
    the same information by parameter name (the tables this module's
    converter uses).  Raises ValueError for a parameter with no defined
    scaling.
    """
    dim = _effective_dim(str(param_name).upper())
    if dim is None:
        raise ValueError(
            f"No TCB<->TDB effective dimensionality defined for "
            f"{param_name!r}")
    return int(dim)
