"""The port's reading layer against the reference's on the same inputs:
the C++ parser and the pure-Python path, ``pulsar_mjd``, par-file parsing
and formatting, the parameter classes, the model builder on every
stand-in's par text, TCB conversion, the tim reader over its four line
formats and its commands, and the syntax errors on corrupted copies.

Inputs are made from seeds with numpy; everything runs on the CPU."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import _torch_standin as standin

from pint_torch import native as port_native
from pint_torch import pulsar_mjd as port_mjd
from pint_torch.dd import dd_from_string
from pint_torch.io import par as port_par
from pint_torch.io import tim as port_tim
from pint_torch.models import get_model, parameter as port_parameter
from pint_tpu import native as ref_native
from pint_tpu import pulsar_mjd as ref_mjd
from pint_tpu.dd import dd_from_string as ref_dd_from_string
from pint_tpu.io import par as ref_par
from pint_tpu.io import tim as ref_tim
from pint_tpu.models import get_model as ref_get_model
from pint_tpu.models import parameter as ref_parameter


def _digit_strings(seed: int, n: int = 400) -> list:
    """Seeded decimal strings with the edge cases: leading zeros, 20 and
    more digits, signs, integers without a point, Fortran ``D`` and
    ``E`` exponents."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ni, nf = int(rng.integers(0, 8)), int(rng.integers(1, 32))
        ip = "".join(rng.choice(list("0123456789"), ni)) or "0"
        fp = "".join(rng.choice(list("0123456789"), nf))
        out.append(f"{rng.choice(['', '-', '+'])}{ip}.{fp}")
    return out + ["0.0", "000055000.000000000000123", "-0.0000000000000000001",
                  "55000.12345678901234567890123456", "12345678901234567890",
                  "1.5D3", "-2.25d-7", "6.02E23", "3e-5", ".5", "7."]


@pytest.mark.parametrize("seed", [1, 2])
def test_native_parser_is_the_references(seed):
    """The port's copy of the C++ parser, built from its own source, gives
    the reference's bits on every string, the Fortran ``D`` ones too."""
    assert port_native.available() and ref_native.available()
    strings = _digit_strings(seed)
    ph, pl = port_native.str2dd_batch(strings)
    rh, rl = ref_native.str2dd_batch(strings)
    assert np.array_equal(ph, rh) and np.array_equal(pl, rl)
    assert np.array_equal(port_native.parse_double_batch(strings),
                          ref_native.parse_double_batch(strings))
    a, b = (ph, pl), (pl * 3.0, ph * 1e-20)
    for op in ("dd_add_batch", "dd_mul_batch", "dd_div_batch"):
        got = getattr(port_native, op)(a, b)
        want = getattr(ref_native, op)(a, b)
        assert all(np.array_equal(g, w, equal_nan=True)
                   for g, w in zip(got, want)), op
    coeffs = [(1.5, 1e-17), (-2.0, 0.0), (0.25, -3e-18)]
    got = port_native.dd_horner_batch(coeffs, (ph[:50] * 1e-5, pl[:50]))
    want = ref_native.dd_horner_batch(coeffs, (ph[:50] * 1e-5, pl[:50]))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_native_build_key_and_path():
    """The port builds into its own build directory under its own flags
    (contraction forbidden), and reports which parser path runs."""
    so = port_native._so_path()
    assert os.path.dirname(so).endswith(os.path.join("pint_torch", "_build"))
    assert "-ffp-contract=off" in port_native.FLAGS
    assert port_native.parser_path() == "native"


@pytest.mark.parametrize("seed", [3, 4])
def test_python_path_is_dd_from_string(seed):
    """Without a compiler the port parses through ``dd_from_string``,
    bitwise the reference's on what the reference reads; a Fortran ``D``
    reads as ``E``; rounded to longdouble it agrees with the C++ parser."""
    strings = [s for s in _digit_strings(seed) if "D" not in s.upper()]
    for s in strings:
        got, want = dd_from_string(s), ref_dd_from_string(s)
        assert (float(got.hi), float(got.lo)) \
            == (float(want.hi), float(want.lo)), s
    d = dd_from_string("-2.25d-7")
    w = ref_dd_from_string("-2.25e-7")
    assert (float(d.hi), float(d.lo)) == (float(w.hi), float(w.lo))
    fracs = ["0." + s.split(".")[1] for s in strings if "." in s
             and "e" not in s.lower() and s.split(".")[1]]
    nh, nl = port_native.str2dd_batch(fracs)
    py = [dd_from_string(s) for s in fracs]
    ld_native = nh.astype(np.longdouble) + nl.astype(np.longdouble)
    ld_py = np.array([np.longdouble(p.hi) + np.longdouble(p.lo) for p in py])
    assert np.array_equal(ld_native, ld_py)


def test_toa_mjds_through_either_path(monkeypatch):
    """A tim file's MJDs come out bitwise the reference's longdouble
    whether the C++ parser or the pure-Python path reads them."""
    from pint_torch.toa import TOAs
    from pint_tpu.toa import TOAs as RefTOAs

    rng = np.random.default_rng(5)
    raw = [port_tim.RawTOA(int(d), "".join(rng.choice(list("0123456789"),
                                                      int(k))),
                           1.0, 1400.0, "gbt")
           for d, k in zip(rng.integers(45000, 60000, 300),
                           rng.integers(1, 25, 300))]
    ref_raw = [ref_tim.RawTOA(r.mjd_int, r.mjd_frac_str, 1.0, 1400.0, "gbt")
               for r in raw]
    want, _ = RefTOAs._mjds_from_raw(ref_raw)
    got, lo = TOAs._mjds_from_raw(raw)
    assert lo is None and np.array_equal(got, want)
    monkeypatch.setattr(port_native, "_load", lambda: None)
    assert port_native.parser_path() == "python"
    got, lo = TOAs._mjds_from_raw(raw)
    assert lo is None and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [6, 7])
def test_pulsar_mjd_round_trips(seed):
    """``str_to_mjds``/``mjds_to_str``, the JD conversions with leap
    seconds and the longdouble helpers give the reference's values."""
    rng = np.random.default_rng(seed)
    strings = [f"{int(d)}.{''.join(rng.choice(list('0123456789'), 16))}"
               for d in rng.integers(41400, 61000, 64)]
    i1, f1 = port_mjd.str_to_mjds(strings)
    i2, f2 = ref_mjd.str_to_mjds(strings)
    assert np.array_equal(i1, i2) and np.array_equal(f1, f2)
    assert np.array_equal(port_mjd.mjds_to_str(i1, f1),
                          ref_mjd.mjds_to_str(i2, f2))
    for fn in ("mjds_to_jds", "mjds_to_jds_pulsar", "day_frac", "two_sum",
               "two_product"):
        got = getattr(port_mjd, fn)(i1.astype(float), f1)
        want = getattr(ref_mjd, fn)(i2.astype(float), f2)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), fn
    j1, j2 = ref_mjd.mjds_to_jds_pulsar(i2.astype(float), f2)
    got = port_mjd.jds_to_mjds_pulsar(j1, j2)
    want = ref_mjd.jds_to_mjds_pulsar(j1, j2)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    ld = port_mjd.str2longdouble(strings[0])
    assert ld == ref_mjd.str2longdouble(strings[0])
    assert port_mjd.longdouble2str(ld) == ref_mjd.longdouble2str(ld)
    for cls in ("PulsarMJD", "MJDLong", "PulsarMJDLong", "MJDString",
                "PulsarMJDString"):
        pc, rc = getattr(port_mjd, cls), getattr(ref_mjd, cls)
        assert pc.name == rc.name
        val = strings[0] if "String" in cls else float(strings[0])
        got, want = pc.set_jds(val), rc.set_jds(val)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), cls
        assert np.array_equal(pc.to_value(*got), rc.to_value(*want)), cls


#: every stand-in's settings, with the depth its par text is made at
PARS = {k: (v, not k.startswith("SMALL"))
        for k, v in vars(standin).items()
        if k.endswith("_SETTINGS") and isinstance(v, dict)
        and k not in ("KEPLER_SETTINGS", "PHOTON_SETTINGS",
                      "SMALL_PHOTON_SETTINGS", "PTA67_CATALOG_SETTINGS",
                      "SMALL_CATALOG_SETTINGS")}


def _par_text(key):
    s, full = PARS[key]
    return standin.standin_par_text(s, full)


def test_parse_and_format_every_standin_par():
    """``parse_parfile`` gives the reference's keys, fields and line
    numbers on every stand-in's par text, and ``format_parfile`` its
    text back."""
    for key in PARS:
        text = _par_text(key)
        got, want = port_par.parse_parfile(text), ref_par.parse_parfile(text)
        assert list(got) == list(want), key
        for k in got:
            assert [(r.fields, r.line) for r in got[k]] \
                == [(r.fields, r.line) for r in want[k]], (key, k)
        rows = {k: [r.fields for r in v] for k, v in got.items()}
        assert port_par.format_parfile(rows) == ref_par.format_parfile(rows)
    assert port_par.fortran_float("-1.181D-15") \
        == ref_par.fortran_float("-1.181D-15")


#: (class, constructor kwargs, par-file fields) of each parameter class
PARAMETERS = [
    ("floatParameter", dict(name="F1", units="Hz/s"), ["-1.181D-15", "1",
                                                       "3.2e-19"]),
    ("floatParameter", dict(name="A1DOT", unit_scale=True), ["0.23", "1"]),
    ("strParameter", dict(name="EPHEM"), ["DE440"]),
    ("boolParameter", dict(name="K96"), ["Y"]),
    ("intParameter", dict(name="NHARMS"), ["7"]),
    ("MJDParameter", dict(name="PEPOCH"), ["54500.000123456789012345", "0",
                                           "1e-9"]),
    ("AngleParameter", dict(name="RAJ", angle_type="hms"),
     ["18:57:36.3932884", "1", "0.00001"]),
    ("AngleParameter", dict(name="DECJ", angle_type="dms"),
     ["-09:43:17.29", "1", "0.0004"]),
    ("AngleParameter", dict(name="ELONG", angle_type="deg"),
     ["284.2212", "1", "1e-8"]),
    ("prefixParameter", dict(name="DMX_0003", units="pc/cm3"),
     ["0.0012", "1", "2e-5"]),
    ("maskParameter", dict(name="JUMP", index=2, units="s"),
     ["-fe", "L-wide", "1.5e-6", "1", "2e-8"]),
    ("maskParameter", dict(name="EFAC", index=1),
     ["MJD", "55000", "56000.5", "1.1"]),
    ("pairParameter", dict(name="WAVE2"), ["1e-5", "-2e-5"]),
]


@pytest.mark.parametrize("i", range(len(PARAMETERS)))
def test_each_parameter_class(i):
    """Each class reads the same par fields into the same value, fit flag,
    uncertainty and selection, and writes the same par line, in both
    packages."""
    cls, kw, fields = PARAMETERS[i]
    got = getattr(port_parameter, cls)(**kw)
    want = getattr(ref_parameter, cls)(**kw)
    got.from_parfile_fields(list(fields))
    want.from_parfile_fields(list(fields))
    for attr in ("name", "value", "frozen", "uncertainty", "units", "key",
                 "key_value", "prefix", "index"):
        assert repr(getattr(got, attr, None)) \
            == repr(getattr(want, attr, None)), attr
    for fmt in ("pint", "tempo", "tempo2"):
        assert got.as_parfile_line(fmt) == want.as_parfile_line(fmt)
    if hasattr(want, "new_param"):
        assert repr(got.new_param(5).name) == repr(want.new_param(5).name)
    assert port_parameter.split_prefixed_name("GLF0_12") \
        == ref_parameter.split_prefixed_name("GLF0_12")
    for s, ra in (("12:34:56.789", True), ("-0:01:02.5", False),
                  ("12.5", True), ("-33.25", False)):
        a = port_parameter.parse_angle(s, is_ra=ra)
        assert a == ref_parameter.parse_angle(s, is_ra=ra)
        assert port_parameter.format_angle(a, is_ra=ra) \
            == ref_parameter.format_angle(a, is_ra=ra)


def _meta_of_port(m) -> tuple:
    comps = [{"class": n, "config": c.config}
             for n, c in m.components.items()]
    params = []
    for n, c in m.components.items():
        for p in c.params:
            q = m[p]
            v = list(q.value) if isinstance(q.value, tuple) else q.value
            params.append({"name": p, "component": n, "kind": q.kind,
                           "value": v, "frozen": q.frozen, "units": q.units,
                           "uncertainty": q.uncertainty,
                           "continuous": q.continuous, "key": q.key,
                           "key_value": q.key_value})
    return comps, params


def _meta_of_reference(rm) -> tuple:
    comps = [{"class": n, "config": standin._component_config(n, c, rm)}
             for n, c in rm.components.items()]
    params = [standin._param_entry(p, n, c._params_dict[p])
              for n, c in rm.components.items() for p in c.params]
    return comps, params


@pytest.mark.parametrize("key", sorted(PARS))
def test_get_model_is_the_references(key):
    """``get_model`` on a stand-in's par text: the components in the
    reference's order with its configs, every parameter's value (epochs as
    the exact (hi, lo) pair), kind, frozen flag, uncertainty and mask key,
    the free parameters and the design-matrix names all the reference's;
    the top-level parameters too."""
    text = _par_text(key)
    m = get_model(text, device="cpu")
    rm = ref_get_model(text.splitlines(keepends=True))
    got, want = _meta_of_port(m), _meta_of_reference(rm)
    assert json.dumps(got[0]) == json.dumps(json.loads(json.dumps(want[0])))
    assert json.dumps(got[1]) == json.dumps(want[1])
    assert list(m.free_params) == list(rm.free_params)
    assert list(m.design_param_names()) == list(rm.design_param_names())
    top = standin.top_level_meta(rm, None)
    for name, v in top.items():
        got_v = m[name].value
        assert (list(got_v) if isinstance(got_v, tuple) else got_v) == v


def test_committed_standins_are_their_par_files():
    """The committed stand-ins' par files build the model each snapshot
    holds: the same components, configs and parameter table."""
    from pint_torch import bridge

    for path in (bridge.STANDIN_PATH, bridge.ELL1_PATH, bridge.NGC_PATH):
        meta, _ = bridge.read_snapshot(path)
        par, _tim = bridge.standin_files(path)
        m = get_model(str(par), device="cpu")
        comps, params = _meta_of_port(m)
        assert comps == meta["components"]
        assert params == [{k: p[k] for k in params[0]}
                          for p in meta["params"]]


def test_registry_queries():
    """The model's and the components' registry queries answer as the
    reference's do on the b1855 stand-in's par text."""
    from pint_torch.models import AllComponents
    from pint_tpu.models.timing_model import AllComponents as RefAll

    text = _par_text("FULL_SETTINGS")
    m = get_model(text, device="cpu")
    rm = ref_get_model(text.splitlines(keepends=True))
    for kind in ("maskParameter", "prefixParameter", "MJDParameter",
                 "floatParameter"):
        assert m.get_params_of_type(kind) == rm.get_params_of_type(kind)
    assert m.params_ordered == rm.params_ordered
    assert m.get_prefix_mapping("DMX_") == rm.get_prefix_mapping("DMX_")
    for key in ("RA", "XDOT", "E", "T2EFAC", "F0"):
        assert m.match_param_aliases(key) == rm.match_param_aliases(key)
    for name, comp in m.components.items():
        assert comp.aliases_map == rm.components[name].aliases_map
        assert comp.param_prefixs == rm.components[name].param_prefixs
    pa, ra = AllComponents(), RefAll()

    def by_name(d):  # the registries list the components in their own order
        return {k: sorted(v) for k, v in d.items()}

    assert by_name(pa.param_component_map) == by_name(ra.param_component_map)
    assert by_name(pa.category_component_map) \
        == by_name(ra.category_component_map)
    assert pa.component_unique_params == ra.component_unique_params
    assert pa.repeatable_param() == ra.repeatable_param()
    for alias in ("T2EFAC2", "RA", "XDOT", "FB", "DMX_0001"):
        assert pa.alias_to_pint_param(alias) == ra.alias_to_pint_param(alias)
        assert pa.param_to_unit(alias) == ra.param_to_unit(alias)
    for alias in ("DMX_0005", "NOPE"):
        with pytest.raises(ValueError) as e:
            pa.alias_to_pint_param(alias)
        with pytest.raises(ValueError) as r:
            ra.alias_to_pint_param(alias)
        assert str(e.value) == str(r.value)


def _tcb_par():
    return _par_text("SMALL_SETTINGS").replace("UNITS TDB", "UNITS TCB")


def test_tcb_conversion():
    """A TCB par file is refused without ``allow_tcb``, kept as it is with
    ``"raw"`` and converted to TDB with ``True``, to the reference's
    values; ``TimingModel.validate(allow_tcb=)`` says the same."""
    from pint_torch.exceptions import TimingModelError
    from pint_tpu.exceptions import TimingModelError as RefError

    text = _tcb_par()
    assert "UNITS TCB" in text
    with pytest.raises(TimingModelError) as e:
        get_model(text, device="cpu")
    with pytest.raises(RefError) as r:
        ref_get_model(text.splitlines(keepends=True))
    assert str(e.value) == str(r.value)
    for allow in ("raw", True):
        m = get_model(text, allow_tcb=allow, device="cpu")
        rm = ref_get_model(text.splitlines(keepends=True), allow_tcb=allow)
        assert json.dumps(_meta_of_port(m)[1]) \
            == json.dumps(_meta_of_reference(rm)[1])
        assert m["UNITS"].value == rm.UNITS.value
    m = get_model(text, allow_tcb="raw", device="cpu")
    with pytest.raises(TimingModelError):
        m.validate()
    m.validate(allow_tcb=True)
    # converting the built model: each epoch through its longdouble and
    # back to the exact pair, the same table as converting while reading
    from pint_torch.models.tcb_conversion import convert_tcb_tdb

    convert_tcb_tdb(m)
    conv = get_model(text, allow_tcb=True, device="cpu")
    assert json.dumps(_meta_of_port(m)[1]) \
        == json.dumps(_meta_of_port(conv)[1])
    m.validate()


def test_model_builder_helpers():
    """``guess_binary_model``, ``convert_binary_params_dict`` and the T2
    refusal as in the reference."""
    from pint_torch.exceptions import UnknownBinaryModel
    from pint_torch.models import model_builder as mb
    from pint_tpu.models import model_builder as rmb

    text = _par_text("DDK_SETTINGS").replace("BINARY DDK", "BINARY T2")
    assert mb.guess_binary_model(port_par.parse_parfile(text)) \
        == rmb.guess_binary_model(ref_par.parse_parfile(text))
    got = mb.convert_binary_params_dict(port_par.parse_parfile(text))
    want = rmb.convert_binary_params_dict(ref_par.parse_parfile(text))
    assert {k: [r.fields for r in v] for k, v in got.items()} \
        == {k: [r.fields for r in v] for k, v in want.items()}
    with pytest.raises(UnknownBinaryModel):
        get_model(text, device="cpu")
    m = get_model(text, allow_T2=True, device="cpu")
    assert "BinaryDDK" in m.components
    assert sorted(mb.IGNORE_PARAMS) == sorted(rmb.IGNORE_PARAMS)


#: one tim file of every line format and command the reader knows
TIM_MAIN = """FORMAT 1
C a comment
# another
f1 1400.0 53358.000000000123456789 1.25 ao -f L-wide -be PUPPI
f2 1410.5 53358.0007 2.5 ao -f L-wide
TIME 0.5
EFAC 2.0
EQUAD 1.0
f3 430.0 53400.12345678901234567890 3.0 ao -f 430
TIME -0.5
EFAC 1
EQUAD 0
JUMP
f4 1400.0 53500.5 1.0 gbt -f Rcvr1_2
JUMP
SKIP
garbage that is skipped
NOSKIP
EMAX 5.0
f5 1400.0 53600.25 9.0 gbt
INCLUDE sub.tim
FORMAT 0
1              1410.000 53700.123456789012   1.500
{parkes}
{itoa}
"""
#: a Parkes line: name, frequency, MJD with its point in column 42,
#: phase offset, error and the one-character site in column 80
PARKES = (" " + "PKS_1234".ljust(24) + "1400.0000" + "  53800" + "."
          + "1234567890123" + "   0.00" + " " + "   2.500" + " " * 8 + "7")
#: an ITOA line: name, MJD with its point in column 15, error, frequency,
#: DM correction and the two-character site in columns 58-59
ITOA = ("NGC6440E " + "55000.1234567890123" + " " + "  2.50" + " 1400.0000"
        + "  0.000000" + "  " + "AO")
TIM_MAIN = TIM_MAIN.replace("{parkes}", PARKES).replace("{itoa}", ITOA)
TIM_SUB = """FORMAT 1
s1 1400.0 53650.000000000000000001 1.0 ao -f sub
"""


def _write_tim(tmp_path):
    (tmp_path / "main.tim").write_text(TIM_MAIN)
    (tmp_path / "sub.tim").write_text(TIM_SUB)
    return str(tmp_path / "main.tim")


def _raw_tuples(raw):
    return [(t.mjd_int, t.mjd_frac_str, t.error_us, t.freq_mhz, t.obs,
             t.name, t.flags) for t in raw]


def test_read_tim_file_formats_and_commands(tmp_path):
    """Tempo2, Princeton, Parkes and ITOA lines, INCLUDE and the TIME,
    EFAC, EQUAD, JUMP, SKIP and EMAX commands read as the reference reads
    them; ``format_toa_line`` writes the reference's lines."""
    path = _write_tim(tmp_path)
    got, gc = port_tim.read_tim_file(path)
    want, wc = ref_tim.read_tim_file(path)
    assert _raw_tuples(got) == _raw_tuples(want)
    assert gc == wc
    kinds = {port_tim._classify(ln, "Unknown") for ln in TIM_MAIN.splitlines()}
    assert {"Princeton", "Parkes", "ITOA", "Command"} <= kinds
    for t in got:
        for fmt in ("tempo2", "princeton"):
            assert port_tim.format_toa_line(
                t.mjd_int, t.mjd_frac_str, t.error_us, t.freq_mhz, t.obs,
                t.name, t.flags, fmt) == ref_tim.format_toa_line(
                t.mjd_int, t.mjd_frac_str, t.error_us, t.freq_mhz, t.obs,
                t.name, t.flags, fmt)


#: (text to corrupt, corrupted text) of the syntax-error cases
PAR_CORRUPT = [("F0 ", "F0 1.2.3x "), ("DM ", "0DM ")]
TIM_CORRUPT = ["f2 1410.5 53358.0007 2.5 ao -f L-wide",
               "FORMAT 1\nf2 1410.5 53358.0007 2.5 ao -f",
               "FORMAT 7"]


@pytest.mark.parametrize("case", range(len(PAR_CORRUPT)))
def test_par_syntax_errors_are_the_references(case, tmp_path):
    """A corrupted par file raises ``ParSyntaxError`` with the reference's
    message (file, line, column, token) in both packages' model builder."""
    from pint_torch.exceptions import ParSyntaxError
    from pint_tpu.exceptions import ParSyntaxError as RefError

    old, new = PAR_CORRUPT[case]
    path = tmp_path / "bad.par"
    path.write_text(_par_text("SMALL_SETTINGS").replace(old, new, 1))
    with pytest.raises((ParSyntaxError, ValueError)) as e:
        get_model(str(path), device="cpu")
    with pytest.raises((RefError, ValueError)) as r:
        ref_get_model(str(path))
    assert type(e.value).__name__ == type(r.value).__name__
    assert str(e.value) == str(r.value)


@pytest.mark.parametrize("case", range(len(TIM_CORRUPT)))
def test_tim_syntax_errors_are_the_references(case, tmp_path):
    """A corrupted tim file raises ``TimSyntaxError`` with the reference's
    message under the strict policy, and the lenient policy records the
    same diagnostics in both."""
    from pint_torch.exceptions import TimSyntaxError
    from pint_torch.integrity.diagnostics import Diagnostics
    from pint_tpu.exceptions import TimSyntaxError as RefError
    from pint_tpu.integrity.diagnostics import Diagnostics as RefDiags

    path = _write_tim(tmp_path)
    text = TIM_MAIN.replace("f2 1410.5 53358.0007 2.5 ao -f L-wide",
                            TIM_CORRUPT[case] + " x y z w v u"
                            if case == 0 else TIM_CORRUPT[case])
    if case == 0:
        text = text.replace("FORMAT 1\n", "", 1).replace(
            TIM_CORRUPT[0] + " x y z w v u", "f2 1410.5 53358.0007")
    (tmp_path / "main.tim").write_text(text)
    with pytest.raises(TimSyntaxError) as e:
        port_tim.read_tim_file(path, policy="strict")
    with pytest.raises(RefError) as r:
        ref_tim.read_tim_file(path, policy="strict")
    assert str(e.value) == str(r.value)
    d, rd = Diagnostics(path), RefDiags(path)
    got, _ = port_tim.read_tim_file(path, policy="collect", diagnostics=d)
    want, _ = ref_tim.read_tim_file(path, policy="collect", diagnostics=rd)
    assert _raw_tuples(got) == _raw_tuples(want)
    assert [x.render() for x in d] == [x.render() for x in rd]


def test_parse_diagnostics_under_each_policy():
    """``parse_parfile(...).diagnostics`` records the reference's findings
    (duplicate and valueless keys) under the lenient and collect
    policies, and the strict policy raises on an invalid key as it
    does."""
    from pint_torch.exceptions import ParSyntaxError

    text = _par_text("SMALL_SETTINGS") + "F0 1.0\nNOVALUE\n"
    for policy in ("lenient", "collect"):
        got = port_par.parse_parfile(text, policy=policy).diagnostics
        want = ref_par.parse_parfile(text, policy=policy).diagnostics
        assert [d.render() for d in got] == [d.render() for d in want]
        assert got.codes() == want.codes() and len(got.warnings) == 2
    with pytest.raises(ParSyntaxError):
        port_par.parse_parfile(text + "1BAD 2\n", policy="strict")


def test_toa_select_is_the_references():
    """``TOASelect`` resolves range and value conditions to the
    reference's indices, and serves a repeated condition from its cache."""
    from pint_torch.toa_select import TOASelect
    from pint_tpu.toa_select import TOASelect as RefSelect

    rng = np.random.default_rng(8)
    mjds = np.sort(rng.uniform(53000.0, 56000.0, 300))
    flags = rng.choice(["L-wide", "430", "S-wide"], 300)
    ranges = {"DMX_0001": (53000.0, 54000.0), "DMX_0002": (54000.0, 55500.0)}
    values = {"JUMP1": "430", "JUMP2": ["L-wide", "S-wide"]}
    for cond, col, is_range in ((ranges, mjds, True), (values, flags, False)):
        got, want = TOASelect(is_range), RefSelect(is_range)
        a = got.get_select_index(cond, col)
        b = want.get_select_index(cond, col)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
        assert got.get_select_index(cond, col) is a
        assert got.check_condition(cond) == want.check_condition(cond)
