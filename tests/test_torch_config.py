"""``pint_torch.config`` and ``pint_torch.logging`` against the JAX
package's ``config`` and ``logging`` on the CPU.

Each ``PINT_TORCH_*`` variable parses as its ``PINT_TPU_*`` counterpart
does, values and errors both; the setters refuse what the reference's
refuse; the device policies other than ``warn``, the telemetry modes
other than ``off`` and the AOT-cache directory of ROADMAP queue A item 8
raise ``NotImplementedError``, the tuning directory reads as the
reference's; ``TOABatch.validate``
reads the configured ingestion policy; a repeated message is
deduplicated as the reference's is.
"""

import importlib
import logging
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch


@pytest.fixture
def reload_both(monkeypatch):
    """``reload(env)``: both config modules re-read with ``env``
    (``{suffix: value}``) under each prefix; both are re-read without it
    after the test."""
    import pint_tpu.config as rconf

    import pint_torch.config as pconf

    def reload(env):
        for suffix, value in env.items():
            monkeypatch.setenv(f"PINT_TPU_{suffix}", value)
            monkeypatch.setenv(f"PINT_TORCH_{suffix}", value)
        return importlib.reload(rconf), importlib.reload(pconf)

    yield reload
    monkeypatch.undo()
    importlib.reload(rconf)
    importlib.reload(pconf)


@pytest.mark.parametrize("var,getter", [
    ("DEVICE_POLICY", "device_policy"),
    ("INGESTION_POLICY", "ingestion_policy")])
@pytest.mark.parametrize("value", ["strict", "warn", "allow", "lenient",
                                   "collect", "bogus", ""])
def test_policy_variables_parse_as_the_references(reload_both, var, getter,
                                                  value):
    """As the reference's, the device policies ``strict`` and ``allow``
    (which the preflight's ``check_device`` reads) included."""
    r, p = reload_both({var: value})
    assert getattr(p, getter)() == getattr(r, getter)()


@pytest.mark.parametrize("name,good", [
    ("set_device_policy", "warn"), ("set_ingestion_policy", "collect")])
def test_policy_setters_refuse_as_the_references(reload_both, name, good):
    """Each policy sets as the reference's, ``strict`` and ``allow`` of
    the device policy too; an unknown one raises the reference's
    ``ValueError``."""
    r, p = reload_both({})
    for dev in ("strict", "allow", "warn"):
        for mod in (r, p):
            mod.set_device_policy(dev)
        assert p.device_policy() == r.device_policy() == dev
    for mod in (r, p):
        getattr(mod, name)(good)
    assert p.device_policy() == r.device_policy()
    assert p.ingestion_policy() == r.ingestion_policy()
    with pytest.raises(ValueError) as e_r:
        getattr(r, name)("bogus")
    with pytest.raises(ValueError) as e_p:
        getattr(p, name)("bogus")
    assert str(e_p.value) == str(e_r.value)


@pytest.mark.parametrize("value", ["64", "1", "0", "-3", "abc", "12.5",
                                   " 7", ""])
def test_grid_chunk_variable_parses_as_the_references(reload_both, value):
    """Values and typed errors alike, the message naming the variable."""
    r, p = reload_both({"GRID_CHUNK": value})
    outs = []
    for mod in (r, p):
        try:
            outs.append(("ok", mod.grid_chunk()))
        except Exception as e:  # noqa: BLE001 -- compared below
            outs.append((type(e).__name__,
                         str(e).replace("PINT_TORCH_", "PINT_TPU_")))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("value", [np.int64(32), 5, True, 2.0, "16", -1,
                                   None])
def test_set_grid_chunk_as_the_references(reload_both, value):
    r, p = reload_both({})
    outs = []
    for mod in (r, p):
        try:
            mod.set_grid_chunk(value)
            outs.append(("ok", mod.grid_chunk()))
        except Exception as e:  # noqa: BLE001 -- compared below
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("value", ["off", "bogus", ""])
def test_telemetry_variable_off_as_the_reference(reload_both, value):
    r, p = reload_both({"TELEMETRY": value})
    assert p.telemetry_mode() == r.telemetry_mode() == "off"


def test_item_8_settings_raise(reload_both, tmp_path):
    """Telemetry modes but ``off`` and the AOT cache are ROADMAP queue A
    item 8: they raise, naming it; unset they read None as the reference's
    do by default.  The tuning directory is ported (the autotuner's
    records): set, it reads as the reference's, and an unwritable one
    raises the reference's ``UsageError``."""
    r, p = reload_both({})
    assert p.aot_cache_dir() is None is r.aot_cache_dir()
    assert p.tune_dir() is None is r.tune_dir()
    p.set_telemetry_mode("off")
    p.set_aot_cache_dir(None)
    p.set_tune_dir("")
    for call in (lambda: p.set_telemetry_mode("basic"),
                 lambda: p.set_telemetry_mode("full"),
                 lambda: p.set_aot_cache_dir(str(tmp_path))):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()
    for mod in (r, p):
        mod.set_tune_dir(str(tmp_path / "tune"))
    assert p.tune_dir() == r.tune_dir() == str(tmp_path / "tune")
    blocker = tmp_path / "file"
    blocker.write_text("")
    outs = []
    for mod in (r, p):
        with pytest.raises(ValueError) as e:
            mod.set_tune_dir(str(blocker / "sub"))
        outs.append(type(e.value).__name__)
    assert outs[0] == outs[1] == "UsageError"
    with pytest.raises(ValueError):
        p.set_telemetry_mode("loud")
    r2, p2 = reload_both({"TELEMETRY": "full", "AOT_CACHE_DIR": "x",
                          "TUNE_DIR": "y"})
    for call in (p2.telemetry_mode, p2.aot_cache_dir):
        with pytest.raises(NotImplementedError, match="item 8"):
            call()
    assert p2.tune_dir() == r2.tune_dir() == "y"


def test_data_paths():
    """``datadir`` is the package's data directory, the one the bridge's
    stand-ins are in."""
    from pint_torch import config
    from pint_torch.bridge import STANDIN_PATH

    assert os.path.samefile(config.datadir(), os.path.dirname(STANDIN_PATH))


def test_validate_reads_the_configured_policy(monkeypatch):
    """``TOABatch.validate()`` without a policy takes
    ``config.ingestion_policy()``: strict raises on a duplicated row,
    collect quarantines the reference's row."""
    from pint_torch import config
    from pint_torch.toa import TOAIntegrityError, merge_TOAs
    from pint_tpu.toa import merge_TOAs as rmerge

    model, toas, m, b = standin.port_and_reference(
        standin.SMALL_ELL1_SETTINGS)
    rows = np.arange(40, 44)

    def mask(idx):
        k = np.zeros(b.ntoas, dtype=bool)
        k[idx] = True
        return k

    blk = merge_TOAs([b.select(mask(rows), m), b.select(mask(rows[:1]), m)])
    monkeypatch.setattr(config, "_ingestion_policy", "strict")
    with pytest.raises(TOAIntegrityError):
        blk.validate(check_coverage=False)
    monkeypatch.setattr(config, "_ingestion_policy", "collect")
    rep = blk.validate(check_coverage=False)
    want = rmerge([toas[rows], toas[rows[:1]]]).validate(
        policy="collect", check_coverage=False)
    assert rep.n_quarantined == want.n_quarantined == 1
    assert np.array_equal(rep.mask, want.mask)


def test_logging_dedups_as_the_reference():
    """The same run of messages through each package's ``LogFilter``
    passes the same ones; the package loggers' names; ``get_level``."""
    import pint_tpu.logging as rlog

    import pint_torch.logging as plog

    msgs = ["Clock file x not found", "Clock file x not found",
            "Clock file y not found", "plain", "plain",
            "Using EPHEM = DE440", "Using EPHEM = DE440"]

    def passed(mod, **kw):
        filt = mod.LogFilter(onlyonce=mod._DEFAULT_ONLYONCE, **kw)
        return [filt.filter(logging.LogRecord("x", logging.INFO, "", 0, m,
                                              None, None)) for m in msgs]

    assert passed(plog) == passed(rlog) == [True, False, True, True, True,
                                            True, False]
    assert passed(plog, dedup_all=True) == passed(rlog, dedup_all=True)
    assert plog.log.name == "pint_torch" and rlog.log.name == "pint_tpu"
    assert any(isinstance(f, plog.LogFilter)
               for h in plog.log.handlers for f in h.filters)
    for args in (("INFO", 1, 0), ("WARNING", 0, 2), ("BOGUS", 9, 0)):
        assert plog.get_level(*args) == rlog.get_level(*args)


def test_modules_log_through_the_package_logger():
    import pint_torch.logging as plog
    import pint_torch.mcmc_fitter as mf
    import pint_torch.sampler as sp
    import pint_torch.templates.lcfitters as lf

    assert sp.log is mf.log is lf.log is plog.log
