"""The device preflight, the device policies, ``Fitter.doctor`` and the
subsets whose contexts depend on the whole TOA set, in the port against
the JAX package on the CPU.

Preflight: the two probes on the CPU (two_sum's error word exact, 52
mantissa bits) as the reference's profile of its CPU backend; each policy's
verdict on a requested platform the device is not.  Doctor: the TOA, the
Model/TOA-compatibility and the robust sections the reference's text on
ngc's committed files (62 TOAs; a Huber fit, a free JUMP over every TOA
and one over none) and on the small GLS stand-in written as par and tim
files (80 TOAs).  Subsets: the first half by MJD of the small stand-in,
selected from the batch or from the host TOAs, gives the reference's
``toas[mask]`` ECORR epochs and red-noise basis bitwise and its GLS fit at
the fit bars (chi2 1e-6 rel, values 1e-2 sigma, uncertainties 1e-6 rel).
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch


def test_profile_is_the_references_on_the_cpu():
    """Platform, float64 health, mantissa bits and the error word's
    defect as the reference's profile of its CPU backend; the per-device
    health and the healthy devices."""
    from pint_torch.runtime import preflight as P
    from pint_tpu.runtime import preflight as R

    got, want = P.device_profile(device="cpu"), R.device_profile()
    for k in ("platform", "f64_native", "mantissa_bits", "two_sum_error",
              "degraded_precision", "precision"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.mantissa_bits == 52 and got.two_sum_error == 0.0
    assert P.device_profile(refresh=True, device="cpu") == got
    (h,) = P.device_health(refresh=True)
    r = R.device_health(refresh=True)[0]
    assert (h.device_id, h.platform, h.healthy, h.two_sum_error, h.error) \
        == (r.device_id, r.platform, r.healthy, r.two_sum_error, r.error)
    assert [d.type for d in P.healthy_devices()] == ["cpu"]
    assert got.to_dict()["precision"] == "native-f64"


@pytest.mark.parametrize("pair", [("cpu", "cpu"), ("cpu", "tpu"),
                                  ("gpu", "cpu"), ("gpu", "gpu")])
def test_platform_matches_as_the_reference(pair):
    from pint_torch.runtime.preflight import platform_matches
    from pint_tpu.runtime.preflight import platform_matches as R

    assert platform_matches(*pair) == R(*pair)
    assert platform_matches("gpu", "cuda") and platform_matches("cuda",
                                                                "gpu")


@pytest.mark.parametrize("policy", ["strict", "warn", "allow"])
def test_check_device_policies_as_the_references(policy, monkeypatch):
    """A requested platform the device is not: ``strict`` raises
    ``DeviceMismatchError``, ``warn`` logs once a pair, ``allow`` is
    silent, as the reference's; the requirement may come from
    ``PINT_TORCH_REQUIRE_PLATFORM``; the policy from the config."""
    from pint_torch import config
    from pint_torch.exceptions import DeviceMismatchError
    from pint_torch.runtime import preflight as P
    from pint_tpu.exceptions import DeviceMismatchError as RMismatch
    from pint_tpu.runtime import preflight as R

    monkeypatch.setattr(P, "_warned_mismatch", set())
    monkeypatch.setattr(R, "_warned_mismatch", set())
    assert P.check_device("cpu", policy="strict", device="cpu") \
        .platform == "cpu"
    if policy == "strict":
        with pytest.raises(DeviceMismatchError):
            P.check_device("tpu", policy=policy, device="cpu")
        with pytest.raises(RMismatch):
            R.check_device("tpu", policy=policy)
        monkeypatch.setenv("PINT_TORCH_REQUIRE_PLATFORM", "gpu")
        old = config.device_policy()
        config.set_device_policy("strict")
        try:
            with pytest.raises(DeviceMismatchError):
                P.check_device(device="cpu")
        finally:
            config.set_device_policy(old)
        return
    for mod, kw in ((P, {"device": "cpu"}), (R, {})):
        rec = _Records()
        mod.log.addHandler(rec)
        try:
            for _ in range(2):
                prof = mod.check_device("tpu", policy=policy, **kw)
        finally:
            mod.log.removeHandler(rec)
        assert prof.platform == "cpu"
        hits = [m for m in rec.messages if "Device preflight" in m]
        assert len(hits) == (1 if policy == "warn" else 0)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from pint_torch.bridge import NGC_PATH, standin_files

    d = tmp_path_factory.mktemp("small")
    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    par, tim = d / "small.par", d / "small.tim"
    par.write_text(standin.standin_par_text(standin.SMALL_SETTINGS, False))
    toas.write_TOA_file(str(tim))
    return {"small": (str(par), str(tim)),
            "ngc": tuple(map(str, standin_files(NGC_PATH)))}


def _read(files, name):
    from pint_torch.models import get_model_and_toas
    from pint_tpu.models import get_model_and_toas as rget

    par, tim = files[name]
    m, t = get_model_and_toas(par, tim, device="cpu")
    return m, t, *rget(par, tim)


def _sections(text):
    """The TOA, compatibility and robust sections: the report without its
    header, its Device line and the last solve's diagnostics (a condition
    number that rounds apart in its last digits)."""
    return [ln for ln in text.splitlines()[2:]
            if not ln.startswith("Last solve:")]


@pytest.mark.parametrize("case", ["ngc", "ngc_huber", "ngc_jumps", "small"])
def test_doctor_sections_are_the_references(files, case):
    """The TOA, compatibility and robust sections line by line the
    reference's; the Device line the fitter's device."""
    import pint_torch.fitter as P
    import pint_torch.gls_fitter as PG
    import pint_tpu.fitter as R
    import pint_tpu.gls_fitter as RG
    from pint_torch.models.parameter import maskParameter
    from pint_tpu.models.parameter import maskParameter as RMask

    m, t, rm, rt = _read(files, "small" if case == "small" else "ngc")
    if case == "ngc_jumps":
        from pint_torch.models.jump import PhaseJump
        from pint_tpu.models.jump import PhaseJump as RJ

        m.add_component(PhaseJump.template(), validate=False)
        rm.add_component(RJ(), validate=False)
        for mm, Mask in ((m, maskParameter), (rm, RMask)):
            mm.remove_param("JUMP1")
            comp = mm.components["PhaseJump"]
            comp.add_param(Mask("JUMP", index=1, key="tel",
                                key_value=["gbt"], value=0.0,
                                frozen=False), setup=True)
            comp.add_param(Mask("JUMP", index=2, key="-fe",
                                key_value=["none"], value=0.0,
                                frozen=False), setup=True)
            mm.setup()
    if case == "small":
        f, rf = PG.GLSFitter(t, m), RG.GLSFitter(rt, rm)
        f.fit_toas(maxiter=1)
        rf.fit_toas(maxiter=1)
    else:
        f, rf = P.WLSFitter(t, m), R.WLSFitter(rt, rm)
        kw = {"robust": "huber"} if case == "ngc_huber" else {}
        if case != "ngc_jumps":
            f.fit_toas(**kw)
            rf.fit_toas(**kw)
    got, want = f.doctor(), rf.doctor()
    assert got.splitlines()[1] == "Device: cpu (cpu), f64_native=True"
    assert _sections(got) == _sections(want)
    if case == "ngc_jumps":
        assert "JUMP2 selects no TOAs" in got and "JUMP1 selects every" in got
    if case == "ngc_huber":
        assert "Robust fit" in got
    assert f.doctor(designmatrix=False) is not None


def _first_half(t):
    mjd = np.asarray(t.get_mjds(), dtype=np.float64)
    return mjd < np.median(mjd)


@pytest.mark.parametrize("how", ["batch_select", "host_select"])
def test_subset_ecorr_epochs_and_span_basis_as_the_references(files, how):
    """The first half by MJD: the subset's ECORR epochs and red-noise basis
    over its own span bitwise the reference's ``toas[mask]``, and its GLS
    fit at the fit bars."""
    from pint_torch.gls_fitter import GLSFitter
    from pint_tpu.gls_fitter import GLSFitter as RG

    m, t, rm, rt = _read(files, "small")
    keep = _first_half(t)
    if how == "batch_select":
        sub = t.to_batch(device="cpu", model=m).select(keep, m)
    else:
        sub = t[keep].to_batch(device="cpu", model=m)
    rsub = rt[keep]
    Up, wp, _ = m.noise_basis_by_component(sub)
    Ur, wr, _ = rm.noise_basis_by_component(rsub)
    assert np.array_equal(np.hstack(Up), np.hstack(Ur))
    assert np.array_equal(np.concatenate(wp), np.concatenate(wr))
    f, rf = GLSFitter(sub, m), RG(rsub, rm)
    chi2, rchi2 = f.fit_toas(maxiter=2), rf.fit_toas(maxiter=2)
    assert abs(chi2 / rchi2 - 1) <= 1e-6
    for p in rf.model.free_params:
        sig = float(getattr(rf.model, p).uncertainty)
        assert abs(f.model.value(p) - float(getattr(rf.model, p).value)) \
            <= 1e-2 * sig, p
        assert abs(f.model[p].uncertainty / sig - 1) <= 1e-6, p


def _same_leaves(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_leaves(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    return np.array_equal(a, b)


@pytest.mark.parametrize("name", ["small", "ngc"])
def test_select_gives_the_host_subsets_batch(files, name):
    """``select`` on a batch frozen from host TOAs gives bitwise the
    contexts, and records the same provenance, as the batch of the host
    subset; after an edit of a context (a DMX window removed, where the
    model has DMX) ``batch_for`` makes the subset again from its host
    rows with the edited model's."""
    m, t, _, _ = _read(files, name)
    keep = _first_half(t)
    sub = t.to_batch(device="cpu", model=m).select(keep, m)
    want = t[keep].to_batch(device="cpu", model=m)
    assert _same_leaves(sub.contexts, want.contexts)
    assert sub._ctx_sig == want._ctx_sig
    assert torch.equal(m.phase(sub).frac, m.phase(want).frac)
    if "DispersionDMX" not in m.components:
        return
    m2 = m.copy()
    m2.components["DispersionDMX"].remove_DMX_range(2)
    again = m2.batch_for(sub)
    assert again is not sub and again.ntoas == sub.ntoas
    assert _same_leaves(again.contexts, sub.host.to_batch(
        device="cpu", model=m2).contexts)
