"""PTA-style delay and noise components on the CPU, against the reference
package: CM with CM1 and CMX (``chromatic.py``), FDJUMP with log and
linear frequencies (``fdjump.py``), FDJUMPDM and DMJUMP
(``dispersion_model.py:316-400``), the delay JUMP (``jump.py:118-147``),
WaveX, DMWaveX and CMWaveX (``wavex.py``) each within 1e-13 s; PLDMNoise's
and PLChromNoise's bases (``noise_model.py:495-543``, their chromatic
scales built on the host with the snapshot) bitwise; the small_pta
stand-in end to end against the reference outputs stored in its
snapshot."""

import copy
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def small_pta():
    return standin.port_and_reference(standin.SMALL_PTA_SETTINGS)


@pytest.fixture(scope="module")
def small_j1713():
    return standin.port_and_reference(
        dict(standin.PTA_SETTINGS, n_epochs=40, n_subbands=4))


@pytest.mark.parametrize("name", ["ChromaticCMX", "WaveX", "DMWaveX",
                                  "CMWaveX", "DispersionJump", "DelayJump"])
def test_small_pta_delay_matches_reference(small_pta, name):
    model, toas, m, b = small_pta
    got, ref = standin.component_outputs(model, toas, m, b, name)
    if name != "DispersionJump":
        assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-13


@pytest.mark.parametrize("name", ["ChromaticCM", "FDJumpDM", "FDJump"])
def test_j1713_delay_matches_reference(small_j1713, name):
    model, toas, m, b = small_j1713
    if name == "ChromaticCM":
        model = copy.deepcopy(model)
        model.components["ChromaticCM"].CM.value = 3.0
        model.components["ChromaticCM"].CM1.value = -0.4
        from pint_torch.bridge import load_snapshot

        m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    got, ref = standin.component_outputs(model, toas, m, b, name)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-13


def test_fdjump_linear_frequency_matches_reference(small_j1713):
    """FDJUMPLOG N: y = f / 1 GHz in place of its logarithm."""
    model, toas, m, b = small_j1713
    model = copy.deepcopy(model)
    model.components["FDJump"].FDJUMPLOG.value = False
    m = m.copy()
    m["FDJUMPLOG"].value = False
    got, ref = standin.component_outputs(model, toas, m, b, "FDJump")
    assert np.abs(got - ref).max() <= 1e-13


@pytest.mark.parametrize("name", ["PLDMNoise", "PLChromNoise"])
def test_chromatic_noise_basis_matches_reference(small_j1713, name):
    model, toas, m, b = small_j1713
    U, w = model.components[name].basis_weight_pair(model, toas)
    Ut, wt = m.components[name].basis_weight_pair(m, b)
    assert Ut.shape == (len(toas), 60)
    assert np.array_equal(Ut, np.asarray(U)) and np.array_equal(wt,
                                                                np.asarray(w))


@pytest.mark.parametrize("key", ["postfit", "auto"])
def test_small_pta_end_to_end(key):
    """The committed small_pta stand-in: residuals 1e-10 s, the GLS and
    ``Fitter.auto`` fits (chi2 1e-6 rel, values 1e-2 sigma, uncertainties
    1e-6 rel; the auto fitter's class, converged flag and steps)."""
    from pint_torch import bridge
    from pint_torch.fitter import Fitter
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.residuals import Residuals

    meta, ref = bridge.read_snapshot(bridge.PTA_SMALL_PATH)
    rr = meta["reference"]
    assert rr["settings"] == standin.SMALL_PTA_SETTINGS
    m, b = bridge.load_snapshot(bridge.PTA_SMALL_PATH, device="cpu")
    assert {"SolarWindDispersion", "PLSWNoise", "ChromaticCMX", "WaveX",
            "DMWaveX", "CMWaveX", "DelayJump",
            "DispersionJump"} <= set(m.components)
    r = Residuals(b, m).time_resids.numpy()
    assert np.abs(r - ref["ref/time_resids"]).max() <= 1e-10
    f = GLSFitter(b, m.copy()) if key == "postfit" else Fitter.auto(b, m)
    chi2 = f.fit_toas(maxiter=2) if key == "postfit" else f.fit_toas()
    vals = np.array([f.model.value(p) for p in rr["postfit_params"]])
    unc = np.array([f.model[p].uncertainty for p in rr["postfit_params"]])
    sig = ref[f"ref/{key}_uncertainties"]
    assert abs(chi2 / rr[f"{key}_chi2"] - 1) <= 1e-6
    assert np.abs((vals - ref[f"ref/{key}_values"]) / sig).max() <= 1e-2
    assert np.abs(unc / sig - 1).max() <= 1e-6
    if key == "auto":
        assert type(f).__name__ == rr["auto_fitter"]
        assert (bool(f.converged), f.iterations) == (
            rr["auto_converged"], rr["auto_iterations"])


def test_scale_dm_error_is_refused_naming_the_roadmap_item():
    """ScaleDmError, once refused until the wideband fitters came, now
    loads and scales the wideband DM uncertainties as the reference's
    ``scale_dm_sigma``: all DMEQUADs in quadrature, then all DMEFACs,
    bitwise; narrowband TOAs have no DM errors to scale."""
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(dict(standin.SMALL_BT_SETTINGS,
                                            wideband=True), full=False)
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    assert "ScaleDmError" in m.components and b.wideband
    got = m.scaled_dm_uncertainty(b)
    assert np.array_equal(got, np.asarray(model.scaled_dm_uncertainty(toas)))
    sel = m.components["ScaleDmError"].context["masks"]["DMEFAC1"]
    raw = b.dm_error.numpy()[sel]
    assert np.array_equal(got[sel], np.hypot(raw, m.value("DMEQUAD1"))
                          * m.value("DMEFAC1"))
    narrow, nb = load_snapshot(standin.export_state(*standin.make_standin(
        standin.SMALL_BT_SETTINGS, full=False)), device="cpu")
    with pytest.raises(ValueError, match="no wideband DM errors"):
        m.scaled_dm_uncertainty(nb)