"""Young-pulsar components on the CPU, against the reference package:
glitches with a recovery (``glitch.py``), WAVE sinusoids (``wave.py``,
pair parameters), the troposphere (``troposphere.py``, its host-built
delay carried by the snapshot), the piecewise spindown (``piecewise.py``)
and IFUNC at SIFUNC 0 and 2 (``ifunc.py``; SIFUNC 2 through the port's
``interp``, ``jnp.interp``'s formula) -- phases within 1e-9 cycles and
delays within 1e-13 s -- and the small_young stand-in end to end against
the reference outputs stored in its snapshot."""

import copy
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

#: the full-width young stand-in's components at small depth (80 TOAs)
YOUNG_SMALL_DEPTH = dict(standin.YOUNG_SETTINGS, n_epochs=20, n_subbands=4)


@pytest.fixture(scope="module")
def young():
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(YOUNG_SMALL_DEPTH, full=True)
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    return model, toas, m, b


@pytest.mark.parametrize("name", ["Glitch", "Wave", "TroposphereDelay"])
def test_young_components_match_reference(young, name):
    model, toas, m, b = young
    got, ref = standin.component_outputs(model, toas, m, b, name)
    assert np.abs(ref).max() > 0
    tol = 1e-13 if name == "TroposphereDelay" else 1e-9
    assert np.abs(got - ref).max() <= tol


@pytest.mark.parametrize("sifunc", [0, 2])
def test_piecewise_and_ifunc_match_reference(sifunc):
    model, toas, m, b = standin.port_and_reference(
        dict(standin.SMALL_YOUNG_SETTINGS, sifunc=sifunc))
    for name in ("PiecewiseSpindown", "IFunc"):
        got, ref = standin.component_outputs(model, toas, m, b, name)
        assert np.abs(ref).max() > 0
        assert np.abs(got - ref).max() <= 1e-9


def test_interp_is_jnp_interp():
    """The port's ``interp`` against ``jnp.interp`` inside the table, on
    its points, outside it, and on an empty interval: within 2 ulps of the
    table's values (XLA's CPU code may fuse fp[i-1] + (delta / dx) df into
    one multiply-add, which the port does not), bitwise at the points and
    outside."""
    from pint_torch.models.ifunc import interp

    xp = np.array([1.0, 2.0, 2.0, 3.5, 7.25])
    fp = np.array([0.3, -1.0, 2.0, 0.125, 4.0])
    x = np.concatenate([np.linspace(-1.0, 9.0, 201), xp])
    got = interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                jnp.asarray(fp)))
    assert np.abs(got - ref).max() <= 4.0 * np.finfo(float).eps
    flat = (x <= xp[0]) | (x >= xp[-1]) | np.isin(x, xp)
    assert np.array_equal(got[flat], ref[flat])


def test_glitch_partials_match_reference(young):
    """GLF0D_1 and GLTD_1 (the grid's axes) and the other fitted glitch
    parameters: design columns within 1e-10 of each column's largest."""
    model, toas, m, b = young
    M, names = m.designmatrix(b)
    Mr, names_r, _ = model.designmatrix(toas)
    Mr = np.asarray(Mr)
    assert names == list(names_r)
    cols = [i for i, n in enumerate(names) if n.startswith("GL")]
    assert {"GLF0D_1", "GLTD_1"} <= {names[i] for i in cols}
    err = np.abs(M.numpy()[:, cols] - Mr[:, cols]).max(axis=0) \
        / np.abs(Mr[:, cols]).max(axis=0)
    assert err.max() <= 1e-10


@pytest.mark.parametrize("key", ["postfit", "downhill", "auto"])
def test_small_young_end_to_end(key):
    """The committed small_young stand-in (piecewise spindown, IFUNC at
    SIFUNC 2): residuals 1e-10 s, the WLS fits' chi2 1e-6 rel, values 1e-2
    sigma, uncertainties 1e-6 rel; ``Fitter.auto``'s class, converged flag
    and steps."""
    from pint_torch import bridge
    from pint_torch.fitter import DownhillWLSFitter, Fitter, WLSFitter
    from pint_torch.residuals import Residuals

    meta, ref = bridge.read_snapshot(bridge.YOUNG_SMALL_PATH)
    rr = meta["reference"]
    assert rr["settings"] == standin.SMALL_YOUNG_SETTINGS
    m, b = bridge.load_snapshot(bridge.YOUNG_SMALL_PATH, device="cpu")
    r = Residuals(b, m).time_resids.numpy()
    assert np.abs(r - ref["ref/time_resids"]).max() <= 1e-10
    if key == "postfit":
        f = WLSFitter(b, m.copy())
        chi2 = f.fit_toas(maxiter=rr["settings"]["fit_maxiter"])
    else:
        f = DownhillWLSFitter(b, m.copy()) if key == "downhill" \
            else Fitter.auto(b, m)
        chi2 = f.fit_toas()
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
