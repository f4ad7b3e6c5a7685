"""The solar-wind geometry and components on the CPU.

K7 (``solar_wind_pl``)'s plain twin, whose powers are ``exp(y log x)``,
against the reference's ``solar_wind_geometry_pl``
(``pint_tpu/models/solar_wind.py:50-70``, ``jnp.power``) at power-law
indices 1.5, 2, 2.5, 3 and 4.4 and elongations from 1 to 179 degrees,
within 1e-13 of the uncancelled magnitude A (I_inf + |I|) (and 1e-13 rel
below 150 degrees: XLA's 64-term reduction and its ``pow`` round
otherwise than the twin's ordered loop by a few ulps, which the
cancellation of I_inf + I near opposition magnifies); its partials in
theta and p through ``torch.func`` against ``jax.jacfwd``; per-window
indices with TOAs outside every window.  The components against the
reference on the small stand-ins: SWM 0 and 1 NE_SW with its Taylor series
about SWEPOCH, the SWX windows (disjoint, and overlapping), within
1e-13 s; PLSWNoise's basis.
"""

import copy
import math
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import jacfwd

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

from pint_torch.kernels import solar_wind_pl as K7  # noqa: E402

pytestmark = pytest.mark.torch

THETA = np.radians(np.linspace(1.0, 179.0, 97))
R = np.linspace(490.0, 510.0, 97)


@pytest.mark.parametrize("p", [1.5, 2.0, 2.5, 3.0, 4.4])
def test_geometry_twin_matches_reference(p):
    from pint_tpu.models.solar_wind import solar_wind_geometry_pl

    ref = np.asarray(solar_wind_geometry_pl(jnp.asarray(R), jnp.asarray(THETA),
                                            p))
    pt = torch.full((1, 1), p, dtype=torch.float64)
    got = K7.solar_wind_pl(torch.tensor(R), torch.tensor(THETA)[None], pt,
                           K7.sw_i_inf(pt))[0].numpy()
    # relative to the uncancelled size A (I_inf + |I|) <= 2 A I_inf: past
    # ~170 deg I -> -I_inf and the sum cancels (by 1e7 at p 4.4, 179 deg),
    # so a reordering's ulps grow by that factor relative to the result
    b = R * np.sin(THETA)
    a = (K7.AU_LS / b) ** p * (b / K7.PC_LS)
    i_inf = 0.5 * math.sqrt(math.pi) * math.exp(
        math.lgamma((p - 1.0) / 2.0) - math.lgamma(p / 2.0))
    assert (np.abs(got - ref) <= 1e-13 * 2.0 * a * i_inf).all()
    assert np.abs(got / ref - 1)[THETA < np.radians(150.0)].max() <= 1e-13


@pytest.mark.parametrize("p", [1.5, 2.5])
def test_geometry_partials_match_reference_jacfwd(p):
    """dg/dtheta and dg/dp (through I_inf's gammaln as well) from K7's
    ``jvp`` at B = 2 points, against ``jax.jacfwd``."""
    from pint_tpu.models.solar_wind import solar_wind_geometry_pl

    r = torch.tensor(R)
    th = torch.tensor(THETA)[None].expand(2, -1).clone()
    pt = torch.tensor([[p], [p + 0.1]], dtype=torch.float64)

    def port_p(pp):
        return K7.solar_wind_pl(r, th, pp, K7.sw_i_inf(pp))

    Jp = jacfwd(port_p)(pt)                        # (2, N, 2, 1)
    Jth = jacfwd(lambda t: K7.solar_wind_pl(
        r, t, pt, K7.sw_i_inf(pt)))(th)            # (2, N, 2, N)
    for b in range(2):
        pb = float(pt[b, 0])
        jp = np.asarray(jax.jacfwd(lambda q: solar_wind_geometry_pl(
            jnp.asarray(R), jnp.asarray(THETA), q))(pb))
        jt = np.asarray(jax.jacfwd(lambda t: solar_wind_geometry_pl(
            jnp.asarray(R), t, pb))(jnp.asarray(THETA))).diagonal()
        gp = Jp[b, :, b, 0].numpy()
        gt = Jth[b, :, b, :].diagonal().numpy()
        assert np.abs(gp - jp).max() <= 1e-10 * np.abs(jp).max()
        assert np.abs(gt - jt).max() <= 1e-10 * np.abs(jt).max()


def test_window_indices_pick_each_toas_index():
    """Per-window indices: each TOA's geometry is the one at its window's
    p, 0 outside every window, and the partials in p land on its window."""
    rng = np.random.default_rng(5)
    win = torch.tensor(rng.integers(-1, 3, R.size))
    p = torch.tensor([[1.8, 2.3, 3.1]], dtype=torch.float64)
    th = torch.tensor(THETA)[None]
    g = K7.solar_wind_pl(torch.tensor(R), th, p, K7.sw_i_inf(p), win)
    for k in range(3):
        one = K7.solar_wind_pl(torch.tensor(R), th, p[:, k:k + 1],
                               K7.sw_i_inf(p[:, k:k + 1]))
        assert torch.equal(g[0, win == k], one[0, win == k])
    assert (g[0, win < 0] == 0).all()
    J = jacfwd(lambda pp: K7.solar_wind_pl(torch.tensor(R), th, pp,
                                           K7.sw_i_inf(pp), win))(p)
    for k in range(3):
        off = (win != k)
        assert (J[0, off, 0, k] == 0).all() and (J[0, win == k, 0, k] != 0).all()


# ---------------------------------------------------------------------------
# the components
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_pta():
    return standin.port_and_reference(standin.SMALL_PTA_SETTINGS)


@pytest.fixture(scope="module")
def small_swx():
    """The pta stand-in at small depth (40 epochs x 4): J1713+0747 with
    SWX windows one per conjunction year."""
    return standin.port_and_reference(
        dict(standin.PTA_SETTINGS, n_epochs=40, n_subbands=4))


@pytest.mark.parametrize("swm", [0, 1])
def test_ne_sw_delay_matches_reference(small_pta, swm):
    """SolarWindDispersion's delay, NE_SW with NE_SW1 about SWEPOCH, in the
    spherical (SWM 0) and power-law (SWM 1, through K7) geometries."""
    model, toas, m, b = small_pta
    if swm == 0:
        model = copy.deepcopy(model)
        model.components["SolarWindDispersion"].SWM.value = 0.0
        m = m.copy()
        m.components["SolarWindDispersion"].config["swm"] = 0
    got, ref = standin.component_outputs(model, toas, m, b,
                                         "SolarWindDispersion")
    assert np.abs(ref).max() > 1e-7
    assert np.abs(got - ref).max() <= 1e-13


def test_swx_delay_matches_reference(small_swx):
    model, toas, m, b = small_swx
    got, ref = standin.component_outputs(model, toas, m, b,
                                         "SolarWindDispersionX")
    assert np.abs(ref).max() > 1e-7
    assert np.abs(got - ref).max() <= 1e-13


def test_overlapping_swx_windows_sum_as_the_reference(small_swx):
    """Window 1 stretched over window 2: a TOA in both takes both terms,
    in window order."""
    model, toas, m, b = small_swx
    model = copy.deepcopy(model)
    swx = model.components["SolarWindDispersionX"]
    swx._params_dict["SWXR2_0001"].value = \
        swx._params_dict["SWXR2_0002"].value
    from pint_torch.bridge import load_snapshot

    m2, b2 = load_snapshot(standin.export_state(model, toas), device="cpu")
    masks = m2.components["SolarWindDispersionX"].context["masks"]
    assert int(masks.sum(0).max()) == 2
    got, ref = standin.component_outputs(model, toas, m2, b2,
                                         "SolarWindDispersionX")
    assert np.abs(got - ref).max() <= 1e-13


def test_plswnoise_basis_matches_reference(small_pta):
    model, toas, m, b = small_pta
    U, w = model.components["PLSWNoise"].basis_weight_pair(model, toas)
    Ut, wt = m.components["PLSWNoise"].basis_weight_pair(m, b)
    assert np.array_equal(Ut, np.asarray(U)) and np.array_equal(wt,
                                                                np.asarray(w))
    assert np.abs(Ut).max() > 0
