"""Each timing-model component of the port against the reference package.

The small B1855-shaped stand-in (DD binary, DMX, FD, a receiver JUMP, two
``-f`` groups with EFAC/EQUAD/ECORR, power-law red noise; 80 TOAs) is
simulated by ``pint_tpu`` and carried into the port through a snapshot.
Each delay component gets the reference's own accumulated delay as input,
so a component is checked on its own; then the whole delay and phase chain
is checked end to end.
"""

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


@pytest.fixture(scope="module")
def pair():
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    return model, toas, m, b


DELAYS = ["AstrometryEquatorial", "SolarSystemShapiro", "DispersionDM",
          "DispersionDMX", "BinaryDD", "FD"]


@pytest.mark.parametrize("name", DELAYS)
def test_component_delay_matches_reference(pair, name):
    """|delay difference| <= 1e-12 s on identical inputs (measured: 0, and
    2e-21 s for the solar-system Shapiro term)."""
    model, toas, m, b = pair
    jb = toas.to_batch()
    jctx = model._build_context(toas)
    jpv, pv = model._const_pv(), m.const_pv()
    acc_j = jnp.zeros(len(toas))
    acc_t = torch.zeros((1, len(toas)), dtype=torch.float64)
    comps = {type(c).__name__: c for c in m.delay_components}
    for c in model.delay_components:
        n = type(c).__name__
        dj = np.asarray(c.delay_func(jpv, jb, jctx[n], acc_j))
        if n == name:
            tc = comps[n]
            dt = tc.delay_func(pv, b, tc.build_context(b), acc_t)
            assert dt.dtype == torch.float64
            assert np.abs(dt.numpy().ravel() - dj).max() <= 1e-12
            return
        acc_j = acc_j + dj
        acc_t = acc_t + torch.tensor(dj, dtype=torch.float64)[None]
    raise AssertionError(f"{name} not in the reference model")


def test_phase_components_match_reference(pair):
    model, toas, m, b = pair
    jb = toas.to_batch()
    jctx = model._build_context(toas)
    jpv, pv = model._const_pv(), m.const_pv()
    delay = model.delay(toas)
    comps = {type(c).__name__: c for c in m.phase_components}
    for c in model.phase_components:
        n = type(c).__name__
        pj = c.phase_func(jpv, jb, jctx[n], jnp.asarray(delay))
        tc = comps[n]
        pt = tc.phase_func(pv, b, tc.build_context(b),
                           torch.tensor(delay, dtype=torch.float64)[None])
        np.testing.assert_array_equal(pt.int_.numpy().ravel(),
                                      np.asarray(pj.int_))
        assert np.abs(pt.frac.numpy().ravel()
                      - np.asarray(pj.frac)).max() <= 1e-12


def test_total_delay_and_phase_match_reference(pair):
    """Total delay within 1e-12 s and phase with equal integer parts and
    |d frac| <= 1e-9 cycles.  Measured: 8.5e-14 s and 1.5e-11 cycles --
    the reference's jitted evaluation rounds differently from its own eager
    arithmetic by that much, and the port equals the eager arithmetic."""
    model, toas, m, b = pair
    d = m.delay(b).numpy()
    assert np.abs(d - np.asarray(model.delay(toas))).max() <= 1e-12
    ph, pj = m.phase(b), model.phase(toas)
    np.testing.assert_array_equal(ph.int_.numpy(), np.asarray(pj.int_))
    assert np.abs(ph.frac.numpy() - np.asarray(pj.frac)).max() <= 1e-9


def test_binary_barycentric_time_matches_reference(pair):
    model, toas, m, b = pair
    acc = model.delay(toas, cutoff_component="BinaryDD", include_last=False)
    tj = model.components["BinaryDD"]._tt0(model._const_pv(), toas.to_batch(),
                                           jnp.asarray(acc))
    tt = m.components["BinaryDD"]._tt0(m.const_pv(), b,
                                       torch.tensor(acc)[None])
    np.testing.assert_array_equal(tt.numpy().ravel(), np.asarray(tj))


def test_noise_components_match_reference(pair):
    model, toas, m, b = pair
    np.testing.assert_array_equal(m.scaled_toa_uncertainty(b),
                                  model.scaled_toa_uncertainty(toas))
    Us, ws, dims = m.noise_basis_by_component(b)
    Uj, wj, dj = model.noise_basis_by_component(toas)
    assert dims == dj
    for U, w, U2, w2 in zip(Us, ws, Uj, wj):
        np.testing.assert_array_equal(U, np.asarray(U2))
        np.testing.assert_array_equal(w, np.asarray(w2))
    U, w = m.noise_model_basis_weight(b)
    Ua, wa = m.augment_basis_for_offset(U, w)
    Uaj, waj = model.augment_basis_for_offset(*model.noise_model_basis_weight(
        toas), n=len(toas))
    np.testing.assert_array_equal(Ua, np.asarray(Uaj))
    np.testing.assert_array_equal(wa, np.asarray(waj))
    assert wa[-1] == 1e10
