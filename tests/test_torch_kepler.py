"""The port's Kepler cores (``pint_torch/orbital/kepler.py``) against the
JAX package's (``pint_tpu/orbital/kepler.py``) on the CPU.

Seeded orbits, e from 0 to 0.95 with one exactly circular: each core's
state to 1e-13 of its largest component and its Jacobian
(``torch.func.jacfwd``) to 1e-10 of each output's largest partial against
``jax.jacfwd`` -- on the circular orbit all but the eps2 column: there
both cores nudge eps1 to 1e-30, so d om / d eps2 = -1e30 multiplies a
difference that is zero but for rounding, and the column is that
rounding (~1e15 at some t in either package, 0-5 at others); a batch
through ``vmap`` equals the orbits one by one bitwise; the inverses take
a state back to its elements; the committed Kepler snapshot (``pint_torch/data/kepler_reference.npz``) holds the
reference's outputs the card is checked against.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

CORES = ("2d", "3d", "two_body")


def _fns(K):
    return {"2d": (K.kepler_2d, K.Kepler2DParameters),
            "3d": (K.kepler_3d, K.Kepler3DParameters),
            "two_body": (K.kepler_two_body, K.KeplerTwoBodyParameters)}


def _gaps(v, j, vr, jr, x):
    """(value gap of each state's largest, Jacobian gap of each output's
    largest partial), maxima over the orbits ``x`` (rows of inputs); an
    exactly circular orbit's eps2 column is left out (module docstring)."""
    x = np.atleast_2d(x)
    keep = np.ones(j.shape, dtype=bool).reshape(len(x), *j.shape[-2:])
    keep[(x[:, 2] == 0) & (x[:, 3] == 0), :, 3] = False
    keep = keep.reshape(j.shape)
    dv = np.abs(v - vr).max(-1) / np.abs(vr).max(-1)
    dj = np.where(keep, np.abs(j - jr), 0.0).max(-1) \
        / np.maximum(np.where(keep, np.abs(jr), 0.0).max(-1), 1e-300)
    assert np.isfinite(j).all()
    return float(dv.max()), float(dj.max())


@pytest.mark.parametrize("core", CORES)
def test_kepler_core_matches_reference_values_and_jacfwd(core):
    from pint_tpu.orbital import kepler as R

    from pint_torch.orbital import kepler as P

    x = standin.kepler_inputs(dict(standin.KEPLER_SETTINGS, seed=5, n=12))[
        core]
    rfn, params = _fns(R)[core]
    pfn, _ = _fns(P)[core]
    for row in x:
        vr, jr = rfn(params(*row[:-1]), row[-1])
        v, j = pfn(params(*row[:-1]), row[-1], device="cpu")
        dv, dj = _gaps(v.numpy(), j.numpy(), np.asarray(vr), np.asarray(jr),
                       row)
        assert dv <= 1e-13 and dj <= 1e-10, (core, row, dv, dj)


@pytest.mark.parametrize("core", CORES)
def test_batch_equals_orbits_one_by_one(core):
    from pint_torch.orbital import kepler as P

    x = standin.kepler_inputs(dict(standin.KEPLER_SETTINGS, seed=6, n=5))[
        core]
    fn, params = _fns(P)[core]
    v, j = fn(params(*x[:, :-1].T), x[:, -1], device="cpu")
    assert v.shape[0] == j.shape[0] == len(x)
    for k, row in enumerate(x):
        v1, j1 = fn(params(*row[:-1]), row[-1], device="cpu")
        assert np.array_equal(v[k].numpy(), v1.numpy())
        assert np.array_equal(j[k].numpy(), j1.numpy())


def test_circular_orbit_has_finite_partials():
    """atan2 at (0, 0) has no derivative: eps1 is nudged to 1e-30, so an
    exactly circular orbit's Jacobian is finite, as the reference's."""
    from pint_torch.orbital import kepler as P

    v, j = P.kepler_2d(P.Kepler2DParameters(5.0, 2.0, 0.0, 0.0, 0.3), 7.1,
                       device="cpu")
    assert np.isfinite(v.numpy()).all() and np.isfinite(j.numpy()).all()


@pytest.mark.parametrize("core", CORES)
def test_inverse_round_trips(core):
    """State -> elements -> state: the inverse (host numpy, as the
    reference's) gives back the orbit's elements."""
    from pint_torch.orbital import kepler as P

    x = standin.kepler_inputs(dict(standin.KEPLER_SETTINGS, seed=7, n=6))[
        core][1:]  # the circular orbit has no periastron to recover
    fn, params = _fns(P)[core]
    for row in x:
        el, t = params(*row[:-1]), row[-1]
        v, _ = fn(el, t, device="cpu")
        v = v.numpy()
        if core == "2d":
            back = P.inverse_kepler_2d(v, P.mass(el.a, el.pb), t)
        elif core == "3d":
            back = P.inverse_kepler_3d(v, P.mass(el.a, el.pb), t)
        else:
            back = P.inverse_kepler_two_body(v, t)
        again, _ = fn(back, t, device="cpu")
        assert np.allclose(again.numpy(), v, rtol=1e-9, atol=1e-9 *
                           np.abs(v).max())
        assert abs(back.a / el.a - 1) < 1e-9 and abs(back.pb / el.pb - 1) \
            < 1e-9


def test_host_helpers_match_reference():
    from pint_tpu.orbital import kepler as R

    from pint_torch.orbital import kepler as P

    rng = np.random.default_rng(8)
    for _ in range(10):
        e, M = rng.uniform(0, 0.95), rng.uniform(-np.pi, np.pi)
        for name, args in (("true_from_eccentric", (e, M)),
                           ("eccentric_from_mean", (e, M)),
                           ("mass_partials", (rng.uniform(1, 30),
                                              rng.uniform(0.1, 60))),
                           ("btx_parameters", tuple(rng.uniform(0.1, 1, 5)))):
            got, want = getattr(P, name)(*args), getattr(R, name)(*args)
            np.testing.assert_array_equal(np.hstack(got), np.hstack(want))


def test_committed_kepler_snapshot_matches_the_port():
    """The committed reference outputs, at the bars the card is held to."""
    from pint_torch.bridge import KEPLER_PATH
    from pint_torch.orbital import kepler as P

    z = np.load(KEPLER_PATH, allow_pickle=False)
    import json

    assert json.loads(str(z["settings"])) == standin.KEPLER_SETTINGS
    for core in CORES:
        x = z[f"{core}/inputs"]
        assert x.shape[0] == standin.KEPLER_SETTINGS["n"]
        assert x[0, 2] == x[0, 3] == 0.0  # an exactly circular orbit
        fn, params = _fns(P)[core]
        v, j = fn(params(*x[:, :-1].T), x[:, -1], device="cpu")
        dv, dj = _gaps(v.numpy(), j.numpy(), z[f"{core}/values"],
                       z[f"{core}/jacobian"], x)
        assert dv <= 1e-13 and dj <= 1e-10, (core, dv, dj)
