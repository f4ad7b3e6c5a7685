"""Snapshots: the reference package's state carried into the port.

The exporter (:func:`_torch_standin.export_snapshot`) needs ``pint_tpu``, so
it runs here; the port only reads.  Running this file as a script writes
the committed full-width B1855+09-shaped stand-in::

    python tests/test_torch_snapshot.py --write pint_torch/data/b1855_standin.npz

The tests check that a small export round-trips through
:func:`pint_torch.bridge.load_snapshot` bitwise, and that the committed
full-width file loads with the stated shapes and was written with the
exporter's current generator settings.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for p in (HERE, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch


@pytest.fixture(scope="module")
def small():
    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    return model, toas, standin.export_state(model, toas)


def test_small_export_round_trips_bitwise(small, tmp_path):
    import torch

    from pint_torch.bridge import load_snapshot, read_snapshot

    model, toas, arrays = small
    path = tmp_path / "small.npz"
    np.savez_compressed(path, **arrays)
    m, b = load_snapshot(str(path), device="cpu")
    jb = toas.to_batch()
    pairs = [(b.tdb.hi, jb.tdb.hi), (b.tdb.lo, jb.tdb.lo),
             (b.tdb_s.hi, jb.tdb_s.hi), (b.tdb_s.lo, jb.tdb_s.lo),
             (b.freq, jb.freq), (b.error_us, jb.error_us),
             (b.ssb_obs_pos, jb.ssb_obs_pos), (b.ssb_obs_vel, jb.ssb_obs_vel),
             (b.obs_sun_pos, jb.obs_sun_pos)]
    for got, want in pairs:
        assert got.dtype == torch.float64
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert b.tdb0 == float(jb.tdb0)
    assert np.array_equal(b.mjds, np.asarray(toas.get_mjds(), np.float64))
    # parameters: every value bitwise, epochs as exact (hi, lo) pairs
    jpv = model._const_pv()
    pv = m.const_pv()
    for name, v in jpv.items():
        if hasattr(v, "hi"):
            assert (pv[name].hi, pv[name].lo) == (float(v.hi), float(v.lo))
        else:
            assert pv[name] == float(v), name
    assert m.free_params == list(model.free_params)
    assert m.design_param_names() == tuple(model.design_param_names())
    # component order and per-TOA contexts
    assert list(m.components) == list(model.components)
    dmx = model.components["DispersionDMX"].build_context(toas)["masks"]
    got = m.components["DispersionDMX"].context["masks"].numpy()
    assert np.array_equal(got, np.asarray(dmx))
    _, again = read_snapshot(str(path))
    assert set(again) == set(arrays) - {"meta"}


def test_round_trip_rejects_unknown_format():
    from pint_torch.bridge import read_snapshot

    with pytest.raises(ValueError):
        read_snapshot({"meta": np.asarray(json.dumps({"format": "other"}))})


def test_committed_full_width_file_loads_with_stated_shapes():
    from pint_torch.bridge import STANDIN_PATH, load_snapshot, read_snapshot

    assert os.path.getsize(STANDIN_PATH) < 8 * 1024 * 1024
    meta, arrays = read_snapshot(STANDIN_PATH)
    m, b = load_snapshot(STANDIN_PATH, device="cpu")
    assert b.ntoas == 4005
    nfree = len(m.free_params)
    assert 85 <= nfree <= 95
    nfit = len([p for p in m.free_params if p not in ("M2", "SINI")])
    assert 85 <= 1 + nfit <= 92
    Us, _, dims = m.noise_basis_by_component(b)
    nu = sum(U.shape[1] for U in Us)
    assert dims["PLRedNoise"][1] == 90
    assert 520 <= nu <= 545
    assert arrays["ref/designmatrix"].shape == (4005, 1 + nfree)
    assert arrays["ref/grid_chi2"].shape == (16, 16)
    # masks travel as booleans
    assert arrays["ctx/DispersionDMX/masks"].dtype == bool
    assert meta["reference"]["grid_chunk"] >= 1


def test_committed_file_records_the_exporters_settings():
    from pint_torch.bridge import STANDIN_PATH, read_snapshot

    meta, _ = read_snapshot(STANDIN_PATH)
    assert meta["reference"]["settings"] == standin.FULL_SETTINGS
    assert meta["reference"]["settings"]["seed"] == 20260729


def _write(path: str, chunk: int) -> None:
    """Simulate the full-width stand-in with the reference package, run its
    fit and grid, and write the snapshot (compressed)."""
    model, toas = standin.make_standin(standin.FULL_SETTINGS, full=True)
    arrays = standin.export_snapshot(model, toas, standin.FULL_SETTINGS,
                                     chunk=chunk)
    np.savez_compressed(path, **arrays)


if __name__ == "__main__":
    import argparse

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", required=True, help="output .npz path")
    ap.add_argument("--chunk", type=int, default=16,
                    help="grid points per reference executable (memory only;"
                         " each point's chi2 is independent of it)")
    args = ap.parse_args()
    _write(args.write, args.chunk)
