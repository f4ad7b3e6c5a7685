"""Snapshots: the reference package's state carried into the port.

The exporter (:func:`_torch_standin.export_snapshot`) needs ``pint_tpu``, so
it runs here; the port only reads.  Running this file as a script writes
the committed full-width stand-ins (B1855+09-shaped GLS ones, the
J1909-3744-shaped WLS ones with ELL1 and ELL1H, and the NGC6440E-shaped
ones of the reference benchmark's secondary cell)::

    python tests/test_torch_snapshot.py --write pint_torch/data/b1855_standin.npz
    python tests/test_torch_snapshot.py --settings dmx15 \
        --write pint_torch/data/b1855_dmx15_standin.npz
    python tests/test_torch_snapshot.py --settings ell1 \
        --write pint_torch/data/j1909_ell1_standin.npz
    python tests/test_torch_snapshot.py --settings ell1h \
        --write pint_torch/data/j1909_ell1h_standin.npz
    python tests/test_torch_snapshot.py --settings ngc \
        --write pint_torch/data/ngc6440e_standin.npz
    python tests/test_torch_snapshot.py --settings ngc_phoff \
        --write pint_torch/data/ngc6440e_phoff_standin.npz
    python tests/test_torch_snapshot.py --settings ddk \
        --write pint_torch/data/j1713_ddk_standin.npz
    python tests/test_torch_snapshot.py --settings ddgr \
        --write pint_torch/data/b1913_ddgr_standin.npz
    python tests/test_torch_snapshot.py --settings bt \
        --write pint_torch/data/small_bt_standin.npz

and ``--settings dds`` / ``ddh`` for ``small_dds_standin.npz`` /
``small_ddh_standin.npz`` (the small stand-ins of the DD family's BT, DDS
and DDH, which ``chip_smoke.py`` drives at small depth); ``--settings bw``,
``bw_waves``, ``pta`` and ``young`` for ``j0023_bw_standin.npz``,
``j0023_bw_waves_standin.npz``, ``j1713_pta_standin.npz`` and
``vela_young_standin.npz``, and ``small_dd_fbx``, ``small_bt_piecewise``,
``small_pta``, ``small_young`` for ``small_<name>_standin.npz``;
``--settings b1855_wb``, ``small_wb`` and ``b1855_noise`` for
``b1855_wb_standin.npz``, ``small_wb_standin.npz`` and
``b1855_noise_standin.npz`` (the wideband fits and the noise fit), and
``kepler`` for ``kepler_reference.npz`` (the Kepler cores' outputs).
``--api`` adds the fitter, residuals, model and grid API's reference
outputs (``_torch_standin.API``) to a committed stand-in in place::

    python tests/test_torch_snapshot.py --settings b1855 --api \
        --write pint_torch/data/b1855_standin.npz

(likewise ``ell1``, ``ngc``, ``bt``, ``bw``, ``pta``, ``b1855_wb``,
``b1855_noise``, ``small_wb``): the stand-in is simulated again, its state
must come out bitwise as committed, and every array already in the file
is kept as it is.  ``--bayes`` adds the Bayesian timing interface's and
the ensemble MCMC's reference outputs (``_torch_standin.BAYES``,
``export_bayes``) the same way::

    python tests/test_torch_snapshot.py --settings ell1 --bayes \
        --write pint_torch/data/j1909_ell1_standin.npz

(likewise ``ddgr``, ``ngc_phoff`` and ``small_wb_white``, the last after
``--settings small_wb_white --write
pint_torch/data/small_wb_white_standin.npz``).  ``--sweep`` adds the
reference's fused 32x32 M2 x SINI ``grid_chisq`` after the first fit
(``_torch_standin.SWEEP``, ``export_sweep``: ``chunk=256``, ``fuse=3``)
under ``ref/sweep/`` the same way, to b1855 and dmx15::

    python tests/test_torch_snapshot.py --settings b1855 --sweep \
        --write pint_torch/data/b1855_standin.npz

``--files`` writes the stand-in's par text and simulated TOAs (the
reference's ``TOAs.write_TOA_file``) as ``pint_torch/data/<stand-in>.par``
and ``.tim`` and adds the reference's run on those files under
``ref/files/`` the same way (b1855, ell1 and ngc)::

    python tests/test_torch_snapshot.py --settings b1855 --files \
        --write pint_torch/data/b1855_standin.npz

``--precision`` adds the precision layer's reference outputs
(``_torch_standin.PRECISION``: the forced reduced-precision fits and grid
of b1855, the serve batcher's requests of j1909_stream, the catalogue fit
and joint likelihood of pta67_catalog, and each one's probes) under
``ref/precision/`` the same way::

    python tests/test_torch_snapshot.py --settings b1855 --precision \
        --write pint_torch/data/b1855_standin.npz
    python tests/test_torch_snapshot.py --settings stream --precision \
        --write pint_torch/data/j1909_stream_standin.npz
    python tests/test_torch_snapshot.py --settings pta67_catalog \
        --precision --write pint_torch/data/pta67_catalog_standin.npz
  The photon stand-ins carry
the photon fitters' reference outputs (``_torch_standin.export_photon``)
from the start::

    python tests/test_torch_snapshot.py --settings photon_j0030 \
        --write pint_torch/data/j0030_photon_standin.npz
    python tests/test_torch_snapshot.py --settings small_photon \
        --write pint_torch/data/small_photon_standin.npz

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


def test_committed_dense_dmx_file_loads_with_stated_shapes():
    """The dense-DMX stand-in: 4005 TOAs, 216 DMX windows of 15 d that each
    hold TOAs at both receivers, 233 free parameters (nt = 232 at the
    grid), the same noise basis, and a reference grid at rung 0."""
    from pint_torch.bridge import DMX15_PATH, load_snapshot, read_snapshot

    assert os.path.getsize(DMX15_PATH) < 8 * 1024 * 1024
    meta, arrays = read_snapshot(DMX15_PATH)
    m, b = load_snapshot(DMX15_PATH, device="cpu")
    assert b.ntoas == 4005
    assert len(m.free_params) == 233
    assert 1 + len([p for p in m.free_params
                    if p not in ("M2", "SINI")]) == 232
    masks = arrays["ctx/DispersionDMX/masks"]
    assert masks.shape == (216, 4005) and masks.dtype == bool
    freq = arrays["freq"]
    for w in masks:
        assert w.sum() > 0 and freq[w].min() < 500.0 < freq[w].max()
    Us, _, dims = m.noise_basis_by_component(b)
    assert dims["PLRedNoise"][1] == 90
    assert 520 <= sum(U.shape[1] for U in Us) <= 545
    assert arrays["ref/designmatrix"].shape == (4005, 234)
    assert arrays["ref/grid_chi2"].shape == (16, 16)
    assert np.isfinite(arrays["ref/postfit_uncertainties"]).all()
    assert (arrays["ref/grid_rungs"] == 0).all()


def test_committed_dense_dmx_file_records_its_settings():
    from pint_torch.bridge import DMX15_PATH, read_snapshot

    meta, _ = read_snapshot(DMX15_PATH)
    settings = meta["reference"]["settings"]
    assert settings == standin.DMX15_SETTINGS
    assert (settings["n_dmx"], settings["dmx_days"]) == (216, 15.0)
    assert {k: v for k, v in settings.items()
            if k not in ("n_dmx", "dmx_days")} == {
        k: v for k, v in standin.FULL_SETTINGS.items()
        if k not in ("n_dmx", "dmx_days")}


def test_committed_ell1_file_loads_with_stated_shapes():
    """The J1909-3744-shaped WLS stand-in: 4005 TOAs, an ELL1 binary and
    ecliptic astrometry, no noise basis (a WLS model), 89 free parameters
    and k = 1 + 87 = 88 at the M2 x SINI grid, the reference's two fits
    and a 16x16 grid at SVD rung 3 everywhere."""
    from pint_torch.bridge import ELL1_PATH, load_snapshot, read_snapshot

    assert os.path.getsize(ELL1_PATH) < 8 * 1024 * 1024
    meta, arrays = read_snapshot(ELL1_PATH)
    m, b = load_snapshot(ELL1_PATH, device="cpu")
    assert b.ntoas == 4005
    assert {"BinaryELL1", "AstrometryEcliptic"} <= set(m.components)
    assert not m.has_correlated_errors
    assert m.noise_basis_by_component(b)[0] == []
    assert len(m.free_params) == 89
    assert 1 + len([p for p in m.free_params
                    if p not in ("M2", "SINI")]) == 88
    assert arrays["ref/designmatrix"].shape == (4005, 90)
    assert arrays["ref/grid_chi2"].shape == (16, 16)
    assert (arrays["ref/grid_rungs"] == 3).all()
    for key in ("postfit", "downhill"):
        assert np.isfinite(arrays[f"ref/{key}_uncertainties"]).all()
    assert meta["reference"]["downhill_converged"] in (True, False)


def test_committed_ell1_file_records_its_settings():
    from pint_torch.bridge import ELL1_PATH, read_snapshot

    meta, _ = read_snapshot(ELL1_PATH)
    settings = meta["reference"]["settings"]
    assert settings == standin.ELL1_SETTINGS
    assert settings["pulsar"] == "J1909-3744"
    assert settings["grid_niter"] == 4


def test_committed_ell1h_file_loads_with_stated_shapes():
    """The J1909-3744-shaped stand-in with BinaryELL1H: 4005 TOAs, H3 and
    STIGMA in place of M2/SINI (STIGMA set, so the exact form), 89 free
    parameters, k = 88 at its H3 x STIGMA grid, the reference's fits and a
    16x16 grid at SVD rung 3; written with ``ELL1H_SETTINGS``."""
    from pint_torch.bridge import ELL1H_PATH, load_snapshot, read_snapshot

    assert os.path.getsize(ELL1H_PATH) < 8 * 1024 * 1024
    meta, arrays = read_snapshot(ELL1H_PATH)
    rr = meta["reference"]
    assert rr["settings"] == standin.ELL1H_SETTINGS
    m, b = load_snapshot(ELL1H_PATH, device="cpu")
    assert b.ntoas == 4005 and "BinaryELL1H" in m.components
    assert m["STIGMA"].value not in (None, 0.0) and m["H4"].value is None
    assert 7e-7 < m["H3"].value < 9e-7
    assert len(m.free_params) == 89
    assert rr["grid_params"] == ["H3", "STIGMA"]
    assert 1 + len([p for p in m.free_params
                    if p not in rr["grid_params"]]) == 88
    assert arrays["ref/grid_chi2"].shape == (16, 16)
    assert (arrays["ref/grid_rungs"] == 3).all()
    assert rr["auto_fitter"] == "DownhillWLSFitter"


@pytest.mark.parametrize("which", ["ngc", "ngc_phoff"])
def test_committed_ngc_files_load_with_stated_shapes(which):
    """The NGC6440E-shaped stand-ins: 62 TOAs, AbsPhase with its TZR row
    (one TOA, GBT, 1949.609 MHz), PhaseOffset in the variant; the F0 x F1
    grid's axes and chi2, both Huber fits; written with their settings."""
    from pint_torch.bridge import (NGC_PATH, NGC_PHOFF_PATH, load_snapshot,
                                   read_snapshot)

    path = NGC_PATH if which == "ngc" else NGC_PHOFF_PATH
    meta, arrays = read_snapshot(path)
    rr = meta["reference"]
    assert rr["settings"] == (standin.NGC_SETTINGS if which == "ngc"
                              else standin.NGC_PHOFF_SETTINGS)
    m, b = load_snapshot(path, device="cpu")
    assert b.ntoas == 62
    tzr = m.components["AbsPhase"].tzr_batch
    assert tzr.ntoas == 1 and float(tzr.freq[0]) == 1949.609
    assert ("PhaseOffset" in m.components) is (which == "ngc_phoff")
    assert rr["grid_params"] == ["F0", "F1"]
    for k in ("ref/grid_f0", "ref/grid_f1"):
        assert arrays[k].shape == (16,)
    assert arrays["ref/grid_chi2"].shape == (16, 16)
    assert arrays["ref/huber_weights"].shape == (62,)
    assert rr["huber_iterations"] >= 1


def test_tzr_row_round_trips_bitwise():
    """The TZR TOA the reference builds on the host travels as a one-row
    batch: every field bitwise, and each component's context for it (the
    PhaseOffset's ``apply`` 0)."""
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(standin.NGC_PHOFF_SETTINGS,
                                       full=False)
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    jb = model.components["AbsPhase"].get_TZR_toas(model).to_batch()
    t = m.components["AbsPhase"].tzr_batch
    assert t.tzr and not b.tzr
    for got, want in ((t.tdb.hi, jb.tdb.hi), (t.tdb.lo, jb.tdb.lo),
                      (t.tdb_s.hi, jb.tdb_s.hi), (t.tdb_s.lo, jb.tdb_s.lo),
                      (t.freq, jb.freq), (t.ssb_obs_pos, jb.ssb_obs_pos),
                      (t.ssb_obs_vel, jb.ssb_obs_vel),
                      (t.obs_sun_pos, jb.obs_sun_pos)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert t.tdb0 == float(jb.tdb0)
    assert t.contexts["PhaseOffset"]["apply"].tolist() == [0.0]
    assert m.components["PhaseOffset"].context["apply"].numpy().all()


@pytest.mark.parametrize("which", ["bt", "dds", "ddh"])
def test_committed_small_dd_family_files_load_with_stated_shapes(which):
    """The small stand-ins of BT, DDS and DDH: 80 TOAs, the binary of
    that name (DDS with SHAPMAX, DDH with H3/STIGMA fitted), the GLS and
    ``Fitter.auto`` fits and no grid; written with their settings."""
    from pint_torch import bridge

    path = getattr(bridge, f"{which.upper()}_SMALL_PATH")
    meta, arrays = bridge.read_snapshot(path)
    rr = meta["reference"]
    assert rr["settings"] == SETTINGS[which]
    m, b = bridge.load_snapshot(path, device="cpu")
    assert b.ntoas == 80 and f"Binary{which.upper()}" in m.components
    fitted = {"bt": {"ECC", "OM"}, "dds": {"SHAPMAX", "M2"},
              "ddh": {"H3", "STIGMA"}}[which]
    assert fitted <= set(m.free_params)
    assert "ref/grid_chi2" not in arrays
    assert rr["auto_fitter"] == "DownhillGLSFitter"
    assert np.isfinite(arrays["ref/auto_uncertainties"]).all()


#: this slice's committed stand-ins: (bridge path, TOAs, components it
#: must hold, grid parameters or None, Fitter.auto's class)
SLICE8 = {
    "bw": ("BW_PATH", 4005, {"BinaryELL1", "AstrometryEcliptic"},
           ["FB0", "FB1"], "DownhillWLSFitter"),
    "bw_waves": ("BW_WAVES_PATH", 4005, {"BinaryELL1"}, None,
                 "DownhillWLSFitter"),
    "pta": ("PTA_PATH", 4005, {"BinaryDDK", "PLDMNoise", "PLChromNoise",
                               "ChromaticCM", "SolarWindDispersionX",
                               "FDJump", "FDJumpDM"}, ["KIN", "KOM"],
            "DownhillGLSFitter"),
    "young": ("YOUNG_PATH", 4005, {"Glitch", "Wave", "TroposphereDelay"},
              ["GLF0D_1", "GLTD_1"], "DownhillWLSFitter"),
    "small_dd_fbx": ("DD_FBX_SMALL_PATH", 80, {"BinaryDD"}, None,
                     "DownhillGLSFitter"),
    "small_bt_piecewise": ("BT_PIECEWISE_SMALL_PATH", 80,
                           {"BinaryBT_piecewise"}, None,
                           "DownhillGLSFitter"),
    "small_pta": ("PTA_SMALL_PATH", 80, {"SolarWindDispersion", "PLSWNoise",
                                         "ChromaticCMX", "WaveX", "DMWaveX",
                                         "CMWaveX", "DelayJump",
                                         "DispersionJump"}, None,
                  "DownhillGLSFitter"),
    "small_young": ("YOUNG_SMALL_PATH", 80, {"PiecewiseSpindown", "IFunc"},
                    None, "DownhillWLSFitter"),
}


@pytest.mark.parametrize("which", list(SLICE8))
def test_committed_slice8_files_load_with_stated_shapes(which):
    """The FBX/ORBWAVES, PTA-noise and young-pulsar stand-ins: written with
    their settings, their TOAs and components, the reference's grid (its
    parameters, 16 x 16, one rung) where they have one, ``Fitter.auto``'s
    class, and under 2 MB each."""
    from pint_torch import bridge

    attr, n, comps, grid, auto = SLICE8[which]
    path = getattr(bridge, attr)
    assert os.path.getsize(path) < 2 * 1024 * 1024
    meta, arrays = bridge.read_snapshot(path)
    rr = meta["reference"]
    assert rr["settings"] == SETTINGS[which]
    m, b = bridge.load_snapshot(path, device="cpu")
    assert b.ntoas == n and comps <= set(m.components)
    assert rr["auto_fitter"] == auto
    if grid is None:
        assert "ref/grid_chi2" not in arrays
    else:
        assert rr["grid_params"] == grid
        assert arrays["ref/grid_chi2"].shape == (16, 16)
        assert len(set(arrays["ref/grid_rungs"].ravel().tolist())) == 1
    binary = next((c for c in m.components.values()
                   if c.category == "pulsar_system"), None)
    if which.startswith("bw"):
        assert binary.config["nfb"] == (4 if which == "bw" else 2)
        assert binary.config["nwaves"] == (0 if which == "bw" else 5)
        assert m["PB"].value is None
    if which == "small_dd_fbx":
        assert (binary.config["nfb"], binary.config["nwaves"]) == (0, 3)


#: this slice's committed stand-ins: (bridge path, TOAs, components it
#: must hold, wideband, Fitter.auto's class, the noise parameters its fit
#: frees)
SLICE9 = {
    "b1855_wb": ("WB_PATH", 890, {"BinaryDD", "DispersionDMX",
                                  "DispersionJump", "ScaleDmError",
                                  "PLRedNoise"}, True,
                 "WidebandDownhillFitter", 6),
    "small_wb": ("WB_SMALL_PATH", 80, {"SolarWindDispersion",
                                       "SolarWindDispersionX", "DMWaveX",
                                       "FDJumpDM", "DispersionJump",
                                       "ScaleDmError"}, True,
                 "WidebandDownhillFitter", 0),
    "b1855_noise": ("NOISE_PATH", 4005, {"BinaryDD", "EcorrNoise",
                                         "PLRedNoise"}, False,
                    "DownhillGLSFitter", 14),
}


@pytest.mark.parametrize("which", list(SLICE9))
def test_committed_slice9_files_load_with_stated_shapes(which):
    """The wideband and noise stand-ins: written with their settings, their
    TOAs, components and DM data, ``Fitter.auto``'s class, the noise fit's
    rounds where its fit frees noise parameters, no grid, and under 2 MB
    each."""
    from pint_torch import bridge

    attr, n, comps, wideband, auto, nfree = SLICE9[which]
    path = getattr(bridge, attr)
    assert os.path.getsize(path) < 2 * 1024 * 1024
    meta, arrays = bridge.read_snapshot(path)
    rr = meta["reference"]
    assert rr["settings"] == SETTINGS[which]
    m, b = bridge.load_snapshot(path, device="cpu")
    assert b.ntoas == n and comps <= set(m.components)
    assert b.wideband == wideband and "ref/grid_chi2" not in arrays
    assert rr["auto_fitter"] == auto
    assert len(rr.get("auto_noise_params", [])) == nfree
    if nfree:
        assert len(rr["auto_noise_rounds"]) == 2
        assert all(r["converged"] for r in rr["auto_noise_rounds"])
    if wideband:
        err = b.dm_error.numpy()
        assert 1e-4 <= err.min() and err.max() <= 5e-4
        for key in ("postfit", "full_cov", "downhill", "lm", "auto"):
            assert np.isfinite(arrays[f"ref/{key}_uncertainties"]).all()


def test_wideband_export_round_trips_bitwise():
    """The DM measurements and errors travel bitwise; narrowband TOAs carry
    none."""
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(standin.SMALL_WB_SETTINGS,
                                       full=False)
    _, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    assert np.array_equal(b.dm.numpy(), np.asarray(toas.get_dms()))
    assert np.array_equal(b.dm_error.numpy(),
                          np.asarray(toas.get_dm_errors()))
    assert b.to("cpu").wideband
    narrow = standin.export_state(*standin.make_standin(
        standin.SMALL_SETTINGS, full=False))
    assert "dm" not in narrow
    assert not load_snapshot(narrow, device="cpu")[1].wideband


def test_pair_parameters_round_trip():
    """WAVEk and IFUNCk are pairs of floats in both packages."""
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(dict(
        standin.YOUNG_SETTINGS, n_epochs=20, n_subbands=4), full=True)
    m, _ = load_snapshot(standin.export_state(model, toas), device="cpu")
    for k in range(1, 11):
        assert m[f"WAVE{k}"].kind == "pair"
        assert list(m[f"WAVE{k}"].value) == [float(v) for v in
                                             model.components["Wave"]
                                             ._params_dict[f"WAVE{k}"].value]
    assert m.const_pv()["WAVE3"] == tuple(m["WAVE3"].value)


@pytest.mark.parametrize("which", ["ddk", "ddgr"])
def test_dd_family_export_round_trips_bitwise(which):
    """A small DDK or DDGR export loads into the port with every parameter
    bitwise (K96 as a bool) and the binary's TOA inputs unchanged."""
    from pint_torch.bridge import load_snapshot

    s = standin.SMALL_DDK_SETTINGS if which == "ddk" \
        else standin.SMALL_DDGR_SETTINGS
    model, toas = standin.make_standin(s, full=False)
    m, b = load_snapshot(standin.export_state(model, toas), device="cpu")
    jpv, pv = model._const_pv(), m.const_pv()
    for name, v in jpv.items():
        if hasattr(v, "hi"):
            assert (pv[name].hi, pv[name].lo) == (float(v.hi), float(v.lo))
        elif name != "K96":
            assert pv[name] == float(v), name
    if which == "ddk":
        assert m["K96"].value is True and m["K96"].kind == "bool"
    jb = toas.to_batch()
    assert np.array_equal(b.ssb_obs_pos.numpy(), np.asarray(jb.ssb_obs_pos))
    assert np.array_equal(b.tdb.hi.numpy(), np.asarray(jb.tdb.hi))


#: the stand-ins that carry the API's reference outputs (``ref/api/``,
#: ``meta["top_level"]``), by bridge path, with the digest of everything
#: they held before: every array but ``ref/api/``, and ``meta`` without
#: ``top_level`` and ``reference["api"]``
API_DIGESTS = {
    "STANDIN_PATH": ("b1855", "7069eab5407dcd77"),
    "ELL1_PATH": ("ell1", "7bff9baef0509fb9"),
    "NGC_PATH": ("ngc", "31da0aeb34defa7d"),
    "BT_SMALL_PATH": ("bt", "6c56478ab3766781"),
    "BW_PATH": ("bw", "1f282a81e6e842a0"),
    "PTA_PATH": ("pta", "362355bd91c3e6cc"),
    "WB_PATH": ("b1855_wb", "b608cd0b554a8fa2"),
    "NOISE_PATH": ("b1855_noise", "795971794b0d10f3"),
    "WB_SMALL_PATH": ("small_wb", "d952071572e0b5f1"),
}


#: reference outputs added after every digest below was taken (the
#: reduced-precision amortized run, the mixed photon template, the
#: full-covariance GLS fits, the reference's run on the stand-in's par and
#: tim files): every digest leaves them out, arrays and
#: ``meta["reference"]`` key alike, so each pins what its file held before
LATER = {"ref/amortized_reduced/": "amortized_reduced",
         "ref/photon_mixed/": "photon_mixed", "ref/full_cov/": "full_cov",
         "ref/files/": "files", "ref/tracking/": "tracking"}


def _digest(path, skip=("ref/api/", "ref/bayes/", "ref/sweep/",
                       "ref/precision/", "ref/amortized/",
                       "ref/predict/")) -> str:
    """sha256 (16 hex) of a snapshot's arrays but those under the
    prefixes ``skip`` and :data:`LATER` (name, dtype, shape, bytes) and of
    its ``meta``
    without their keys (``top_level`` and ``reference["api"]`` for
    ``ref/api/``, ``reference["bayes"]`` for ``ref/bayes/``,
    ``reference["precision"]`` for ``ref/precision/``,
    ``reference["amortized"]`` for ``ref/amortized/``,
    ``reference["predict"]`` for ``ref/predict/``; the fused sweep's
    ``ref/sweep/`` has arrays only)."""
    import hashlib

    h = hashlib.sha256()
    skip = tuple(skip) + tuple(LATER)
    with np.load(path, allow_pickle=False) as z:
        for k in sorted(z.files):
            if k == "meta" or k.startswith(skip):
                continue
            a = z[k]
            h.update(k.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        meta = json.loads(str(z["meta"]))
    if "ref/api/" in skip:
        meta.pop("top_level", None)
        meta.get("reference", {}).pop("api", None)
    if "ref/bayes/" in skip:
        meta.get("reference", {}).pop("bayes", None)
    if "ref/precision/" in skip:
        meta.get("reference", {}).pop("precision", None)
    if "ref/amortized/" in skip:
        meta.get("reference", {}).pop("amortized", None)
    if "ref/predict/" in skip:
        meta.get("reference", {}).pop("predict", None)
    for key in LATER.values():
        meta.get("reference", {}).pop(key, None)
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()[:16]


def _earlier_digest(path) -> str:
    """The digest of a snapshot as it was before the API's and the
    Bayesian interface's outputs were added."""
    return _digest(path)


@pytest.mark.parametrize("attr", list(API_DIGESTS))
def test_api_snapshots_keep_every_earlier_key(attr):
    """Adding the API's outputs left every array and the rest of ``meta``
    bitwise as committed before; the API keys are those its
    ``_torch_standin.API`` entry asks for."""
    from pint_torch import bridge

    which, digest = API_DIGESTS[attr]
    path = getattr(bridge, attr)
    assert _earlier_digest(path) == digest
    meta, arrays = bridge.read_snapshot(path)
    spec = standin.API[which]
    api = meta["reference"]["api"]
    keys = {k for k in arrays if k.startswith("ref/api/")}
    for p in spec.get("d_delay", ()):
        assert f"ref/api/d_delay/{p}" in keys
    assert ("update_model" in api) == bool(spec.get("post"))
    assert ("ref/api/tuple_chi2" in keys) == bool(spec.get("grid"))
    assert ("powell" in api) == bool(spec.get("powell"))
    assert ("predicted_chi2" in api) == bool(spec.get("state"))
    assert ("downhill_full_cov" in api) == bool(spec.get("full_cov"))
    if spec.get("grid"):
        assert arrays["ref/api/tuple_chi2"].shape == (standin.API_TUPLES,)
        assert arrays["ref/api/derived_chi2"].shape \
            == (standin.API_GRID_POINTS**2,)


def test_top_level_meta_and_api_keys_round_trip(tmp_path):
    """``meta["top_level"]`` loads into the model's own parameters (START
    and FINISH as exact pairs) and the batch's ephemeris, the ``ref/api/``
    arrays come back bitwise, and a snapshot without ``top_level`` loads
    with the defaults."""
    from pint_torch.bridge import load_snapshot, read_snapshot

    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    model.START.value = 54000.123456789
    model.CHI2.value = 12.5
    model.NTOA.value = 80
    arrays = standin.export_state(model, toas)
    arrays["ref/api/d_delay/PB"] = np.asarray(model.d_delay_d_param(toas,
                                                                     "PB"))
    path = tmp_path / "api.npz"
    np.savez_compressed(path, **arrays)
    m, b = load_snapshot(str(path), device="cpu")
    meta, again = read_snapshot(str(path))
    assert meta["top_level"]["START"][0] == 54000.123456789
    assert m["START"].value == tuple(meta["top_level"]["START"])
    assert (m["CHI2"].value, m["NTOA"].value) == (12.5, 80)
    assert m["PSR"].value == model.PSR.value
    assert m["EPHEM"].value == model.EPHEM.value and b.ephem == toas.ephem
    assert np.array_equal(again["ref/api/d_delay/PB"],
                          arrays["ref/api/d_delay/PB"])
    meta.pop("top_level")
    bare = dict(again, meta=np.asarray(json.dumps(meta)))
    m2, b2 = load_snapshot(bare, device="cpu")
    assert m2["START"].value is None and m2["CHI2"].value is None
    assert m2["DILATEFREQ"].value is False and b2.ephem is None
    assert m2.free_params == m.free_params


#: the stand-ins that carry the Bayesian interface's and the ensemble
#: MCMC's reference outputs (``ref/bayes/``), by bridge path, with the
#: digest of everything they held before: every array but ``ref/bayes/``,
#: and ``meta`` without ``reference["bayes"]``
BAYES_DIGESTS = {
    "ELL1_PATH": ("ell1", "15f67a9adcffe330"),
    "DDGR_PATH": ("ddgr", "b470bef0e49e11ec"),
    "NGC_PHOFF_PATH": ("ngc_phoff", "0dc75484e8bbeea5"),
    "WB_WHITE_SMALL_PATH": ("small_wb_white", "4075a4eaea5920c5"),
}


@pytest.mark.parametrize("attr", list(BAYES_DIGESTS))
def test_bayes_snapshots_keep_every_earlier_key(attr):
    """Adding ``ref/bayes/`` left every array and the rest of ``meta``
    bitwise as committed before; the keys hold the prior box, the points
    with their values, the cubes, the walkers and the seeded run at the
    shapes ``_torch_standin.BAYES`` asks for."""
    from pint_torch import bridge

    which, digest = BAYES_DIGESTS[attr]
    path = getattr(bridge, attr)
    # ref/amortized/ and ref/predict/, added later to ell1 and ddgr, are
    # left out as well
    assert _digest(path, ("ref/bayes/", "ref/amortized/", "ref/predict/")) \
        == digest
    meta, arrays = bridge.read_snapshot(path)
    bz = meta["reference"]["bayes"]
    spec = standin.BAYES[which]
    m, _ = bridge.load_snapshot(path, device="cpu")
    nd = len(m.free_params)
    assert bz["params"] == m.free_params
    assert (bz["nwalkers"], bz["nsteps"]) == (spec["nwalkers"],
                                              spec["nsteps"])
    assert bz["seeds"] == standin.BAYES_SEEDS
    P = "ref/bayes/"
    n, k = standin.BAYES_POINTS, standin.BAYES_CUBES
    shapes = {"pmin": (nd,), "pmax": (nd,), "points": (n, nd),
              "lnposterior": (n,), "lnprior": (n,), "chi2": (n,),
              "cubes": (k, nd), "prior_transform": (k, nd),
              "pos": (spec["nwalkers"], nd),
              "walker_chain": (spec["nwalkers"], nd, spec["nsteps"]),
              "lnprob": (spec["nsteps"], spec["nwalkers"]),
              "accepted": (spec["nsteps"], spec["nwalkers"]),
              "maxpost_fitvals": (nd,), "stds": (nd,)}
    assert {k[len(P):] for k in arrays if k.startswith(P)} == set(shapes)
    for key, shape in shapes.items():
        assert arrays[P + key].shape == shape, key
    assert int(arrays[P + "accepted"].sum()) == bz["naccepted"]
    assert bz["acceptance"] == bz["naccepted"] / (spec["nwalkers"]
                                                  * spec["nsteps"])
    out = np.isneginf(arrays[P + "lnposterior"])
    assert out[-standin.BAYES_OUTSIDE:].all() and not out[:-8].any()
    inside = (arrays[P + "pos"] >= arrays[P + "pmin"]) \
        & (arrays[P + "pos"] <= arrays[P + "pmax"])
    assert inside.all()


def test_committed_small_wb_white_file_loads_with_stated_shapes():
    """The small wideband stand-in with white noise only: 80 wideband TOAs,
    the DM terms of ``small_wb`` without ECORR or red noise (so no
    correlated errors), the wideband fits; written with its settings."""
    from pint_torch import bridge

    path = bridge.WB_WHITE_SMALL_PATH
    assert os.path.getsize(path) < 2 * 1024 * 1024
    meta, arrays = bridge.read_snapshot(path)
    rr = meta["reference"]
    assert rr["settings"] == standin.SMALL_WB_WHITE_SETTINGS
    assert rr["settings"]["rn_modes"] == 0 and not rr["settings"]["ecorr"]
    m, b = bridge.load_snapshot(path, device="cpu")
    assert b.ntoas == 80 and b.wideband and not m.has_correlated_errors
    assert {"SolarWindDispersion", "SolarWindDispersionX", "DMWaveX",
            "FDJumpDM", "ScaleDmError"} <= set(m.components)
    assert not {"EcorrNoise", "PLRedNoise"} & set(m.components)
    assert rr["auto_fitter"] == "WidebandDownhillFitter"
    assert "ref/grid_chi2" not in arrays
    for key in ("postfit", "full_cov", "downhill", "lm", "auto"):
        assert np.isfinite(arrays[f"ref/{key}_uncertainties"]).all()


def test_bayes_keys_round_trip(tmp_path):
    """``ref/bayes/`` arrays and ``meta["reference"]["bayes"]`` come back
    bitwise, and the snapshot loads as without them."""
    from pint_torch.bridge import load_snapshot, read_snapshot

    model, toas = standin.make_standin(standin.SMALL_SETTINGS, full=False)
    arrays = standin.export_state(model, toas)
    bare_m, _ = load_snapshot(dict(arrays), device="cpu")
    meta = json.loads(str(arrays["meta"]))
    meta["reference"] = {"bayes": {"nwalkers": 4, "params": ["F0"]}}
    arrays["meta"] = np.asarray(json.dumps(meta))
    rng = np.random.default_rng(1)
    arrays["ref/bayes/walker_chain"] = rng.standard_normal((4, 1, 3))
    arrays["ref/bayes/accepted"] = rng.random((3, 4)) < 0.5
    path = tmp_path / "bayes.npz"
    np.savez_compressed(path, **arrays)
    meta2, again = read_snapshot(str(path))
    assert meta2["reference"]["bayes"] == meta["reference"]["bayes"]
    for k in ("ref/bayes/walker_chain", "ref/bayes/accepted"):
        assert again[k].dtype == arrays[k].dtype
        assert np.array_equal(again[k], arrays[k])
    m, _ = load_snapshot(str(path), device="cpu")
    assert m.free_params == bare_m.free_params


#: every committed stand-in's digest over all its arrays and its whole
#: ``meta`` (:func:`_digest` skipping only the fused sweep's
#: ``ref/sweep/``, added later to the two b1855 files, the precision
#: layer's ``ref/precision/``, added later to b1855, j1909_stream and
#: pta67_catalog, and amortized inference's ``ref/amortized/``, added
#: later to ell1, ddgr and pta67_catalog): a later slice adds its own
#: files and keys and leaves these bitwise as committed
STANDIN_DIGESTS = {
    "b1855_standin.npz": "e46ca733e8d5f704",
    "b1855_dmx15_standin.npz": "f7b1a3459359b557",
    "j1909_ell1_standin.npz": "01421e04c4b69221",
    "j1909_ell1h_standin.npz": "f6d8521020ec53f6",
    "ngc6440e_standin.npz": "33880485365f9ab4",
    "ngc6440e_phoff_standin.npz": "c46420e97d28e723",
    "j1713_ddk_standin.npz": "d0ab08c8de54d5a2",
    "b1913_ddgr_standin.npz": "cf1396c98cdd6209",
    "small_bt_standin.npz": "dc4b064fe1907a73",
    "small_dds_standin.npz": "ff19b6eb2b7b0e64",
    "small_ddh_standin.npz": "18833c1737423086",
    "j0023_bw_standin.npz": "072342f8bc85ff35",
    "j0023_bw_waves_standin.npz": "75d1d3a2f250dd54",
    "j1713_pta_standin.npz": "1cecb08c9653b6a0",
    "vela_young_standin.npz": "c0056607984bff1b",
    "small_dd_fbx_standin.npz": "c7fd5aa3dea6ffb6",
    "small_bt_piecewise_standin.npz": "c7c5ee1519ffb468",
    "small_pta_standin.npz": "deb4e49ba4dcca68",
    "small_young_standin.npz": "4389df9ef4ebb4f3",
    "b1855_wb_standin.npz": "f47b91d0e15f04a2",
    "small_wb_standin.npz": "350879e8353040e1",
    "small_wb_white_standin.npz": "de71decd12bfeb87",
    "b1855_noise_standin.npz": "98e4959c97f187a4",
    "j0030_photon_standin.npz": "8e1405a4b33d1e3e",
    "small_photon_standin.npz": "9f4512243849e3ca",
    "j1909_stream_standin.npz": "835be31b2f063300",
    "small_stream_standin.npz": "66e7396ad5f53eab",
    "pta67_catalog_standin.npz": "646cdff793b4bd90",
    "small_catalog_standin.npz": "eaf1f23e39b8a18c",
}


@pytest.mark.parametrize("name", list(STANDIN_DIGESTS))
def test_committed_standins_are_bitwise_as_committed(name):
    path = os.path.join(REPO, "pint_torch", "data", name)
    assert _digest(path, skip=("ref/sweep/", "ref/precision/",
                               "ref/amortized/", "ref/predict/")) \
        == STANDIN_DIGESTS[name]


#: the stand-ins that carry amortized inference's reference outputs
#: (``ref/amortized/``), by bridge path, with the digest of everything
#: they held before: every array but ``ref/amortized/``, and ``meta``
#: without ``reference["amortized"]``
AMORTIZED_DIGESTS = {
    "ELL1_PATH": "01421e04c4b69221",
    "DDGR_PATH": "cf1396c98cdd6209",
    "CATALOG_PATH": "8840f2a96a48fb9e",
    "CATALOG_SMALL_PATH": "eaf1f23e39b8a18c",
}


@pytest.mark.parametrize("attr", list(AMORTIZED_DIGESTS))
def test_amortized_snapshots_keep_every_earlier_key(attr):
    """Adding ``ref/amortized/`` left every array and the rest of ``meta``
    bitwise as committed before; its keys hold the flow's initial
    parameters, the first step's samples, lnpost, logq and gradient, the
    trace, the state before the last step with its gradient, the final
    weights, the kept draws with the moments of all, and the log-prob
    points with their values, at the shapes ``_torch_standin.AMORTIZED``
    asks for; ell1's and ddgr's also the same run op by op (its trace,
    final weights and the gradient at the compiled run's last state) with
    the compiled ELBO's central differences."""
    from pint_torch import bridge

    path = getattr(bridge, attr)
    assert _digest(path, ("ref/amortized/", "ref/predict/")) \
        == AMORTIZED_DIGESTS[attr]
    meta, arrays = bridge.read_snapshot(path)
    A = meta["reference"]["amortized"]
    spec = standin.AMORTIZED
    assert {k: A[k] for k in spec} == spec
    nd = len(A["labels"])
    P = "ref/amortized/"
    n, steps = spec["n_samples"], spec["steps"]
    shapes = {"z0": (n, nd), "lnpost0": (n,), "logq0": (n,),
              "trace": (steps,),
              "draws": (spec["draws_kept"], nd), "draws_mean": (nd,),
              "draws_std": (nd,), "logprob_points": (spec["logprob_points"],
                                                     nd),
              "logprob": (spec["logprob_points"],)}
    for key, shape in shapes.items():
        assert arrays[P + key].shape == shape, key
    nl = 6 * spec["n_layers"] + 2
    for tag in ("init/leaf_", "grad0/leaf_", "final/leaf_", "state/p_",
                "state/m_", "state/v_", "grad_last/leaf_"):
        got = [k for k in arrays if k.startswith(P + tag)]
        assert len(got) == nl, tag
    assert A["t_state"] == steps - 1
    assert len(A["z_sha256_steps"]) == steps
    op = attr in ("ELL1_PATH", "DDGR_PATH")
    for tag in ("op_by_op/final/leaf_", "op_by_op/grad_last/leaf_"):
        got = [k for k in arrays if k.startswith(P + tag)]
        assert len(got) == (nl if op else 0), tag
    assert (P + "op_by_op/trace" in arrays) == op
    if op:
        assert arrays[P + "op_by_op/trace"].shape == (steps,)
        F = A["op_by_op"]
        assert len(F["fd"]) == len(F["fd_h"]) == 3
    bad = np.isneginf(arrays[P + "logprob"])
    assert int(bad.sum()) == spec["logprob_outside"]
    assert bad[:spec["logprob_outside"]].all()
    assert ("k12_grad" in {k[len(P):] for k in arrays if k.startswith(P)}) \
        == (attr == "CATALOG_SMALL_PATH")


@pytest.mark.parametrize("which", ["photon_j0030", "small_photon"])
def test_committed_photon_files_load_with_stated_shapes(which):
    """The photon stand-ins: barycentred photons (infinite frequency, the
    observatory at the barycentre) with their weights, the J0030+0451 par
    with the settings' free parameters, the reference's photon outputs at
    the settings' shapes; both files together under 4 MB."""
    from pint_torch import bridge

    path = bridge.PHOTON_PATH if which == "photon_j0030" \
        else bridge.PHOTON_SMALL_PATH
    assert os.path.getsize(bridge.PHOTON_PATH) \
        + os.path.getsize(bridge.PHOTON_SMALL_PATH) < 4 * 1024 * 1024
    s = SETTINGS[which]
    meta, arrays = bridge.read_snapshot(path)
    R = meta["reference"]["photon"]
    assert R["settings"] == s == meta["reference"]["settings"]
    m, b = bridge.load_snapshot(path, device="cpu")
    n, nd, P = s["photons"], len(s["free"]), "ref/photon/"
    assert b.ntoas == n and b.weights.shape == (n,)
    assert m.free_params == s["free"] == R["params"]
    assert np.isinf(arrays["freq"]).all() and not arrays["ssb_obs_pos"].any()
    shapes = {"phases": (n,), "points": (standin.PHOTON_POINTS, nd),
              "lnposterior_binned": (standin.PHOTON_POINTS,),
              "lnposterior_analytic": (standin.PHOTON_POINTS,)}
    for kind in ("binned", "analytic"):
        shapes.update({
            f"{kind}/pos": (s["nwalkers"], nd),
            f"{kind}/walker_chain": (s["nwalkers"], nd, s["nsteps"]),
            f"{kind}/lnprob": (s["nsteps"], s["nwalkers"]),
            f"{kind}/accepted": (s["nsteps"], s["nwalkers"]),
            f"{kind}/maxpost_fitvals": (nd,), f"{kind}/stds": (nd,)})
        assert int(arrays[f"{P}{kind}/accepted"].sum()) \
            == R[kind]["naccepted"]
        out = np.isneginf(arrays[f"{P}lnposterior_{kind}"])
        assert out[-standin.PHOTON_OUTSIDE:].all() \
            and not out[:-standin.PHOTON_OUTSIDE].any()
    assert {k[len(P):] for k in arrays if k.startswith(P)} == set(shapes)
    for key, shape in shapes.items():
        assert arrays[P + key].shape == shape, key


@pytest.mark.parametrize("which", ["stream", "small_stream"])
def test_committed_stream_files_load_with_stated_shapes(which):
    """The stream stand-ins: every TOA with the duplicate check's keys and
    the coverage values, the schedule in the settings, K = 150 (23) frame
    columns, one outcome per operation (the appends, a quarantine and its
    release), each stored state a K x K factor, both checkpoint cuts; the
    full-width one the serve outputs of its seven requests; both files
    together under 2 MB."""
    from pint_torch import bridge

    path = bridge.STREAM_PATH if which == "stream" \
        else bridge.STREAM_SMALL_PATH
    assert os.path.getsize(bridge.STREAM_PATH) \
        + os.path.getsize(bridge.STREAM_SMALL_PATH) < 2 * 1024 * 1024
    s = SETTINGS[which]
    meta, arrays = bridge.read_snapshot(path)
    R = meta["reference"]["stream"]
    assert R["settings"] == s == meta["reference"]["settings"]
    m, b = bridge.load_snapshot(path, device="cpu")
    n = s["n_epochs"] * s["n_subbands"]
    assert b.ntoas == n and b.obs.shape == (n,) and b.mjd_lo.shape == (n,)
    assert set(b.coverage) == {"clock_end", "ephem_span"}
    base, rows, dup, quarantine = bridge.stream_schedule(meta)
    assert len(base) + sum(len(r) for r in rows) == n
    assert quarantine == s["stream"]["quarantine"]
    K, nops = (150, 43) if which == "stream" else (23, 7)
    assert R["K"] == K and len(R["ops"]) == nops
    assert [o["kind"] for o in R["ops"]] == ["append"] * len(rows) \
        + ["downdate", "release"]
    assert R["ops"][dup]["quarantined"] == 1
    P, nd = "ref/stream/", len(R["design"])
    for key in ("values", "errors"):
        assert arrays[P + key].shape == (nops, nd)
    for name in R["states"]:
        assert arrays[f"{P}{name}/L"].shape == (K, K)
    assert set(R["checkpoint"]) == {"cut_half", "cut_first"}
    if which == "stream":
        srv = meta["reference"]["serve"]
        assert len(srv["requests"]) == 7 and len(srv["groups"]) == 2
        for i in range(7):
            assert arrays[f"ref/serve/{i}/fused_dx"].shape[0] == srv["steps"]


#: the committed full-width stand-ins, by the exporter's ``--settings``
SETTINGS = {"b1855": standin.FULL_SETTINGS,
            "dmx15": standin.DMX15_SETTINGS,
            "ell1": standin.ELL1_SETTINGS,
            "ell1h": standin.ELL1H_SETTINGS,
            "ngc": standin.NGC_SETTINGS,
            "ngc_phoff": standin.NGC_PHOFF_SETTINGS,
            "ddk": standin.DDK_SETTINGS,
            "ddgr": standin.DDGR_SETTINGS,
            "bt": standin.SMALL_BT_SETTINGS,
            "dds": standin.SMALL_DDS_SETTINGS,
            "ddh": standin.SMALL_DDH_SETTINGS,
            "bw": standin.BW_SETTINGS,
            "bw_waves": standin.BW_WAVES_SETTINGS,
            "pta": standin.PTA_SETTINGS,
            "young": standin.YOUNG_SETTINGS,
            "small_dd_fbx": standin.SMALL_DD_FBX_SETTINGS,
            "small_bt_piecewise": standin.SMALL_BT_PIECEWISE_SETTINGS,
            "small_pta": standin.SMALL_PTA_SETTINGS,
            "small_young": standin.SMALL_YOUNG_SETTINGS,
            "b1855_wb": standin.WB_SETTINGS,
            "small_wb": standin.SMALL_WB_SETTINGS,
            "small_wb_white": standin.SMALL_WB_WHITE_SETTINGS,
            "b1855_noise": standin.NOISE_SETTINGS,
            "kepler": standin.KEPLER_SETTINGS,
            "photon_j0030": standin.PHOTON_SETTINGS,
            "small_photon": standin.SMALL_PHOTON_SETTINGS,
            "stream": standin.STREAM_SETTINGS,
            "small_stream": standin.SMALL_STREAM_SETTINGS,
            "pta67_catalog": standin.PTA67_CATALOG_SETTINGS,
            "small_catalog": standin.SMALL_CATALOG_SETTINGS}
#: the committed stand-ins of small depth: no grid
SMALL_DEPTH = ("bt", "dds", "ddh", "small_dd_fbx", "small_bt_piecewise",
               "small_pta", "small_young", "small_wb", "small_wb_white")
#: full-width stand-ins without a grid
NO_GRID = ("bw_waves",)


def _write(path: str, chunk: int, settings: dict, small: bool = False) -> None:
    """Simulate a stand-in with the reference package, run its fits and
    (but at ``small`` depth or where its settings have none) its grid, and
    write the snapshot (compressed); the Kepler settings write the Kepler
    cores' reference outputs."""
    if settings is standin.KEPLER_SETTINGS:
        np.savez_compressed(path, **standin.export_kepler(settings))
        return
    if settings.get("photons"):
        np.savez_compressed(path, **standin.export_photon(settings))
        return
    if settings.get("stream"):
        np.savez_compressed(path, **standin.export_stream(settings))
        return
    if settings.get("catalog"):
        np.savez_compressed(path, **standin.export_catalog(settings))
        return
    model, toas = standin.make_standin(settings, full=not small)
    if settings.get("wideband"):
        arrays = standin.export_wideband_snapshot(model, toas, settings)
    else:
        export = standin.export_snapshot if model.has_correlated_errors \
            else standin.export_wls_snapshot
        arrays = export(model, toas, settings, chunk=chunk,
                        grid=not small and bool(settings.get("grid", True)))
    np.savez_compressed(path, **arrays)


def _rebuilt(path: str, which: str):
    """(model, toas, arrays, meta) of the committed stand-in at ``path``,
    its model and TOAs simulated again from the settings: their exported
    state must come out bitwise as committed."""
    settings = SETTINGS[which]
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    model, toas = standin.make_standin(settings,
                                       full=which not in SMALL_DEPTH)
    state = standin.export_state(model, toas)
    fresh = json.loads(str(state.pop("meta")))
    for k, v in state.items():
        if not np.array_equal(v, arrays[k]):
            raise SystemExit(f"{k} is not as committed: rebuild differs")
    if {k: v for k, v in fresh.items() if k != "top_level"} \
            != {k: v for k, v in meta.items()
                if k not in ("reference", "top_level")}:
        raise SystemExit("the rebuilt model's meta is not as committed")
    return model, toas, arrays, meta


def _add_outputs(path: str, which: str, export, prefix: str) -> None:
    """Add a family of reference outputs (``export``: ``export_api`` under
    ``ref/api/``, ``export_bayes`` under ``ref/bayes/``) to the committed
    stand-in at ``path``: the arrays already there stay as they are, and
    the model rebuilt from the settings must export the same state
    bitwise."""
    model, toas, arrays, meta = _rebuilt(path, which)
    before = dict(arrays)
    export(model, toas, which, arrays, meta)
    for k, v in arrays.items():
        if k in before and v is not before[k] or k not in before \
                and not k.startswith(prefix):
            raise SystemExit(f"{export.__name__} wrote {k} outside {prefix}")
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)


#: the stand-ins committed as par and tim files too (``--files``)
FILES = ("b1855", "ell1", "ngc")


def _add_files(path: str, which: str) -> None:
    """Write the stand-in's par and tim files beside the committed
    stand-in at ``path`` (:func:`pint_torch.bridge.standin_files`) and add
    the reference's run on them under ``ref/files/``
    (:func:`_torch_standin.export_files`); the model rebuilt from the
    settings must export the committed state bitwise, and the arrays
    already there but ``ref/files/`` stay as they are."""
    from pint_torch.bridge import standin_files

    if which not in FILES:
        raise SystemExit(f"--files takes --settings {', '.join(FILES)}")
    _, _, arrays, meta = _rebuilt(path, which)
    par, tim = standin_files(path)
    f_arrays, f_meta = standin.export_files(
        SETTINGS[which], which not in SMALL_DEPTH, str(par), str(tim))
    arrays = {k: v for k, v in arrays.items()
              if not k.startswith("ref/files/")}
    arrays.update({f"ref/files/{k}": v for k, v in f_arrays.items()})
    meta["reference"]["files"] = f_meta
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)
    print(f"{which}: reference round trip through {tim} bitwise: "
          f"{f_meta['roundtrip_bitwise']} (differs: "
          f"{f_meta['roundtrip_differs']})")


def _add_tracking(path: str, which: str) -> None:
    """Add the reference's run of the tracking phase on the stand-in's
    committed par and tim files (:func:`_torch_standin.export_tracking`)
    under ``ref/tracking/`` of the committed stand-in at ``path``; every
    other array and the rest of ``meta`` stay as they are."""
    from pint_torch.bridge import standin_files

    if which not in FILES:
        raise SystemExit(f"--tracking takes --settings {', '.join(FILES)}")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files
                  if not k.startswith("ref/tracking/")}
    meta = json.loads(str(arrays["meta"]))
    before = _digest(path)
    par, tim = standin_files(path)
    t_arrays, t_meta = standin.export_tracking(which, str(par), str(tim))
    arrays.update({f"ref/tracking/{k}": v for k, v in t_arrays.items()})
    meta["reference"]["tracking"] = t_meta
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)
    if _digest(path) != before:
        raise SystemExit("adding ref/tracking/ changed an earlier array")


#: the committed stand-in of each P2 member
PREDICT_FILES = {"b1855": "b1855_standin.npz", "ell1": "j1909_ell1_standin.npz",
                 "ddk": "j1713_ddk_standin.npz",
                 "ddgr": "b1913_ddgr_standin.npz"}


def _add_predict(path: str, which: str) -> None:
    """Add ``ref/predict/`` (``_torch_standin.PREDICT``): P1's read path
    to the committed ngc stand-in at ``path``, or (``p2``) P2's joint
    generation to the four members' committed stand-ins in the directory
    ``path`` and b1855's read path to b1855's; each model rebuilt from its
    settings must export its committed state bitwise, and the arrays
    already there stay as they are."""
    if which == "ngc":
        members = {"ngc": path}
    elif which == "p2":
        members = {n: os.path.join(path, f)
                   for n, f in PREDICT_FILES.items()}
    else:
        raise SystemExit("--predict takes --settings ngc or p2")
    built = {n: _rebuilt(p, n) for n, p in members.items()}
    models = {n: b[0] for n, b in built.items()}
    arrays = {n: b[2] for n, b in built.items()}
    metas = {n: b[3] for n, b in built.items()}
    before = {n: dict(a) for n, a in arrays.items()}
    if which == "ngc":
        standin.export_predict_serve(models["ngc"], "ngc", arrays["ngc"],
                                     metas["ngc"])
    else:
        standin.export_predict_gen(models, arrays, metas)
        standin.export_predict_serve(models["b1855"], "b1855",
                                     arrays["b1855"], metas["b1855"])
    for n, p in members.items():
        for k, v in arrays[n].items():
            if k in before[n] and v is not before[n][k] \
                    or k not in before[n] and not k.startswith("ref/predict/"):
                raise SystemExit(f"the export wrote {k} outside ref/predict/")
        arrays[n]["meta"] = np.asarray(json.dumps(metas[n]))
        np.savez_compressed(p, **arrays[n])


def _add_precision(path: str, which: str) -> None:
    """Add the precision layer's reference outputs (``ref/precision/``) to
    the committed b1855, j1909_stream or pta67_catalog stand-in at
    ``path``; the arrays already there stay as they are."""
    if which == "b1855":
        _add_outputs(path, which, standin.export_precision, "ref/precision/")
        return
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    before = dict(arrays)
    if which == "stream":
        standin.export_precision_serve(arrays, meta)
    elif which == "pta67_catalog":
        standin.export_precision_catalog(SETTINGS[which], arrays, meta)
    else:
        raise SystemExit(f"no precision outputs for {which}")
    for k, v in arrays.items():
        if k in before and v is not before[k] or k not in before \
                and not k.startswith("ref/precision/"):
            raise SystemExit(f"the export wrote {k} outside ref/precision/")
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)


def _add_amortized(path: str, which: str) -> None:
    """Add the reference's amortized run (``ref/amortized/``) to the
    committed ell1, ddgr, pta67_catalog or small_catalog stand-in at
    ``path`` (small_catalog's with K12's reference gradients; ell1's and
    ddgr's with the same run op by op, ``ref/amortized/op_by_op/``); the
    arrays already there stay as they are."""
    if which in ("ell1", "ddgr"):
        _add_outputs(path, which, standin.export_amortized,
                     "ref/amortized/")
        _add_outputs(path, which, standin.export_amortized_op_by_op,
                     "ref/amortized/op_by_op/")
        return
    if which not in ("pta67_catalog", "small_catalog"):
        raise SystemExit(f"no amortized outputs for {which}")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    before = dict(arrays)
    standin.export_amortized_catalog(SETTINGS[which], arrays, meta,
                                     k12_grad=which == "small_catalog")
    for k, v in arrays.items():
        if k in before and v is not before[k] or k not in before \
                and not k.startswith("ref/amortized/"):
            raise SystemExit(f"the export wrote {k} outside ref/amortized/")
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)


def _add_photon_mixed(path: str, which: str) -> None:
    """Add ``ref/photon_mixed/`` (``_torch_standin.export_photon_mixed``)
    to the committed photon stand-in at ``path``; the arrays already there
    stay as they are."""
    if which not in ("photon_j0030", "small_photon"):
        raise SystemExit(f"no photon_mixed outputs for {which}")
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    before = dict(arrays)
    standin.export_photon_mixed(SETTINGS[which], arrays, meta)
    for k, v in arrays.items():
        if k in before and v is not before[k] or k not in before \
                and not k.startswith("ref/photon_mixed/"):
            raise SystemExit(f"the export wrote {k} outside "
                             "ref/photon_mixed/")
    arrays["meta"] = np.asarray(json.dumps(meta))
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
    ap.add_argument("--settings", choices=sorted(SETTINGS) + ["p2"],
                    default="b1855",
                    help="b1855: FULL_SETTINGS (72 DMX windows of 45 d); "
                         "dmx15: DMX15_SETTINGS (216 windows of 15 d); "
                         "ell1: ELL1_SETTINGS (the J1909-3744-shaped WLS "
                         "stand-in); ell1h: ELL1H_SETTINGS (the same with "
                         "H3/STIGMA); ngc, ngc_phoff: NGC_SETTINGS, "
                         "NGC_PHOFF_SETTINGS (bench.py's FALLBACK_PAR, 62 "
                         "TOAs; with PHOFF); ddk: DDK_SETTINGS (the "
                         "J1713+0747-shaped GLS stand-in, KIN x KOM grid); "
                         "ddgr: DDGR_SETTINGS (the B1913+16-shaped WLS "
                         "stand-in, MTOT x M2 grid); bt, dds, ddh: the "
                         "small stand-in as BT, DDS, DDH (no grid); bw, "
                         "bw_waves: BW_SETTINGS, BW_WAVES_SETTINGS (the "
                         "J0023+0923-shaped black widow on FBX orbits, FB0 "
                         "x FB1 grid; with ORBWAVES, no grid); pta: "
                         "PTA_SETTINGS (J1713+0747 with chromatic and "
                         "solar-wind terms, KIN x KOM grid); young: "
                         "YOUNG_SETTINGS (Vela-shaped, GLF0D_1 x GLTD_1 "
                         "grid); small_dd_fbx, small_bt_piecewise, "
                         "small_pta, small_young: their small stand-ins "
                         "(no grid); b1855_wb, small_wb: WB_SETTINGS, "
                         "SMALL_WB_SETTINGS (the wideband fits); "
                         "small_wb_white: SMALL_WB_WHITE_SETTINGS (white "
                         "noise only); "
                         "b1855_noise: NOISE_SETTINGS (the noise fit); "
                         "kepler: the Kepler cores' outputs; photon_j0030, "
                         "small_photon: PHOTON_SETTINGS, "
                         "SMALL_PHOTON_SETTINGS (the photon fitters); "
                         "stream, small_stream: STREAM_SETTINGS, "
                         "SMALL_STREAM_SETTINGS (the streaming engine; the "
                         "full-width one also the serve batcher); "
                         "pta67_catalog, small_catalog: "
                         "PTA67_CATALOG_SETTINGS, SMALL_CATALOG_SETTINGS "
                         "(the PTA catalogue: ingest, buckets, fits, joint "
                         "likelihood, chain)")
    ap.add_argument("--tracking", action="store_true",
                    help="with --settings b1855, ell1 or ngc: add the "
                         "reference's run of the tracking phase on the "
                         "committed par and tim files (ref/tracking/) to "
                         "the committed file at --write")
    ap.add_argument("--files", action="store_true",
                    help="write the stand-in's par and tim files beside the "
                         "committed file at --write and add the reference's "
                         "run on them (ref/files/), keeping its arrays")
    ap.add_argument("--api", action="store_true",
                    help="add the API's reference outputs to the committed "
                         "file at --write, keeping its arrays")
    ap.add_argument("--bayes", action="store_true",
                    help="add the Bayesian timing interface's and the "
                         "ensemble MCMC's reference outputs to the committed "
                         "file at --write, keeping its arrays")
    ap.add_argument("--sweep", action="store_true",
                    help="add the reference's fused 32x32 grid sweep "
                         "(ref/sweep/) to the committed file at --write, "
                         "keeping its arrays")
    ap.add_argument("--amortized", action="store_true",
                    help="add the reference's amortized-inference run "
                         "(ref/amortized/) to the committed ell1, ddgr, "
                         "pta67_catalog or small_catalog file at --write, "
                         "keeping its arrays")
    ap.add_argument("--amortized-op-by-op", action="store_true",
                    help="add the reference's amortized run evaluated op "
                         "by op (ref/amortized/op_by_op/) to the committed "
                         "ell1 or ddgr file at --write, beside its "
                         "ref/amortized/")
    ap.add_argument("--amortized-reduced", action="store_true",
                    help="add the reference's amortized run under the "
                         "forced float32 policy, jitted and op by op "
                         "(ref/amortized_reduced/), to the committed ell1 "
                         "file at --write")
    ap.add_argument("--photon-mixed", action="store_true",
                    help="add the mixed closed-form template's reference "
                         "outputs (ref/photon_mixed/) to the committed "
                         "photon file at --write")
    ap.add_argument("--full-cov", action="store_true",
                    help="add the narrowband GLS fitters' full-covariance "
                         "fits (ref/full_cov/) to the committed b1855_noise "
                         "file at --write")
    ap.add_argument("--precision", action="store_true",
                    help="add the reference's forced reduced-precision "
                         "outputs and probes (ref/precision/) to the "
                         "committed b1855, stream or pta67_catalog file at "
                         "--write, keeping its arrays")
    ap.add_argument("--predict", action="store_true",
                    help="add the phase-prediction path's reference outputs "
                         "(ref/predict/): with --settings ngc, P1's read "
                         "path to the committed file at --write; with "
                         "--settings p2, P2's generation over b1855, ell1, "
                         "ddk and ddgr (and b1855's read path) to their "
                         "committed files in the directory --write")
    args = ap.parse_args()
    if args.tracking:
        _add_tracking(args.write, args.settings)
    elif args.files:
        _add_files(args.write, args.settings)
    elif args.predict:
        _add_predict(args.write, args.settings)
    elif args.amortized:
        _add_amortized(args.write, args.settings)
    elif args.amortized_reduced:
        _add_outputs(args.write, args.settings,
                     standin.export_amortized_reduced,
                     "ref/amortized_reduced/")
    elif args.photon_mixed:
        _add_photon_mixed(args.write, args.settings)
    elif args.full_cov:
        _add_outputs(args.write, args.settings, standin.export_full_cov,
                     "ref/full_cov/")
    elif args.amortized_op_by_op:
        _add_outputs(args.write, args.settings,
                     standin.export_amortized_op_by_op,
                     "ref/amortized/op_by_op/")
    elif args.precision:
        _add_precision(args.write, args.settings)
    elif args.sweep:
        _add_outputs(args.write, args.settings, standin.export_sweep,
                     "ref/sweep/")
    elif args.api:
        _add_outputs(args.write, args.settings, standin.export_api,
                     "ref/api/")
    elif args.bayes:
        _add_outputs(args.write, args.settings, standin.export_bayes,
                     "ref/bayes/")
    else:
        _write(args.write, args.chunk, SETTINGS[args.settings],
               args.settings in SMALL_DEPTH)
