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
is kept as it is.

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


def _earlier_digest(path) -> str:
    """sha256 (16 hex) of a snapshot's arrays but ``ref/api/`` (name,
    dtype, shape, bytes) and of its ``meta`` without the API's keys."""
    import hashlib

    h = hashlib.sha256()
    with np.load(path, allow_pickle=False) as z:
        for k in sorted(z.files):
            if k == "meta" or k.startswith("ref/api/"):
                continue
            a = z[k]
            h.update(k.encode())
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(np.ascontiguousarray(a).tobytes())
        meta = json.loads(str(z["meta"]))
    meta.pop("top_level", None)
    meta.get("reference", {}).pop("api", None)
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()[:16]


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
            "b1855_noise": standin.NOISE_SETTINGS,
            "kepler": standin.KEPLER_SETTINGS}
#: the committed stand-ins of small depth: no grid
SMALL_DEPTH = ("bt", "dds", "ddh", "small_dd_fbx", "small_bt_piecewise",
               "small_pta", "small_young", "small_wb")
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
    model, toas = standin.make_standin(settings, full=not small)
    if settings.get("wideband"):
        arrays = standin.export_wideband_snapshot(model, toas, settings)
    else:
        export = standin.export_snapshot if model.has_correlated_errors \
            else standin.export_wls_snapshot
        arrays = export(model, toas, settings, chunk=chunk,
                        grid=not small and bool(settings.get("grid", True)))
    np.savez_compressed(path, **arrays)


def _add_api(path: str, which: str) -> None:
    """Add the API's reference outputs (``standin.export_api``) to the
    committed stand-in at ``path``: the arrays already there stay as they
    are, and the model rebuilt from the settings must export the same
    state bitwise."""
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
    before = dict(arrays)
    standin.export_api(model, toas, which, arrays, meta)
    for k, v in arrays.items():
        if k in before and v is not before[k] or k not in before \
                and not k.startswith("ref/api/"):
            raise SystemExit(f"export_api wrote {k} outside ref/api/")
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
    ap.add_argument("--settings", choices=sorted(SETTINGS), default="b1855",
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
                         "b1855_noise: NOISE_SETTINGS (the noise fit); "
                         "kepler: the Kepler cores' outputs")
    ap.add_argument("--api", action="store_true",
                    help="add the API's reference outputs to the committed "
                         "file at --write, keeping its arrays")
    args = ap.parse_args()
    if args.api:
        _add_api(args.write, args.settings)
    else:
        _write(args.write, args.chunk, SETTINGS[args.settings],
               args.settings in SMALL_DEPTH)
