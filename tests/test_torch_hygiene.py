"""Rules the port keeps: no JAX, float64 throughout, the GPU by default.

* ``import pint_torch`` and loading a snapshot leave ``jax`` and
  ``pint_tpu`` out of ``sys.modules`` (checked in a fresh interpreter);
* no module of ``pint_torch``, nor ``chip_smoke.py`` or the port's tools
  (``tools/torch_grid_profile.py``, ``tools/torch_kernel_variants.py``,
  ``tools/torch_sass_ops.py``), imports either;
* every kernel is built with ``-fmad=false``;
* the slice's outputs are float64 and the global default dtype is
  untouched;
* entry points run on the card unless the caller asks for the CPU: the
  snapshots (the wideband and noise fits run on the batch's device) and
  the Kepler cores; the fitter, residuals, model and grid API
  (``PowellFitter``, ``tuple_chisq``, ``d_delay_d_param``, the derived
  parameters) follows its model and batch onto the card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "pint_tpu")


def _port_sources():
    files = sorted((REPO / "pint_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py",
                    REPO / "tools" / "torch_grid_profile.py",
                    REPO / "tools" / "torch_kernel_variants.py",
                    REPO / "tools" / "torch_sass_ops.py"]


def test_import_and_load_pull_in_no_jax():
    code = (
        "import sys\n"
        "import pint_torch, pint_torch.bridge, pint_torch.gls_fitter, "
        "pint_torch.fitter, pint_torch.grid, pint_torch.kernels, "
        "pint_torch.pulsar_ecliptic, pint_torch.wideband, "
        "pint_torch.noisefit, pint_torch.orbital.kepler, "
        "pint_torch.pint_matrix, pint_torch.derived_quantities, "
        "pint_torch.utils, pint_torch.residuals\n"
        "import pint_torch.integrity.robust\n"
        "from pint_torch.bridge import load_snapshot, STANDIN_PATH, "
        "ELL1_PATH, ELL1H_PATH, NGC_PHOFF_PATH, DDK_PATH, DDGR_PATH, "
        "BT_SMALL_PATH, DDS_SMALL_PATH, DDH_SMALL_PATH, BW_PATH, "
        "BW_WAVES_PATH, PTA_PATH, YOUNG_PATH, DD_FBX_SMALL_PATH, "
        "BT_PIECEWISE_SMALL_PATH, PTA_SMALL_PATH, YOUNG_SMALL_PATH, "
        "WB_PATH, WB_SMALL_PATH, NOISE_PATH\n"
        "for p in (STANDIN_PATH, ELL1_PATH, ELL1H_PATH, NGC_PHOFF_PATH, "
        "DDK_PATH, DDGR_PATH, BT_SMALL_PATH, DDS_SMALL_PATH, "
        "DDH_SMALL_PATH, BW_PATH, BW_WAVES_PATH, PTA_PATH, YOUNG_PATH, "
        "DD_FBX_SMALL_PATH, BT_PIECEWISE_SMALL_PATH, PTA_SMALL_PATH, "
        "YOUNG_SMALL_PATH, WB_PATH, WB_SMALL_PATH, NOISE_PATH):\n"
        "    load_snapshot(p, device='cpu')\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {n}"


def test_outputs_are_float64_and_default_dtype_untouched():
    from pint_torch.bridge import STANDIN_PATH, load_snapshot
    from pint_torch.residuals import Residuals

    before = torch.get_default_dtype()
    m, b = load_snapshot(STANDIN_PATH, device="cpu")
    for t in (b.tdb.hi, b.tdb.lo, b.tdb_s.hi, b.freq, b.ssb_obs_pos):
        assert t.dtype == torch.float64
    ph = m.phase(b)
    assert ph.int_.dtype == ph.frac.dtype == torch.float64
    assert m.delay(b).dtype == torch.float64
    assert Residuals(b, m).time_resids.dtype == torch.float64
    dmx = m.components["DispersionDMX"].context["masks"]
    assert dmx.dtype == torch.float64
    assert torch.get_default_dtype() == before


def test_entry_points_default_to_the_gpu():
    from pint_torch import NoGPUError, resolve_device
    from pint_torch.bridge import STANDIN_PATH, load_snapshot

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(NoGPUError):
        resolve_device(None)
    from pint_torch.bridge import (BT_SMALL_PATH, BW_PATH, DDGR_PATH,
                                   DDK_PATH, ELL1H_PATH, NGC_PATH,
                                   NGC_PHOFF_PATH, NOISE_PATH,
                                   PTA_SMALL_PATH, WB_PATH, WB_SMALL_PATH,
                                   YOUNG_PATH)

    for path in (STANDIN_PATH, ELL1H_PATH, NGC_PATH, NGC_PHOFF_PATH,
                 DDK_PATH, DDGR_PATH, BT_SMALL_PATH, BW_PATH,
                 PTA_SMALL_PATH, YOUNG_PATH, WB_PATH, WB_SMALL_PATH,
                 NOISE_PATH):
        with pytest.raises(NoGPUError):
            load_snapshot(path)
    # the Kepler cores take their elements on the host and run on the card
    from pint_torch.orbital import kepler as K

    for fn, params in ((K.kepler_2d, K.Kepler2DParameters),
                       (K.kepler_3d, K.Kepler3DParameters),
                       (K.kepler_two_body, K.KeplerTwoBodyParameters)):
        with pytest.raises(NoGPUError):
            fn(params(*[0.5] * len(params._fields)), 1.0)


@pytest.mark.parametrize("module", ["utils", "derived_quantities",
                                    "pint_matrix", "grid", "fitter"])
def test_api_modules_import_no_jax(module):
    """The API's modules import neither ``jax`` nor ``pint_tpu`` (by their
    source, and in a fresh interpreter)."""
    path = REPO / "pint_torch" / f"{module}.py"
    test_no_jax_import_in_port_sources(path)
    code = (f"import sys, pint_torch.{module}\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["PowellFitter", "tuple_chisq",
                                   "d_delay_d_param"])
def test_api_entry_points_default_to_the_gpu(entry):
    """A user's call of ``PowellFitter``, ``tuple_chisq`` or
    ``d_delay_d_param`` starts from a snapshot loaded on the default
    device, the card: without one it raises ``NoGPUError``; on the CPU,
    asked for, each computes on its batch's device."""
    from pint_torch import NoGPUError
    from pint_torch.bridge import NGC_PATH, load_snapshot
    from pint_torch.fitter import PowellFitter, WLSFitter
    from pint_torch.grid import tuple_chisq

    def run(device=None):
        m, b = load_snapshot(NGC_PATH, device=device)
        if entry == "PowellFitter":
            f = PowellFitter(b, m)
            f.fit_toas(maxiter=1)
            return f.resids.time_resids
        if entry == "tuple_chisq":
            f = WLSFitter(b, m)
            f.fit_toas()
            c2, _ = tuple_chisq(f, ("F0",), [[m.value("F0")]], niter=1)
            assert np.isfinite(c2).all()
            return f.resids.time_resids
        return m.d_delay_d_param(b, "DM")

    if not torch.cuda.is_available():
        with pytest.raises(NoGPUError):
            run()
    out = run("cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float64


def test_cpu_tensors_never_reach_a_kernel():
    from pint_torch import kernels
    from pint_torch.kernels.dd_binary import dd_binary
    from pint_torch.kernels.ell1_binary import ell1_binary
    from pint_torch.kernels.wls_lstsq import wls_lstsq

    kernels.reset_counts()
    tt0 = torch.zeros((2, 5), dtype=torch.float64)
    params = torch.tensor([[12.3, 0, 0, 9.2, 0, 1e-5, 0, 276.0, 0, 0.27,
                            0.99, 0, 0, 0, 0, 0]] * 2, dtype=torch.float64)
    d = dd_binary(tt0, params)
    assert d.shape == (2, 5) and bool(torch.isfinite(d).all())
    from pint_torch.kernels.dd_binary import BT, DDGR, DDK

    pgr = params.clone()
    pgr[:, 8:11] = torch.tensor([1e-9, 1.3e-6, 20.0], dtype=torch.float64)
    toa = (torch.zeros_like(tt0), torch.zeros_like(tt0),
           torch.full_like(tt0, 0.9))
    for mode, p, x in ((BT, params, None), (DDGR, pgr, None),
                       (DDK, params, toa)):
        d = dd_binary(tt0, p, mode, x)
        assert d.shape == (2, 5) and bool(torch.isfinite(d).all())
    p4 = torch.tensor([[1.53, 0, 0, 1.9, 0, 1e-7, -1e-7, 0, 0, 0, 0, 0.2,
                        0.99]] * 2, dtype=torch.float64)
    for ell1k in (False, True):
        d = ell1_binary(tt0, p4, ell1k)
        assert d.shape == (2, 5) and bool(torch.isfinite(d).all())
    p4h = torch.cat([p4[:, :11], torch.tensor(
        [[8.4e-7, 0.0, 0.94]] * 2, dtype=torch.float64)], dim=1)
    for mode in (2, 3):
        d = ell1_binary(tt0, p4h, mode)
        assert d.shape == (2, 5) and bool(torch.isfinite(d).all())
    x, sv, _ = wls_lstsq(torch.eye(5, 3, dtype=torch.float64)[None],
                         torch.ones((1, 5), dtype=torch.float64))
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(sv).all())
    # K6 in its three forms, feeding K2 and K4 their orbit inputs; K2's
    # BTX; K7 with and without windows
    from pint_torch.kernels.binary_orbits import binary_orbits
    from pint_torch.kernels.dd_binary import BTX
    from pint_torch.kernels.solar_wind_pl import solar_wind_pl, sw_i_inf

    t = torch.linspace(-1e7, 1e7, 5, dtype=torch.float64)[None]
    for form, nfb, nw, c in ((0, 2, 0, [8.3e-5, -4e-20]),
                             (1, 0, 1, [0.14, 1e-4, -1e-4, 4e-8]),
                             (2, 1, 1, [8.3e-5, 1e-4, -1e-4, 4e-8])):
        orb = binary_orbits(t, torch.tensor([c], dtype=torch.float64), form,
                            nfb, nw, 10.0)
        assert all(bool(torch.isfinite(o).all()) for o in orb)
        assert bool(torch.isfinite(dd_binary(t, params[:1], orb=orb)).all())
        assert bool(torch.isfinite(ell1_binary(t, p4[:1], orb=orb)).all())
    d = dd_binary(tt0, params, BTX, (torch.full_like(tt0, 9.2),))
    assert d.shape == (2, 5) and bool(torch.isfinite(d).all())
    p = torch.tensor([[2.0, 2.5]], dtype=torch.float64)
    for win in (None, torch.tensor([0, 1, -1, 1, 0])):
        g = solar_wind_pl(torch.full((5,), 499.0, dtype=torch.float64),
                          torch.full((1, 5), 0.5, dtype=torch.float64), p,
                          sw_i_inf(p), win)
        assert bool(torch.isfinite(g).all())
    counts = kernels.launch_counts()
    assert set(counts) == {n for mod in kernels.modules().values()
                           for n in mod.KERNELS.values()}
    assert len(counts) == 2 + 20 + 2 + 16 + 3 + 6 + 2
    assert not any(counts.values())


def test_every_kernel_is_built_without_contraction(tmp_path, monkeypatch):
    """Each kernel's nvcc command carries -fmad=false and no -fmad=true:
    every product and sum of K1-K7 rounds alone, as the twins' torch
    operations do (K7 calls no pow(), the one reason it once was built
    with contraction)."""
    from pint_torch import kernels
    from pint_torch.kernels import _build

    cmds = {}

    class Nvcc:
        def __init__(self, cmd, **kw):
            cmds[Path(cmd[-1]).stem] = cmd
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Nvcc)
    _build.build(kernels.NAMES)
    assert set(cmds) == set(kernels.NAMES)
    for name, cmd in cmds.items():
        assert "-fmad=false" in cmd and "-fmad=true" not in cmd, name
    assert not hasattr(_build, "CONTRACTED")
    code = [line.split("//")[0] for line in (
        REPO / "pint_torch" / "kernels" / "csrc" /
        "solar_wind_pl.cu").read_text().splitlines()]
    assert not any("pow(" in line for line in code)


def test_kernel_sources_ship_with_the_package():
    csrc = REPO / "pint_torch" / "kernels" / "csrc"
    for name in ("spin_phase", "dd_binary", "schur_cholesky_solve",
                 "ell1_binary", "wls_lstsq", "binary_orbits",
                 "solar_wind_pl"):
        src = (csrc / f"{name}.cu").read_text()
        assert "extern \"C\"" in src and f"{name}_launch" in src
    from pint_torch import kernels

    assert set(kernels.NAMES) == {p.stem for p in csrc.glob("*.cu")}
    for snap, n in (("b1855_standin.npz", 4005),
                    ("b1855_dmx15_standin.npz", 4005),
                    ("j1909_ell1_standin.npz", 4005),
                    ("j1909_ell1h_standin.npz", 4005),
                    ("ngc6440e_standin.npz", 62),
                    ("ngc6440e_phoff_standin.npz", 62),
                    ("j1713_ddk_standin.npz", 4005),
                    ("b1913_ddgr_standin.npz", 4005),
                    ("small_bt_standin.npz", 80),
                    ("small_dds_standin.npz", 80),
                    ("small_ddh_standin.npz", 80),
                    ("j0023_bw_standin.npz", 4005),
                    ("j0023_bw_waves_standin.npz", 4005),
                    ("j1713_pta_standin.npz", 4005),
                    ("vela_young_standin.npz", 4005),
                    ("small_dd_fbx_standin.npz", 80),
                    ("small_bt_piecewise_standin.npz", 80),
                    ("small_pta_standin.npz", 80),
                    ("small_young_standin.npz", 80),
                    ("b1855_wb_standin.npz", 890),
                    ("small_wb_standin.npz", 80),
                    ("b1855_noise_standin.npz", 4005)):
        assert np.load(REPO / "pint_torch" / "data" / snap,
                       allow_pickle=False)["tdb_hi"].shape == (n,)
