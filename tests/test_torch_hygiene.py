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
  parameters) follows its model and batch onto the card, the streaming
  engine follows its fitter's and the serve batcher runs on the card unless
  asked for the CPU.
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
                    REPO / "tools" / "torch_sass_ops.py",
                    REPO / "tools" / "torch_chol_probe.py",
                    REPO / "tools" / "torch_k11_probe.py",
                    REPO / "tools" / "torch_amortized_probe.py",
                    REPO / "tools" / "torch_predict_probe.py",
                    REPO / "tools" / "torch_files_probe.py",
                    REPO / "tools" / "torch_tracking_probe.py"]


def test_import_and_load_pull_in_no_jax():
    code = (
        "import sys\n"
        "import pint_torch, pint_torch.bridge, pint_torch.gls_fitter, "
        "pint_torch.fitter, pint_torch.grid, pint_torch.kernels, "
        "pint_torch.pulsar_ecliptic, pint_torch.wideband, "
        "pint_torch.noisefit, pint_torch.orbital.kepler, "
        "pint_torch.pint_matrix, pint_torch.derived_quantities, "
        "pint_torch.utils, pint_torch.residuals, pint_torch.bayesian, "
        "pint_torch.sampler, pint_torch.mcmc_fitter, "
        "pint_torch.models.priors, pint_torch.runtime.checkpoint, "
        "pint_torch.event_fitter, pint_torch.templates, pint_torch.fftfit, "
        "pint_torch.eventstats, pint_torch.streaming, pint_torch.serving, "
        "pint_torch.kernels.chol_rank_update, pint_torch.toa, "
        "pint_torch.catalog, pint_torch.kernels.hd_cross_lnlike, "
        "pint_torch.amortized, "
        "pint_torch.kernels.compensated_matmul, pint_torch.precision, "
        "pint_torch.autotune, pint_torch.predict, pint_torch.polycos, "
        "pint_torch.observatory, pint_torch.timescales, "
        "pint_torch.ephemeris, pint_torch.tdb_integrated, pint_torch.earth\n"
        "import pint_torch.integrity.robust, pint_torch.integrity.quarantine\n"
        # the reading layer: its modules, then the committed ngc stand-in
        # read from its par and tim files through the C++ parser
        "import pint_torch.native, pint_torch.io.par, pint_torch.io.tim, "
        "pint_torch.pulsar_mjd, pint_torch.toa_select, "
        "pint_torch.models.parameter, pint_torch.models.model_builder, "
        "pint_torch.models.tcb_conversion, "
        "pint_torch.integrity.diagnostics\n"
        "from pint_torch.bridge import NGC_PATH, standin_files\n"
        "from pint_torch.models import get_model_and_toas\n"
        "par, tim = standin_files(NGC_PATH)\n"
        "m, t = get_model_and_toas(str(par), str(tim), device='cpu')\n"
        "t.to_batch(device='cpu', model=m)\n"
        "from pint_torch.bridge import load_snapshot, STANDIN_PATH, "
        "ELL1_PATH, ELL1H_PATH, NGC_PHOFF_PATH, DDK_PATH, DDGR_PATH, "
        "BT_SMALL_PATH, DDS_SMALL_PATH, DDH_SMALL_PATH, BW_PATH, "
        "BW_WAVES_PATH, PTA_PATH, YOUNG_PATH, DD_FBX_SMALL_PATH, "
        "BT_PIECEWISE_SMALL_PATH, PTA_SMALL_PATH, YOUNG_SMALL_PATH, "
        "WB_PATH, WB_SMALL_PATH, WB_WHITE_SMALL_PATH, NOISE_PATH, "
        "PHOTON_PATH, PHOTON_SMALL_PATH, STREAM_PATH, STREAM_SMALL_PATH\n"
        "for p in (STREAM_PATH, STREAM_SMALL_PATH, STANDIN_PATH, ELL1_PATH, "
        "ELL1H_PATH, NGC_PHOFF_PATH, "
        "DDK_PATH, DDGR_PATH, BT_SMALL_PATH, DDS_SMALL_PATH, "
        "DDH_SMALL_PATH, BW_PATH, BW_WAVES_PATH, PTA_PATH, YOUNG_PATH, "
        "DD_FBX_SMALL_PATH, BT_PIECEWISE_SMALL_PATH, PTA_SMALL_PATH, "
        "YOUNG_SMALL_PATH, WB_PATH, WB_SMALL_PATH, WB_WHITE_SMALL_PATH, "
        "NOISE_PATH, PHOTON_PATH, PHOTON_SMALL_PATH):\n"
        "    load_snapshot(p, device='cpu')\n"
        "from pint_torch.bridge import CATALOG_PATH, CATALOG_SMALL_PATH, "
        "load_catalog_snapshot\n"
        "for p in (CATALOG_PATH, CATALOG_SMALL_PATH):\n"
        "    load_catalog_snapshot(p, device='cpu')\n"
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
                                   WB_WHITE_SMALL_PATH, YOUNG_PATH)

    for path in (STANDIN_PATH, ELL1H_PATH, NGC_PATH, NGC_PHOFF_PATH,
                 DDK_PATH, DDGR_PATH, BT_SMALL_PATH, BW_PATH,
                 PTA_SMALL_PATH, YOUNG_PATH, WB_PATH, WB_SMALL_PATH,
                 WB_WHITE_SMALL_PATH, NOISE_PATH):
        with pytest.raises(NoGPUError):
            load_snapshot(path)
    # a model read from par text, and a catalogue read from files, is made
    # on the card unless the caller asks for the CPU
    from pint_torch.bridge import standin_files
    from pint_torch.catalog import ingest_catalog
    from pint_torch.models import get_model, get_model_and_toas

    par, tim = standin_files(NGC_PATH)
    for call in (lambda: get_model(str(par)),
                 lambda: get_model_and_toas(str(par), str(tim)),
                 lambda: ingest_catalog([(str(par), str(tim))])):
        with pytest.raises(NoGPUError):
            call()
    assert get_model(str(par), device="cpu").device.type == "cpu"
    # the Kepler cores take their elements on the host and run on the card
    from pint_torch.orbital import kepler as K

    for fn, params in ((K.kepler_2d, K.Kepler2DParameters),
                       (K.kepler_3d, K.Kepler3DParameters),
                       (K.kepler_two_body, K.KeplerTwoBodyParameters)):
        with pytest.raises(NoGPUError):
            fn(params(*[0.5] * len(params._fields)), 1.0)


@pytest.mark.parametrize("module", ["utils", "derived_quantities",
                                    "pint_matrix", "grid", "fitter",
                                    "bayesian", "sampler", "mcmc_fitter",
                                    "models.priors", "runtime.checkpoint",
                                    "event_fitter", "fftfit", "eventstats",
                                    "templates.lcprimitives",
                                    "templates.lctemplate",
                                    "templates.lcfitters",
                                    "streaming.lowrank", "streaming.cache",
                                    "streaming.update", "streaming.door",
                                    "streaming.__init__", "serving.batcher",
                                    "serving.__init__",
                                    "integrity.quarantine",
                                    "kernels.chol_rank_update", "toa",
                                    "catalog.crosscorr", "catalog.buckets",
                                    "catalog.ingest", "catalog.batchfit",
                                    "catalog.likelihood", "catalog.__init__",
                                    "kernels.hd_cross_lnlike",
                                    "kernels.compensated_matmul",
                                    "amortized.__init__",
                                    "precision.policy",
                                    "precision.compensated",
                                    "precision.tune", "precision.__init__",
                                    "autotune.records", "autotune.manifest",
                                    "autotune.__init__",
                                    "observatory.__init__",
                                    "predict.__init__", "runtime.preflight",
                                    "integrity.doctor"])
def test_api_modules_import_no_jax(module):
    """The API's modules, the Bayesian and MCMC ones, the photon
    domain's, the streaming engine's, the serve batcher's, the
    quarantine gate's, the catalogue's, K10's and K11's wrappers, the
    precision layer's, the autotuner's records', the host layer's
    observatories (with the timescales, ephemeris and Earth they import),
    the predict package (with K13, K14 and the polycos), the preflight
    and the doctor import neither
    ``jax`` nor ``pint_tpu`` (by their source, and in a fresh
    interpreter)."""
    path = REPO / "pint_torch" / f"{module.replace('.', '/')}.py"
    test_no_jax_import_in_port_sources(path)
    code = (f"import sys, pint_torch.{module.replace('.__init__', '')}\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\nsys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["PowellFitter", "tuple_chisq",
                                   "d_delay_d_param", "MCMCFitter",
                                   "MCMCFitterBinnedTemplate",
                                   "StreamingGLS", "ShapeBatcher",
                                   "JointLikelihood",
                                   "tune_precision_segments", "doctor",
                                   "check_device"])
def test_api_entry_points_default_to_the_gpu(entry):
    """A user's call of ``PowellFitter``, ``tuple_chisq``,
    ``d_delay_d_param``, ``MCMCFitter`` (with its ``BayesianTiming``
    and ``EnsembleSampler``), the streaming engine or the serve batcher
    starts from a snapshot loaded on the default device, the card (the
    batcher and its requests take ``device=None`` for it), ``Fitter.doctor``
    or the preflight's ``check_device`` starts on the default device, the
    card: without one it raises ``NoGPUError``; on the CPU, asked for, each
    computes on its batch's device."""
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
        if entry == "MCMCFitter":
            from pint_torch.mcmc_fitter import MCMCFitter
            from pint_torch.sampler import EnsembleSampler

            f = MCMCFitter(b, m, sampler=EnsembleSampler(8, seed=1))
            for p in f.fitkeys:
                f.model[p].uncertainty = 1e-3 * abs(m.value(p)) + 1e-12
            f.set_priors(f)
            assert np.isfinite(f.fit_toas(2, seed=2))
            x = f.bt.batched_posterior().fn(
                torch.tensor(f.sampler.get_chain()[-1], device=b.device))
            assert x.device == b.device
            return f.resids.time_resids
        if entry == "MCMCFitterBinnedTemplate":
            from pint_torch.bridge import PHOTON_SMALL_PATH
            from pint_torch.event_fitter import MCMCFitterBinnedTemplate
            from pint_torch.sampler import EnsembleSampler
            from pint_torch.templates import LCGaussian, LCTemplate

            m, b = load_snapshot(PHOTON_SMALL_PATH, device=device)
            f = MCMCFitterBinnedTemplate(
                b, m, LCTemplate([LCGaussian([0.04, 0.5])], [0.6]),
                sampler=EnsembleSampler(8, seed=1))
            assert np.isfinite(f.fit_toas(2, seed=2))
            return m.phase(b).frac
        if entry in ("StreamingGLS", "ShapeBatcher"):
            from pint_torch.bridge import STREAM_SMALL_PATH
            from pint_torch.gls_fitter import GLSFitter
            from pint_torch.serving import FitRequest, ShapeBatcher
            from pint_torch.streaming import StreamingGLS

            m, b = load_snapshot(STREAM_SMALL_PATH, device=device)
            f = GLSFitter(b.select(np.arange(b.ntoas) < 40, m), m)
            f.fit_toas()
            if entry == "ShapeBatcher":
                q = FitRequest.from_fitter(f)
                assert q.M.device == b.device
                res = ShapeBatcher(device=device).run([q])
                assert np.isfinite(res[0].chi2)
                moved = FitRequest(M=q.M.cpu(), r=q.r.cpu(), w=q.w.cpu(),
                                   phiinv=q.phiinv.cpu(), device=device)
                assert moved.M.device.type == b.device.type
                return moved.r
            eng = StreamingGLS(f)
            o = eng.update_toas(b.select((np.arange(b.ntoas) >= 40)
                                         & (np.arange(b.ntoas) < 48), m))
            assert o.fallback is None and eng.cache.L.device == b.device
            return eng.cache.b
        if entry == "JointLikelihood":
            from pint_torch.bridge import (CATALOG_SMALL_PATH,
                                           load_catalog_snapshot)
            from pint_torch.catalog import (CatalogFitter, JointLikelihood,
                                            ingest_catalog)

            pairs = load_catalog_snapshot(CATALOG_SMALL_PATH, device=device)
            cf = CatalogFitter(ingest_catalog(pairs[:4]))
            cf.fit()
            jl = JointLikelihood(cf, n_modes=2)
            assert jl.G.device == pairs[0][1].device
            assert np.isfinite(jl.lnlike(-14.0, 13.0 / 3.0))
            return jl.cross_batch(np.array([[-14.0, 4.0]]))
        if entry == "doctor":
            f = WLSFitter(b, m)
            f.fit_toas()
            assert "Device: cpu" in f.doctor()
            return f.resids.time_resids
        if entry == "check_device":
            from pint_torch.runtime.preflight import check_device

            prof = check_device(device=device)
            assert prof.platform == "cpu" and prof.mantissa_bits == 52
            return torch.tensor([prof.two_sum_error], dtype=torch.float64,
                                device=device)
        if entry == "tune_precision_segments":
            from pint_torch.precision import tune_precision_segments

            f = WLSFitter(b, m)
            f.fit_toas()
            dec = tune_precision_segments(f, segments=("serve.gram",),
                                          force=True)
            assert dec["serve.gram"].value["compute_dtype"] == "float32"
            return f.resids.time_resids
        return m.d_delay_d_param(b, "DM")

    if not torch.cuda.is_available():
        with pytest.raises(NoGPUError):
            run()
        if entry == "ShapeBatcher":
            from pint_torch.serving import FitRequest, ShapeBatcher

            with pytest.raises(NoGPUError):
                ShapeBatcher()
            with pytest.raises(NoGPUError):
                FitRequest(M=np.zeros((2, 1)), r=np.zeros(2), w=np.ones(2),
                           phiinv=np.zeros(1))
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
    # K8 in its three modes, the density and the log-likelihood sums
    from pint_torch.kernels.photon_lnlike import (BINNED, GAUSS, MIXED,
                                                  photon_lnlike)

    fr = torch.full((2, 5), 0.3, dtype=torch.float64)
    mixed = torch.tensor([0.6, 0.0, 0.04, 0.3, 0.0, 0.4, 0.1, 0.0, 0.0],
                         dtype=torch.float64)
    for mode, tab in ((BINNED, torch.ones(8, dtype=torch.float64)),
                      (GAUSS, torch.tensor([0.4, 0.04, 0.3, 0.6, 0.1],
                                           dtype=torch.float64)),
                      (MIXED, mixed)):
        for dens in (False, True):
            out = photon_lnlike(fr, torch.full((5,), 0.5,
                                               dtype=torch.float64),
                                tab, mode, dens)
            assert bool(torch.isfinite(out).all())
    # K9 alone and fused with a block's ingest, each sign
    from pint_torch.kernels.chol_rank_update import (chol_rank_update,
                                                     stream_ingest)

    L = torch.eye(4, dtype=torch.float64) * 2.0
    V = torch.full((2, 4), 0.5, dtype=torch.float64)
    z4, z2 = torch.zeros(4, dtype=torch.float64), torch.ones(2,
                                                             dtype=torch.float64)
    for sign in (1.0, -1.0):
        assert bool(torch.isfinite(chol_rank_update(L, V, sign)).all())
        out = stream_ingest(L, z4, torch.zeros((), dtype=torch.float64), V,
                            z2, z2, z4, sign)
        assert bool(out[3]) and bool(torch.isfinite(out[0]).all())
    # K10, the catalogue's cross term
    from pint_torch.kernels.hd_cross_lnlike import hd_cross_lnlike

    G = torch.eye(6, dtype=torch.float64) * 1e12
    out = hd_cross_lnlike(G, torch.ones(6, dtype=torch.float64),
                          torch.tensor([-14.0, -np.inf], dtype=torch.float64),
                          torch.tensor([4.33, 4.33], dtype=torch.float64),
                          torch.tensor([1e-8], dtype=torch.float64), 1e8)
    assert bool(torch.isfinite(out).all()) and float(out[1]) == 0.0
    # K12, its gradient, exactly 0 at zero amplitude
    from pint_torch.kernels.hd_cross_lnlike import (GRAD_KERNELS,
                                                    hd_cross_grad)

    D = hd_cross_grad(G, torch.ones(6, dtype=torch.float64),
                      torch.tensor([-14.0, -np.inf], dtype=torch.float64),
                      torch.tensor([4.33, 4.33], dtype=torch.float64),
                      torch.tensor([1e-8], dtype=torch.float64), 1e8)
    assert bool(torch.isfinite(D).all()) and bool((D[1] == 0.0).all())
    # K11, the precision segments' matmul, and its backward, in every
    # mode and dtype
    from pint_torch.kernels.compensated_matmul import (
        BWD_KERNELS, compensated_matmul, compensated_matmul_backward)

    a = torch.ones((2, 3, 20), dtype=torch.float64)
    for ct in ("float32", "bfloat16"):
        for acc in ("native", "f64", "two_sum", "two_prod"):
            out = compensated_matmul(a, a[0].T, ct, acc)
            assert out.shape == (2, 3, 3) and bool((out == 20.0).all())
            g = torch.ones((3, 3), dtype=torch.float64)
            da, db = compensated_matmul_backward(a[0], a[0].T, g, ct, acc)
            assert bool((da == 3.0).all()) and bool((db == 3.0).all())
    # K13 and K14, the predict path's evaluation and fit
    from pint_torch.kernels.polyco_eval import polyco_eval
    from pint_torch.kernels.polyco_fit import polyco_fit

    ip, frac, freq = polyco_eval(fr, fr, fr + 300.0, fr[..., None].repeat(
        1, 1, 12))
    assert bool(torch.isfinite(freq).all()) and bool((frac >= 0).all())
    xs = torch.linspace(-0.99, 0.99, 24, dtype=torch.float64)[None]
    c, rms = polyco_fit(xs, xs * 0.0, 12)
    assert bool((c == 0.0).all()) and float(rms[0]) == 0.0
    counts = kernels.launch_counts()
    tables = [mod.KERNELS for mod in kernels.modules().values()]
    assert set(counts) == {n for t in tables + [GRAD_KERNELS, BWD_KERNELS]
                           for n in t.values()}
    assert len(counts) == 2 + 20 + 2 + 16 + 3 + 6 + 2 + 7 + 4 + 4 + 8 + 8 \
        + 7 + 1 + 1
    assert not any(counts.values())


def test_every_kernel_is_built_without_contraction(tmp_path, monkeypatch):
    """Each kernel's nvcc command carries -fmad=false and no -fmad=true:
    every product and sum of K1-K14 rounds alone, as the twins' torch
    operations do (K7 calls no pow(), the one reason it once was built
    with contraction; K8's density, K9's factor and K10's cross term are
    bitwise their plain versions')."""
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
    # K12's kernels are entry points of K10's source, hd_cross_lnlike
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
                 "solar_wind_pl", "photon_lnlike", "chol_rank_update",
                 "hd_cross_lnlike", "compensated_matmul", "polyco_eval",
                 "polyco_fit"):
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
                    ("small_wb_white_standin.npz", 80),
                    ("b1855_noise_standin.npz", 4005),
                    ("j0030_photon_standin.npz", 32768),
                    ("small_photon_standin.npz", 300),
                    ("j1909_stream_standin.npz", 4005),
                    ("small_stream_standin.npz", 80)):
        assert np.load(REPO / "pint_torch" / "data" / snap,
                       allow_pickle=False)["tdb_hi"].shape == (n,)
    for snap, members in (("pta67_catalog_standin.npz", 67),
                          ("small_catalog_standin.npz", 16)):
        with np.load(REPO / "pint_torch" / "data" / snap,
                     allow_pickle=False) as z:
            assert {k.split("/")[1] for k in z.files
                    if k.startswith("psr/")} == {str(i)
                                                 for i in range(members)}
