"""The port's autotuner records and resolve layer (``pint_torch/autotune``)
against the JAX package's ``pint_tpu/autotune`` on the CPU.

* the records (``sweep_record``, ``decision_record``) and schema tags are
  the reference's;
* ``decision_key`` gives the reference's material and sha256 digest for
  the same ``(name, vkey, fingerprint)``, and a manifest either package
  writes at one fingerprint is read by the other;
* the workload vkeys -- ``precision_vkey``, ``grid_chunk_vkey``,
  ``correction_dtype_vkey``, ``solve_rung_vkey`` and the deployment-generic
  ones -- equal the reference's on the small stand-in;
* resolution degrades to the static default as the reference's does (no
  manifest, an unreadable or foreign document, a stale vkey, another
  device's fingerprint: a decision recorded on the CPU never replays on
  the card), a corrupt tuned chunk raises;
* each ported consumer takes its tuned value: ``chunk="auto"``, the GLS
  solve ladder's entry rung, the catalogue's ladders, the stream's block
  ladder, the grid's correction dtype; the searches raise naming ROADMAP
  queue A item 8 and the plan resolves item 9.
"""

import importlib
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

FP = {"platform": "cpu", "device_kind": "x86_64", "torch_version": "t",
      "cpu_flags": "abc"}


@pytest.fixture
def tune_dir(tmp_path):
    """The port's tuning directory for one test, reset after it."""
    from pint_torch import autotune, config

    config.set_tune_dir(str(tmp_path))
    autotune.reset_manifest_singleton()
    yield tmp_path
    config.set_tune_dir(None)
    autotune.reset_manifest_singleton()


@pytest.fixture(scope="module")
def small():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return standin.port_and_reference(standin.SMALL_SETTINGS)


def test_records_are_the_references():
    from pint_tpu import autotune as R
    from pint_tpu.autotune import records as RR

    from pint_torch import autotune as P
    from pint_torch.autotune import records as PR

    assert (P.AUTOTUNE_SCHEMA, P.TUNE_MANIFEST_SCHEMA) \
        == (R.AUTOTUNE_SCHEMA, R.TUNE_MANIFEST_SCHEMA)
    assert sorted(P.__all__) == sorted(R.__all__)
    assert PR.__all__ == RR.__all__
    for kw in (dict(fits_per_sec=1234.5, elapsed_s=1.23456,
                    compile_s=12.345, sanity_ok=True),
               dict(error="RESOURCE_EXHAUSTED", failed_in="warmup_compile",
                    error_detail="vmem"),
               dict(error="x")):
        assert P.sweep_record("cuda", 256, 1024, **kw) \
            == R.sweep_record("cuda", 256, 1024, **kw)
    pdec = P.TuningDecision(name="grid.chunk", value=128, static_default=256,
                            vkey=("grid.chunk", 80, 20, 1), basis="measured",
                            measured={"128": 1.0}, reason="r",
                            created_unix=5.0)
    rdec = R.TuningDecision(name="grid.chunk", value=128, static_default=256,
                            vkey=("grid.chunk", 80, 20, 1), basis="measured",
                            measured={"128": 1.0}, reason="r",
                            created_unix=5.0)
    assert P.decision_record(pdec) == R.decision_record(rdec)
    assert P.decision_record(pdec.to_dict()) == R.decision_record(rdec)


@pytest.mark.parametrize("name,vkey", [
    ("grid.chunk", ("grid.chunk", 4005, 88, 1)),
    ("precision.serve.gram", ("precision", "serve.gram", 1)),
    ("gls.solve_rung", ("gls.solve_rung", (("F0", "1.0"),), 7, 80)),
    ("catalog.buckets", ("catalog.buckets", ((24, 10), (40, 12)))),
    ("update.blocks", ("update.blocks", 1))])
def test_decision_key_digests_are_the_references(name, vkey):
    from pint_tpu.autotune import decision_key as ref

    from pint_torch.autotune import decision_key

    assert decision_key(name, vkey, FP) == ref(name, vkey, FP)
    assert decision_key(name, vkey, dict(FP, platform="cuda"))[1] \
        != ref(name, vkey, FP)[1]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_manifest_either_writes_the_other_reads(writer, tmp_path,
                                                  monkeypatch):
    """At one fingerprint, the document one package records is read, entry
    by entry and field by field, by the other."""
    RM = importlib.import_module("pint_tpu.autotune.manifest")
    PM = importlib.import_module("pint_torch.autotune.manifest")
    for mod in (PM, RM):
        monkeypatch.setattr(mod.TuningManifest, "fingerprint",
                            staticmethod(lambda: dict(FP)))
    W, Rd = (PM, RM) if writer == "port" else (RM, PM)
    path = str(tmp_path / "tuning.json")
    decisions = [
        ("grid.chunk", 64, 128, ("grid.chunk", 80, 20, 1)),
        ("precision.serve.gram",
         {"compute_dtype": "float32", "accumulation": "two_prod",
          "budget": 1e-3, "rel_err": 1.5e-13}, None,
         ("precision", "serve.gram", 1)),
        ("update.blocks", [2, 8, 32], None, ("update.blocks", 1))]
    m = W.TuningManifest(path)
    for name, value, default, vkey in decisions:
        m.record(W.TuningDecision(name=name, value=value,
                                  static_default=default, vkey=vkey,
                                  basis="forced"))
    reader = Rd.TuningManifest(path, writable=False)
    for name, value, _, vkey in decisions:
        body, reason = reader.lookup(name, vkey)
        assert reason is None and body["value"] == value
        assert body["basis"] == "forced"
    body, reason = reader.lookup("grid.chunk", ("grid.chunk", 81, 20, 1))
    assert body is None and "no tuned decision" in reason
    assert reader.digest() == W.TuningManifest(path, writable=False).digest()


def test_vkeys_are_the_references(small):
    from pint_tpu import autotune as RA
    from pint_tpu import precision as R
    from pint_tpu.gls_fitter import GLSFitter as RG

    from pint_torch import autotune as PA
    from pint_torch import precision as P
    from pint_torch.gls_fitter import GLSFitter

    model, toas, m, b = small
    assert b._version == toas._version
    for seg in ("gls.design", "grid.gram", "grid.correction"):
        assert P.precision_vkey(seg, m, b) == R.precision_vkey(seg, model,
                                                               toas)
    for seg in ("serve.gram", "catalog.fit", "catalog.lnlike",
                "flow.coupling"):
        assert P.precision_vkey(seg) == R.precision_vkey(seg)
    assert PA.grid_chunk_vkey(m, b) == RA.grid_chunk_vkey(model, toas)
    assert PA.correction_dtype_vkey(m, b) \
        == RA.correction_dtype_vkey(model, toas)
    assert PA.solve_rung_vkey(GLSFitter(b, m)) \
        == RA.solve_rung_vkey(RG(toas, model))
    shapes = [(40, 12), (24, 10), (40, 12)]
    for name in ("serve_buckets_vkey", "update_blocks_vkey"):
        assert getattr(PA, name)() == getattr(RA, name)()
    assert PA.catalog_buckets_vkey(shapes) == RA.catalog_buckets_vkey(shapes)
    assert PA.plan_axes_vkey("grid") == RA.plan_axes_vkey("grid")
    assert PA.plan_strategy_vkey("grid") == RA.plan_strategy_vkey("grid")
    with pytest.raises(P.policy.UsageError):
        P.precision_vkey("gls.design")
    # any edit of a value or a mask selector moves the model-bound vkey
    before = P.precision_vkey("gls.design", m, b)
    m2 = m.copy()
    m2["M2"].value = m.value("M2") + 1e-9
    assert P.precision_vkey("gls.design", m2, b) != before


def test_resolution_degrades_as_the_references(tune_dir, monkeypatch):
    from pint_torch import autotune, config

    PM = importlib.import_module("pint_torch.autotune.manifest")
    dec = autotune.TuningDecision(name="update.blocks", value=[3, 12],
                                  static_default=None,
                                  vkey=autotune.update_blocks_vkey())
    autotune.manifest().record(dec)
    assert autotune.resolve("update.blocks", autotune.update_blocks_vkey(),
                            None) == ([3, 12], "tuned")
    assert autotune.resolve_update_blocks() == (3, 12)
    # another device: a CPU decision never replays on the card
    monkeypatch.setattr(PM, "device_fingerprint", lambda: dict(
        PM.device_fingerprint(), platform="cuda",
        device_kind="NVIDIA H100 80GB HBM3"))
    assert autotune.resolve("update.blocks", autotune.update_blocks_vkey(),
                            None) == (None, "static")
    assert autotune.resolve_update_blocks() is None
    monkeypatch.undo()
    config.set_tune_dir(str(tune_dir))
    path = tune_dir / "tuning.json"
    for text in ("{not json", json.dumps({"schema": "other/1"}),
                 json.dumps({"schema": autotune.TUNE_MANIFEST_SCHEMA})):
        path.write_text(text)
        assert autotune.resolve("update.blocks",
                                autotune.update_blocks_vkey(),
                                "d") == ("d", "static")
    config.set_tune_dir(None)
    assert autotune.resolve("x", (), 7) == (7, "static")
    assert autotune.resolve_update_blocks() is None
    assert autotune.resolve_correction_dtype(None, None) == "float64"
    assert not PM.enabled()


def test_manifest_writability(tmp_path):
    from pint_torch.autotune.manifest import TuningManifest
    from pint_torch.exceptions import UsageError

    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(UsageError, match="cannot be created"):
        TuningManifest(str(blocker / "sub"))
    m = TuningManifest(str(blocker / "x.json"), writable=False)
    assert m.lookup("a", ()) == (None, f"no tuning manifest at {m.path}")
    assert m.digest() is None and m.to_dict() is None


def _record(name, value, vkey):
    from pint_torch import autotune

    autotune.manifest().record(autotune.TuningDecision(
        name=name, value=value, static_default=None, vkey=vkey,
        basis="measured"))


def test_consumers_take_their_tuned_values(small, tune_dir):
    """``chunk="auto"``, the solve ladder's entry rung, the correction
    dtype and the stream's block ladder each read their manifest
    decision; a corrupt chunk raises."""
    from pint_torch import autotune
    from pint_torch.exceptions import UsageError
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import _resolve_auto_chunk, build_grid_gls_chi2_fn
    from pint_torch.runtime.solve import JITTER_LADDER

    _, _, m, b = small
    assert _resolve_auto_chunk(m, b, "auto") == 128
    _record("grid.chunk", 5, autotune.grid_chunk_vkey(m, b))
    assert _resolve_auto_chunk(m, b, "auto") == 5
    assert _resolve_auto_chunk(m, b, "auto", gls=False) is None
    _record("grid.chunk", 0, autotune.grid_chunk_vkey(m, b))
    with pytest.raises(UsageError, match="corrupt"):
        autotune.resolve_grid_chunk(m, b)
    f = GLSFitter(b, m.copy())
    _record("gls.solve_rung", 2, autotune.solve_rung_vkey(f))
    f.fit_toas(maxiter=1)
    assert f._solve_ladder == JITTER_LADDER[2:]
    g = GLSFitter(b, f.model)
    g.fit_toas(maxiter=1)
    assert g._solve_ladder is None
    # the correction dtype: float32 where recorded for exactly this system
    pts = np.array([[f.model.value("M2"), f.model.value("SINI")]])
    fn64 = build_grid_gls_chi2_fn(f.model, b, ("M2", "SINI"), niter=1,
                                  chunk=1)[0]
    _record("grid.correction_dtype", "float32",
            autotune.correction_dtype_vkey(f.model, b))
    assert autotune.resolve_correction_dtype(f.model, b) == "float32"
    fn32 = build_grid_gls_chi2_fn(f.model, b, ("M2", "SINI"), niter=1,
                                  chunk=1)[0]
    c64, c32 = fn64(pts)[0], fn32(pts)[0]
    assert not np.array_equal(c64, c32)
    assert abs(c32[0] / c64[0] - 1) <= 1e-4
    assert np.array_equal(
        build_grid_gls_chi2_fn(f.model, b, ("M2", "SINI"), niter=1, chunk=1,
                               correction_dtype="float64")[0](pts)[0], c64)
    from pint_torch import precision as P

    with P.use_policy(P.PrecisionPolicy.f64()):
        assert np.array_equal(build_grid_gls_chi2_fn(
            f.model, b, ("M2", "SINI"), niter=1, chunk=1)[0](pts)[0], c64)
        sp = P.segment_spec("grid.correction", f.model, b)
        assert not sp.reduced
    assert P.segment_spec("grid.correction", f.model, b).compute_dtype \
        == "float32"
    with pytest.raises(UsageError):
        build_grid_gls_chi2_fn(f.model, b, ("M2", "SINI"), niter=1, chunk=1,
                               correction_dtype="float16")
    with pytest.raises(UsageError):
        build_grid_gls_chi2_fn(f.model, b, ("M2", "SINI"), niter=1, chunk=1,
                               precision="float32")


def test_stream_and_catalogue_take_their_tuned_ladders(tune_dir):
    from pint_torch import autotune
    from pint_torch.bridge import (CATALOG_SMALL_PATH, STREAM_SMALL_PATH,
                                   load_catalog_snapshot, load_snapshot)
    from pint_torch.catalog import CatalogFitter, ingest_catalog
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.streaming import StreamingGLS

    m, b = load_snapshot(STREAM_SMALL_PATH, device="cpu")
    f = GLSFitter(b.select(np.arange(b.ntoas) < 40, m), m)
    f.fit_toas()
    assert StreamingGLS(f).cache.block_buckets == (4, 16, 64, 256)
    _record("update.blocks", [8, 2], autotune.update_blocks_vkey())
    assert StreamingGLS(f).cache.block_buckets == (2, 8)
    assert StreamingGLS(f, block_buckets=(5,)).cache.block_buckets == (5,)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = ingest_catalog(load_catalog_snapshot(CATALOG_SMALL_PATH,
                                                   device="cpu")[:4])
    learned = CatalogFitter(rep)
    _record("catalog.buckets", {"ntoa": [512], "nfree": [256]},
            autotune.catalog_buckets_vkey(learned.shapes))
    tuned = CatalogFitter(rep)
    assert set(tuned.bucket_plan.buckets) == {(512, 256)}
    assert set(learned.bucket_plan.buckets) != {(512, 256)}
    explicit = CatalogFitter(rep, ntoa_ladder=(1024,), nfree_ladder=(512,))
    assert set(explicit.bucket_plan.buckets) == {(1024, 512)}
    assert autotune.resolve_serve_buckets() is None
    _record("serve.buckets", {"ntoa": [64, 4096], "nfree": [32]},
            autotune.serve_buckets_vkey())
    assert autotune.resolve_serve_buckets() == {"ntoa": (64, 4096),
                                                "nfree": (32,)}


@pytest.mark.parametrize("name", ["Candidate", "chunk_ladder",
                                  "rank_grid_chunks", "confirm_measured",
                                  "measured_from_sweep", "tune_grid_chunk",
                                  "tune_solve_rung", "tune_plan_axes",
                                  "tune_plan_strategy",
                                  "tune_bucket_ladders",
                                  "tune_catalog_ladders", "tune_precision",
                                  "tune_update_blocks", "autotune_workload"])
def test_searches_raise_naming_item_8(name):
    from pint_torch import autotune

    with pytest.raises(NotImplementedError, match="item 8"):
        getattr(autotune, name)()


def test_plan_resolves_raise_naming_item_9():
    from pint_torch import autotune

    for fn in (autotune.resolve_plan_axes, autotune.resolve_plan_strategy):
        with pytest.raises(NotImplementedError, match="item 9"):
            fn("grid")


def test_fingerprint_is_the_executing_device():
    from pint_torch.autotune.manifest import TuningManifest

    fp = TuningManifest.fingerprint()
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert fp["platform"] == want and fp["torch_version"] == torch.__version__
    assert json.loads(json.dumps(fp)) == fp
