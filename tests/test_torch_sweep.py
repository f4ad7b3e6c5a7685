"""``grid_chisq``'s whole signature in the port against the JAX package's
on the CPU: the positional call of fault C7, the fused sweep
(``fn.fused``), the escalation inside a fused group, the WLS grid's
``fuse=``, the refusals, the retry executor and the checkpointed sweep,
and the sampler's retries; and each model family's grid chunk scanned for
the calls a CUDA graph cannot capture.

The grids run on the small GLS and ELL1 stand-ins (80 TOAs, seeded numpy)
from their exported state, without a fit.  Bars (PERF.md section 2, the
grid bars): chi2 1e-6 rel with the same argmin and rungs, refit values
within 1e-2 of the model's uncertainties; the port's fused and resumed
surfaces bitwise its unfused one.
"""

import inspect
import logging
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

GRID = ("M2", "SINI")
#: 6 x 6 points at chunk 8: five chunks, the last one of 4 points
CHUNK = 8
FUSES = (1, 2, 3, 8)


@pytest.fixture(scope="module")
def gls():
    """(reference model, TOAs, port model, batch, the 6 x 6 points) of
    the small GLS stand-in at its exported values."""
    model, toas, m, b = standin.port_and_reference(standin.SMALL_SETTINGS)
    g_m2, g_sini = standin.grid_axes(model, 6)
    pts = np.stack([g.ravel() for g in np.meshgrid(g_m2, g_sini,
                                                   indexing="ij")], axis=-1)
    return dict(model=model, toas=toas, m=m, b=b, axes=(g_m2, g_sini),
                pts=pts)


@pytest.fixture(scope="module")
def fns(gls):
    """Both packages' GLS grid functions at chunk 8, ``niter=1``, the
    classification spanning the 6 x 6 points."""
    from pint_tpu.grid import _point_spans
    from pint_tpu.grid import build_grid_chi2_fn as rbuild

    from pint_torch.grid import build_grid_chi2_fn, point_spans

    rfn, _, rfit = rbuild(gls["model"], gls["toas"], GRID, niter=1,
                          chunk=CHUNK,
                          grid_spans=_point_spans(gls["model"], GRID,
                                                  gls["pts"]))
    pfn, _, pfit = build_grid_chi2_fn(gls["m"], gls["b"], GRID, niter=1,
                                      chunk=CHUNK,
                                      grid_spans=point_spans(gls["m"], GRID,
                                                             gls["pts"]))
    assert tuple(rfit) == tuple(pfit)
    return rfn, pfn, tuple(pfit)


@pytest.fixture(scope="module")
def sig(gls, fns):
    """The refit parameters' uncertainties, of a GLS fit of a copy of the
    port's model: the scale of the 1e-2-sigma value bar."""
    from pint_torch.gls_fitter import GLSFitter

    f = GLSFitter(gls["b"], gls["m"].copy())
    f.fit_toas(maxiter=1)
    return np.array([f.model[p].uncertainty for p in fns[2]])


def _at_grid_bars(port, ref, sig):
    """chi2 1e-6 rel, argmin and rungs exact, values within 1e-2 sigma;
    NaN where the reference's is."""
    c2, vf, dg = port
    rc2, rvf, rdg = (np.asarray(a) for a in ref)
    assert np.array_equal(np.isnan(c2), np.isnan(rc2))
    ok = ~np.isnan(rc2)
    assert np.abs(c2[ok] / rc2[ok] - 1).max() <= 1e-6
    assert np.nanargmin(c2) == np.nanargmin(rc2)
    assert np.array_equal(dg[:, 0], rdg[:, 0])
    assert np.abs((vf[ok] - rvf[ok]) / sig).max() <= 1e-2


def _bitwise(a, b):
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# fault C7: the signature
# ---------------------------------------------------------------------------
def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["grid_chisq", "grid_chisq_derived",
                                  "tuple_chisq", "tuple_chisq_derived"])
def test_grid_signatures_are_the_references(name):
    """Names, order, kinds and defaults of each grid function's
    parameters are the reference's."""
    import pint_tpu.grid as rgrid

    import pint_torch.grid as pgrid

    assert _params(getattr(pgrid, name)) == _params(getattr(rgrid, name))


def test_positional_call_binds_as_the_reference(gls):
    """C7: ``grid_chisq(f, names, values, (), None, 4)`` means
    ``executor=None, ncpu=4`` in both packages (``niter`` stays 4, the
    chunk the static default): the same chi2 surface at the grid bars."""
    from pint_tpu.gls_fitter import GLSFitter as RG
    from pint_tpu.grid import grid_chisq as rgrid

    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    axes = tuple(a[::2] for a in gls["axes"])
    fr, fp = RG(gls["toas"], gls["model"]), GLSFitter(gls["b"], gls["m"])
    c_r, _ = rgrid(fr, GRID, axes, (), None, 4)
    c_p, _ = grid_chisq(fp, GRID, axes, (), None, 4)
    assert c_p.shape == c_r.shape == (3, 3)
    assert np.abs(c_p / np.asarray(c_r) - 1).max() <= 1e-6
    assert np.array_equal(fp.last_grid_diagnostics["ladder_rung"],
                          fr.last_grid_diagnostics["ladder_rung"])


# ---------------------------------------------------------------------------
# the fused sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fuse", FUSES)
def test_fused_is_the_unfused_surface_and_the_references(gls, fns, sig,
                                                         fuse):
    """``fn.fused`` at chunk 8 over 6 x 6 points (five chunks): bitwise
    the port's unfused grid, and against the reference's ``fn.fused`` at
    the grid bars with the same ``dispatch_count()`` (one a fused group)."""
    rfn, pfn, _ = fns
    base = pfn(gls["pts"])
    assert pfn.dispatch_count() == 5
    got = pfn.fused(gls["pts"], fuse=fuse)
    assert _bitwise(got, base)
    ref = rfn.fused(gls["pts"], fuse=fuse)
    _at_grid_bars(got, ref, sig)
    assert pfn.dispatch_count() == rfn.dispatch_count() == -(-5 // fuse)
    assert pfn.graph_stats() == {}


def test_escalation_inside_a_fused_group_gives_the_references_rungs(gls, fns,
                                                                   sig):
    """A point no rung solves (SINI > 1) inside a fused group: NaN chi2 at
    rung -1 in both packages, its chunk re-run at the two escalated
    ridges (two more dispatches), and every other point as in the sweep
    without it, bitwise."""
    rfn, pfn, _ = fns
    bad = 11
    pts = gls["pts"].copy()
    pts[bad, 1] = 1.2
    got = pfn.fused(pts, fuse=3)
    ref = rfn.fused(pts, fuse=3)
    assert np.isnan(got[0][bad]) and got[2][bad, 0] == -1
    _at_grid_bars(got, ref, sig)
    assert pfn.dispatch_count() == rfn.dispatch_count() == 2 + 2
    base = pfn(gls["pts"])
    keep = np.arange(len(pts)) != bad
    assert _bitwise(tuple(a[keep] for a in got),
                    tuple(a[keep] for a in base))
    assert (got[2][keep, 0] == 0).all()


def test_wls_fuse_is_the_unfused_surface():
    """The WLS grid has no fused path in either package: ``fuse=`` gives
    the unfused surface, bitwise in each, and the two at the grid bars."""
    from pint_tpu.fitter import WLSFitter as RW
    from pint_tpu.grid import grid_chisq as rgrid

    from pint_torch.fitter import WLSFitter
    from pint_torch.grid import grid_chisq

    model, toas, m, b = standin.port_and_reference(
        standin.SMALL_ELL1_SETTINGS)
    axes = tuple(a[::2] for a in standin.grid_axes(model, 6))
    fr, fp = RW(toas, model), WLSFitter(b, m)
    r1, _ = rgrid(fr, GRID, axes, niter=2)
    r3, _ = rgrid(fr, GRID, axes, niter=2, fuse=3)
    p1, _ = grid_chisq(fp, GRID, axes, niter=2)
    p3, _ = grid_chisq(fp, GRID, axes, niter=2, fuse=3)
    assert np.array_equal(np.asarray(r1), np.asarray(r3))
    assert np.array_equal(p1, p3)
    assert np.abs(p3 / np.asarray(r3) - 1).max() <= 1e-6


# ---------------------------------------------------------------------------
# refusals, chunk strings, the executor warning
# ---------------------------------------------------------------------------
def _mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("grid",))


@pytest.mark.parametrize("kw", ["plan_mesh", "checkpoint_mesh",
                                "fuse_checkpoint", "bad_plan", "bad_chunk"])
def test_usage_errors_are_the_references(gls, tmp_path, kw):
    """The reference's typed refusals, in its order of checks: plan with
    mesh, checkpoint with mesh, fuse > 1 with checkpoint but no plan, a
    plan string other than 'auto', a chunk string other than 'auto'."""
    from pint_tpu.exceptions import UsageError as RUsage
    from pint_tpu.gls_fitter import GLSFitter as RG
    from pint_tpu.grid import grid_chisq as rgrid

    from pint_torch.exceptions import UsageError
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    mesh = _mesh()
    ck = str(tmp_path / "ck")
    args = {"plan_mesh": dict(plan="auto", mesh=mesh),
            "checkpoint_mesh": dict(checkpoint=ck, mesh=mesh),
            "fuse_checkpoint": dict(checkpoint=ck, fuse=2),
            "bad_plan": dict(plan="fast"),
            "bad_chunk": dict(chunk="fast")}[kw]
    axes = tuple(a[:2] for a in gls["axes"])
    with pytest.raises(RUsage) as r:
        rgrid(RG(gls["toas"], gls["model"]), GRID, axes, niter=1, **args)
    with pytest.raises(UsageError) as p:
        grid_chisq(GLSFitter(gls["b"], gls["m"]), GRID, axes, niter=1,
                   **args)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("kw", ["mesh", "plan", "plan_object"])
def test_mesh_and_plan_name_item_9(gls, kw):
    """Meshes and execution plans are ROADMAP queue A item 9."""
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq

    args = {"mesh": dict(mesh=_mesh()), "plan": dict(plan="auto"),
            "plan_object": dict(plan=object())}[kw]
    with pytest.raises(NotImplementedError, match="item 9"):
        grid_chisq(GLSFitter(gls["b"], gls["m"]), GRID,
                   tuple(a[:2] for a in gls["axes"]), niter=1, **args)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append((record.levelname, record.getMessage()))


def test_auto_chunk_and_ncpu_warning(gls, monkeypatch):
    """``chunk="auto"`` is the static default (128 on the CPU), logged;
    ``ncpu=4`` warns once a process and leaves the surface as it was."""
    import pint_torch.grid as pgrid
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.logging import log

    monkeypatch.setattr(pgrid, "_warned_executor", False)
    rec = _Records()
    log.addHandler(rec)
    # setLevel, not the bare attribute: it also drops the logger's cache
    # of isEnabledFor answers from earlier tests in the process
    monkeypatch.setattr(log, "level", log.level)
    log.setLevel(logging.INFO)
    try:
        axes = tuple(a[:3] for a in gls["axes"])
        f = GLSFitter(gls["b"], gls["m"])
        base, _ = pgrid.grid_chisq(f, GRID, axes, niter=1)
        auto, _ = pgrid.grid_chisq(f, GRID, axes, niter=1, chunk="auto")
        w1, _ = pgrid.grid_chisq(f, GRID, axes, niter=1, ncpu=4)
        w2, _ = pgrid.grid_chisq(f, GRID, axes, niter=1, ncpu=4)
    finally:
        log.removeHandler(rec)
        log.manager._clear_cache()
    assert pgrid.default_gls_chunk("cpu") == 128
    assert np.array_equal(base, auto) and np.array_equal(base, w1)
    assert np.array_equal(base, w2)
    warned = [m for lv, m in rec.messages if lv == "WARNING"
              and "executor/ncpu" in m]
    assert len(warned) == 1
    assert any("'auto'" in m and "static default 128" in m
               for _, m in rec.messages)


def test_chunk_override_and_its_errors(monkeypatch):
    """``default_gls_chunk``: the configured override wins on every
    device, else 256 on the card and 128 on the CPU."""
    from pint_torch import config
    from pint_torch.exceptions import UsageError
    from pint_torch.grid import default_gls_chunk

    monkeypatch.setattr(config, "_grid_chunk", None)
    monkeypatch.setattr(config, "_grid_chunk_env_checked", True)
    assert default_gls_chunk("cuda") == 256
    assert default_gls_chunk("cpu") == 128
    config.set_grid_chunk(np.int64(64))
    assert default_gls_chunk("cuda") == default_gls_chunk("cpu") == 64
    with pytest.raises(UsageError):
        config.set_grid_chunk(0)
    config.set_grid_chunk(None)
    assert default_gls_chunk("cpu") == 128


# ---------------------------------------------------------------------------
# the retry executor
# ---------------------------------------------------------------------------
def _errors(pkg):
    """The same exception objects, each package's DeviceLostError."""
    ex = __import__(f"{pkg}.exceptions", fromlist=["DeviceLostError"])

    class XlaRuntimeError(Exception):
        pass

    return [ex.DeviceLostError("lost"), XlaRuntimeError("boom"),
            RuntimeError("CUDA error: an illegal memory access was "
                         "encountered on device 0"),
            RuntimeError("Device-side assert triggered"),
            RuntimeError("out of memory"), ValueError("device"),
            TimeoutError("slow"), OSError("device gone"),
            KeyboardInterrupt(), ex.SweepChunkFailure("device"),
            ex.CheckpointError("x")]


def test_device_failure_verdicts_are_the_references():
    """``_is_device_failure`` on the same table of exceptions, a kernel
    launch error (a RuntimeError) judged by its message."""
    from pint_tpu.runtime.checkpoint import _is_device_failure as ref

    from pint_torch.kernels import KernelLaunchError
    from pint_torch.runtime.checkpoint import _is_device_failure

    got = [_is_device_failure(e) for e in _errors("pint_torch")]
    want = [ref(e) for e in _errors("pint_tpu")]
    assert got == want == [True, True, True, True, False, False, False,
                           False, False, False, False]
    assert _is_device_failure(KernelLaunchError(
        "spin_phase: CUDA error 700: an illegal memory access on the "
        "device"))
    assert not _is_device_failure(KernelLaunchError(
        "spin_phase: CUDA error 1: invalid argument"))


def _flaky(fail, exc=RuntimeError):
    """A callable failing with ``exc("device lost")`` on its first
    ``fail`` calls, then returning the call count."""
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= fail:
            raise exc("device lost")
        return calls[0]

    return fn, calls


@pytest.mark.parametrize("pkg", ["pint_tpu", "pint_torch"])
def test_with_retries(pkg):
    """Backoff with ``backoff_base=0``; a non-retryable error propagates
    unchanged on the first attempt; ``SweepChunkFailure`` after
    ``max_retries + 1`` attempts, chained to the last failure; a timed-out
    attempt counts as retryable.  Both packages alike."""
    import time

    ck = __import__(f"{pkg}.runtime.checkpoint",
                    fromlist=["with_retries"])
    ex = __import__(f"{pkg}.exceptions", fromlist=["SweepChunkFailure"])
    pol = ck.RetryPolicy(max_retries=2, backoff_base=0.0)
    fn, calls = _flaky(2)
    assert ck.with_retries(fn, pol) == 3 and calls[0] == 3
    fn, calls = _flaky(1, ValueError)
    with pytest.raises(ValueError, match="device lost"):
        ck.with_retries(fn, pol)
    assert calls[0] == 1
    fn, calls = _flaky(5)
    with pytest.raises(ex.SweepChunkFailure, match="3 attempts") as e:
        ck.with_retries(fn, pol, what="unit")
    assert calls[0] == 3 and isinstance(e.value.__cause__, RuntimeError)
    slow = [0]

    def sometimes_slow():
        slow[0] += 1
        if slow[0] == 1:
            time.sleep(0.5)
        return slow[0]

    pol_t = ck.RetryPolicy(max_retries=1, backoff_base=0.0, timeout=0.1)
    assert ck.with_retries(sometimes_slow, pol_t) == 2


# ---------------------------------------------------------------------------
# checkpointed sweeps
# ---------------------------------------------------------------------------
def test_fingerprints_are_the_references():
    """``fingerprint_of`` of the same definition: the reference's sha1."""
    from pint_tpu.runtime.checkpoint import fingerprint_of as ref

    from pint_torch.runtime.checkpoint import fingerprint_of

    rng = np.random.default_rng(7)
    kw = dict(parnames=("M2", "SINI"), pts=rng.standard_normal((6, 2)),
              niter=4, ntoas=80, gls=True, toas_version=0,
              params=(("F0", "218.8", "None", ()),),
              free_init=rng.standard_normal(9))
    assert fingerprint_of(**kw) == ref(**kw)
    assert fingerprint_of(**dict(kw, niter=3)) != fingerprint_of(**kw)


def test_checkpointed_sweep_resumes_bitwise_and_refuses_another(
        gls, tmp_path, monkeypatch):
    """A sweep stopped by a non-retryable error at chunk 2 resumes,
    recomputing only chunks 2-4, bitwise the uninterrupted surface; the
    layout is the reference's, with the block size beside its keys; a
    changed parameter value, grid, ``niter`` or chunk size (at the same
    chunk count) raises ``CheckpointError``; a device-shaped failure is
    retried under ``retry`` and the surface is unchanged."""
    from pint_tpu.gls_fitter import GLSFitter as RG
    from pint_tpu.grid import grid_chisq as rgrid

    from pint_torch.exceptions import CheckpointError
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import grid_chisq
    from pint_torch.runtime import checkpoint as ck

    f = GLSFitter(gls["b"], gls["m"])
    axes = gls["axes"]
    kw = dict(niter=1, chunk=CHUNK)
    base, ex_base = grid_chisq(f, GRID, axes, extraparnames=("F0",), **kw)
    real = ck._invoke
    seen, stop = [], [True]

    def stop_at_2(fn, chunk, index):
        seen.append(index)
        if index == 2 and stop[0]:
            raise KeyError("stopped")
        return real(fn, chunk, index)

    monkeypatch.setattr(ck, "_invoke", stop_at_2)
    path = tmp_path / "sweep"
    with pytest.raises(KeyError):
        grid_chisq(f, GRID, axes, checkpoint=str(path), **kw)
    assert seen == [0, 1, 2]
    seen.clear()
    stop[0] = False
    again, ex_again = grid_chisq(f, GRID, axes, extraparnames=("F0",),
                                 checkpoint=str(path), **kw)
    assert seen == [2, 3, 4]
    assert np.array_equal(again, base)
    assert np.array_equal(ex_again["F0"], ex_base["F0"])
    # the reference's layout, side by side
    rpath = tmp_path / "ref_sweep"
    rgrid(RG(gls["toas"], gls["model"]), GRID, axes, checkpoint=str(rpath),
          **kw)
    import json

    assert sorted(os.listdir(path)) == sorted(os.listdir(rpath))
    mine = json.loads((path / "meta.json").read_text())
    theirs = json.loads((rpath / "meta.json").read_text())
    assert set(mine) == set(theirs) | {"block"} and mine["block"] == CHUNK
    assert mine["nchunks"] == theirs["nchunks"]
    assert mine["version"] == theirs["version"] == 2
    # another sweep refuses the directory
    with pytest.raises(CheckpointError):
        grid_chisq(f, GRID, axes, checkpoint=str(path), niter=2,
                   chunk=CHUNK)
    with pytest.raises(CheckpointError):
        grid_chisq(f, GRID, (axes[0][:5], axes[1]), checkpoint=str(path),
                   **kw)
    # the same points cut into as many chunks of another size (30 points:
    # four of 8 or four of 9) are refused, not stitched
    cut = (axes[0][:5], axes[1])
    grid_chisq(f, GRID, cut, checkpoint=str(tmp_path / "cut"), **kw)
    with pytest.raises(CheckpointError, match="blocks of 8"):
        grid_chisq(f, GRID, cut, checkpoint=str(tmp_path / "cut"), niter=1,
                   chunk=9)
    m2 = gls["m"].copy()
    m2["F0"].value = m2["F0"].value + 1e-12
    with pytest.raises(CheckpointError):
        grid_chisq(GLSFitter(gls["b"], m2), GRID, axes,
                   checkpoint=str(path), **kw)
    # one device-shaped failure, retried
    monkeypatch.setattr(ck, "_invoke", real)
    fails = [1]

    def once(fn, chunk, index):
        if index == 1 and fails[0]:
            fails[0] = 0
            raise RuntimeError("device lost")
        return real(fn, chunk, index)

    monkeypatch.setattr(ck, "_invoke", once)
    retried, _ = grid_chisq(f, GRID, axes, checkpoint=str(tmp_path / "r"),
                            retry=ck.RetryPolicy(backoff_base=0.0), **kw)
    assert fails == [0] and np.array_equal(retried, base)


# ---------------------------------------------------------------------------
# the sampler's retries
# ---------------------------------------------------------------------------
def test_sampler_retries_give_the_references_chain():
    """``EnsembleSampler(retries=)`` under one injected device-shaped
    failure of its batched evaluation: the reference's chain under the
    same injection, and the chain without it, bitwise."""
    from pint_tpu.sampler import EnsembleSampler as Ref

    from pint_torch.sampler import EnsembleSampler

    rng = np.random.default_rng(3)
    pos = rng.standard_normal((8, 3))

    def run(cls, inject):
        calls = [0]

        def lnpost(pts):
            calls[0] += 1
            if inject and calls[0] == 3:
                raise RuntimeError("device lost")
            return -0.5 * np.sum(np.asarray(pts) ** 2, axis=1)

        s = cls(8, seed=11, retries=2, retry_backoff=0.0)
        s.initialize_batched(lnpost, 3)
        s.run_mcmc(pos, 10)
        return np.asarray(s._chain), calls[0]

    mine, n_mine = run(EnsembleSampler, True)
    theirs, n_theirs = run(Ref, True)
    clean, n_clean = run(EnsembleSampler, False)
    assert np.array_equal(mine, theirs) and np.array_equal(mine, clean)
    assert n_mine == n_theirs == n_clean + 1


def test_sampler_non_device_failure_propagates():
    """Anything not device-shaped propagates at once."""
    from pint_torch.sampler import EnsembleSampler

    def lnpost(pts):
        raise ValueError("bad prior")

    s = EnsembleSampler(4, seed=1, retries=2, retry_backoff=0.0)
    s.initialize_batched(lnpost, 2)
    with pytest.raises(ValueError, match="bad prior"):
        s.run_mcmc(np.zeros((4, 2)), 1)


# ---------------------------------------------------------------------------
# the reference's fused sweep, stored
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("attr", ["STANDIN_PATH", "DMX15_PATH"])
def test_committed_sweep_groups(attr):
    """``ref/sweep/`` of b1855 and dmx15: the reference's 32 x 32 fused
    sweep (1024 points, chunk 256, fuse 3: two dispatches), every point
    solved at the base ridge, the axes those of the first fit's
    uncertainties; the earlier arrays' digests are held by
    ``test_torch_snapshot.py``."""
    from pint_torch import bridge

    meta, a = bridge.read_snapshot(getattr(bridge, attr))
    P, n = "ref/sweep/", standin.SWEEP["points"]
    shapes = {"m2": (n,), "sini": (n,), "chi2": (n, n), "diag": (n * n, 3),
              "dispatch_count": ()}
    shapes.update({p.lower(): (n, n) for p in standin.SWEEP["extra"]})
    assert {k[len(P):] for k in a if k.startswith(P)} == set(shapes)
    for key, shape in shapes.items():
        assert a[P + key].shape == shape, key
    assert int(a[P + "dispatch_count"]) == -(-n * n // standin.SWEEP[
        "chunk"] // standin.SWEEP["fuse"]) == 2
    assert np.isfinite(a[P + "chi2"]).all()
    assert (a[P + "diag"][:, 0] == 0).all()
    names = meta["reference"]["postfit_params"]
    sig = a["ref/postfit_uncertainties"]
    for g in ("M2", "SINI"):
        v = a["ref/postfit_values"][names.index(g)]
        assert abs(a[P + g.lower()].mean() - v) < 3 * sig[names.index(g)]
