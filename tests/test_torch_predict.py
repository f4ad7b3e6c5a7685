"""The phase-prediction path against the reference, on the CPU.

Both packages in one process, on the plain versions of K13
(``polyco_eval``) and K14 (``polyco_fit``):

* ``node_targets`` on b1855 at GBT and ngc6440e at the barycentre, four
  windows each: the integer reference phases exactly, ``y`` and ``rfrac``
  within 1e-10 cycles;
* ``generate_predictors``: the predicted phases at 64 seeded epochs a
  window within 1e-10 cycles (the integer exact, the fraction mod 1),
  ``freq`` within 1e-12 relative, ``fit_rms`` within 1e-11 cycles and the
  same windows warned above ``FIT_RMS_WARN``; K14's pad rows solve to
  exactly zero;
* the door and the cache: K13's plain version bitwise the reference's
  numpy ``PredictorCache.predict``, ``run_predict_requests``' order,
  buckets, batches and windows, ``window_of``'s edges and refusal, and
  ``invalidate_span`` regenerating only the windows it covers;
* the TEMPO polyco table, written by one package and read by the other;
* the stream hook: on small_stream, a cache on the engine's model, fed
  ``update_epoch_span`` of each append, regenerates only the covered
  windows, a quarantine-only batch none;
* the refusals (the warm pool, item 8) and the card by default.
"""

import dataclasses
import logging
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

NC = 12
SEG = 60.0


def _pair(par, obs):
    """(reference model, port model) from the reference's exported state
    (its TOAs: a few at ``obs``, which the predict path never reads)."""
    from pint_torch.bridge import load_snapshot
    from pint_tpu import toa as rtoa
    from pint_tpu.models import get_model

    model = get_model(par.splitlines(keepends=True))
    toas = rtoa.get_TOAs_array(np.linspace(55000.1, 55003.3, 8), obs,
                               freqs=1400.0, ephem="DE440")
    m, _ = load_snapshot(standin.export_state(model, toas), device="cpu")
    return model, m


@pytest.fixture(scope="module")
def pulsars():
    """name -> (reference model, port model, obs, start MJD)."""
    out = {}
    model, m = _pair(standin.ngc_par(standin.NGC_SETTINGS), "@")
    out["ngc"] = (model, m, "@", float(model.PEPOCH.value))
    model, m = _pair(standin.standin_par(standin.FULL_SETTINGS, full=True),
                     "gbt")
    out["b1855"] = (model, m, "gbt", 55000.0)
    return out


@pytest.fixture(scope="module")
def generated(pulsars):
    """Each pulsar's four-window predictor set in both packages, with the
    windows each warned about."""
    from pint_torch.predict import generate as pg
    from pint_tpu.predict import generate as rg

    out = {}
    for name, (model, m, obs, start) in pulsars.items():
        warned = {}
        for tag, mod, mm, kw in (("ref", rg, model, {}),
                                 ("port", pg, m, {"device": "cpu"})):
            rec = _Recorder()
            logger = logging.getLogger(
                "pint_tpu" if tag == "ref" else "pint_torch")
            logger.addHandler(rec)
            try:
                s = mod.generate_predictors(mm, start, start + 4 / 24.0, obs,
                                            segLength=SEG, ncoeff=NC, **kw)
            finally:
                logger.removeHandler(rec)
            warned[tag] = (s, rec.windows())
        out[name] = warned
    return out


class _Recorder(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def windows(self):
        return [int(m.split()[2].rstrip(":")) for m in self.messages
                if m.startswith("predict window")]


@pytest.mark.parametrize("name", ["b1855", "ngc"])
def test_node_targets(pulsars, name):
    from pint_torch.predict import generate as pg
    from pint_tpu.predict import generate as rg

    model, m, obs, start = pulsars[name]
    tm = rg.window_tmids(start, start + 4 / 24.0, SEG)
    assert np.array_equal(tm, pg.window_tmids(start, start + 4 / 24.0, SEG))
    r = rg.node_targets(model, tm, SEG, NC, obs, 1400.0)
    p = pg.node_targets(m, tm, SEG, NC, obs, 1400.0)
    assert np.array_equal(r["x"], p["x"])
    assert np.array_equal(r["rint"], p["rint"])
    assert np.max(np.abs(r["y"] - p["y"])) < 1e-10
    assert np.max(np.abs(r["rfrac"] - p["rfrac"])) < 1e-10
    assert (r["f0"], r["psrname"], r["obsname"]) \
        == (p["f0"], p["psrname"], p["obsname"])


def _horner(s, t):
    """``(int, frac, freq)`` of a predictor set at times ``t``, by the
    cache's numpy recurrence, each time in its own window."""
    w = np.clip(np.searchsorted(s.tstart, t, side="right") - 1, 0,
                s.n_windows - 1)
    dt = (t - s.tmid[w]) * 1440.0
    c = s.coeffs[w]
    poly = np.zeros_like(dt)
    dpoly = np.zeros_like(dt)
    for i in range(s.ncoeff - 1, 0, -1):
        poly = poly * dt + c[:, i]
        dpoly = dpoly * dt + i * c[:, i]
    poly = poly * dt + c[:, 0]
    raw = s.rphase_frac[w] + 60.0 * s.f0 * dt + poly
    ip = np.floor(raw)
    return s.rphase_int[w] + ip, raw - ip, s.f0 + dpoly / 60.0


@pytest.mark.parametrize("name", ["b1855", "ngc"])
def test_predicted_phases_and_fit_rms(generated, name):
    (rs, rwarn), (ps, pwarn) = generated[name]["ref"], generated[name]["port"]
    assert np.array_equal(rs.tmid, ps.tmid)
    rng = np.random.default_rng(20260808)
    t = np.concatenate([rng.uniform(a, b, 64)
                        for a, b in zip(rs.tstart, rs.tstop)])
    ri, rf, rq = _horner(rs, t)
    pi, pf, pq = _horner(ps, t)
    d = (pi - ri) + (pf - rf)
    assert np.max(np.abs(d)) < 1e-10
    inside = np.minimum(rf, 1.0 - rf) > 1e-9
    assert np.array_equal(pi[inside], ri[inside])
    assert np.max(np.abs(pq - rq) / np.abs(rq)) < 1e-12
    assert np.max(np.abs(ps.fit_rms - rs.fit_rms)) < 1e-11
    assert rwarn == pwarn
    assert (name == "b1855") == bool(pwarn)


def test_k14_pad_rows_solve_to_zero_and_fit_least_squares():
    from pint_torch.kernels.polyco_fit import polyco_fit

    rng = np.random.default_rng(4)
    k = np.arange(24)
    x = np.tile(np.cos(np.pi * (k + 0.5) / 24)[::-1], (5, 1))
    y = rng.normal(size=(5, 24))
    y[3:] = 0.0
    c, rms = polyco_fit(torch.tensor(x), torch.tensor(y), NC)
    c, rms = c.numpy(), rms.numpy()
    assert np.all(c[3:] == 0.0) and np.all(rms[3:] == 0.0)
    for i in range(3):
        V = np.vander(x[i], NC, increasing=True)
        want, *_ = np.linalg.lstsq(V, y[i], rcond=None)
        assert np.allclose(c[i], want, rtol=0, atol=1e-9)
        r = V @ want - y[i]
        assert abs(rms[i] - np.sqrt(np.mean(r * r))) < 1e-12
    with pytest.raises(ValueError):
        polyco_fit(torch.tensor(x), torch.tensor(y), 33)
    with pytest.raises(ValueError):
        polyco_fit(torch.tensor(x), torch.tensor(y[:, :20]), NC)


@pytest.fixture(scope="module")
def caches(pulsars):
    """The ngc grid (eight windows at the barycentre) in both packages,
    built."""
    from pint_torch.predict import PredictorCache as PC
    from pint_tpu.predict import PredictorCache as RC

    model, m, obs, start = pulsars["ngc"]
    rc = RC(model, start, start + 8 / 24.0, obs=obs, segLength=SEG,
            ncoeff=NC)
    pc = PC(m, start, start + 8 / 24.0, obs=obs, segLength=SEG, ncoeff=NC,
            device="cpu")
    rc.build()
    pc.build()
    return rc, pc


def test_k13_plain_version_is_the_references_numpy_horner(caches):
    from pint_torch.kernels.polyco_eval import polyco_eval

    rc, _ = caches
    lo, hi = rc.coverage()
    t = np.sort(np.random.default_rng(9).uniform(lo, hi, 200))
    g = rc.gather(t)
    ip, frac, freq = (a.numpy()[0] for a in polyco_eval(
        *(torch.tensor(g[k][None]) for k in ("dt", "rfrac", "f0",
                                              "coeffs"))))
    pi, pf, pq = rc.predict(t)
    assert np.array_equal(g["rint"] + ip, pi)
    assert np.array_equal(frac, pf)
    assert np.array_equal(freq, pq)


def test_door_matches_the_reference(caches):
    from pint_torch.predict import PredictRequest as PR
    from pint_torch.predict.door import run_predict_requests as prun
    from pint_tpu.predict import PredictRequest as RR
    from pint_tpu.predict.door import run_predict_requests as rrun

    rc, pc = caches
    lo, hi = rc.coverage()
    rng = np.random.default_rng(20260808)
    sizes = (5, 48, 20, 70, 16, 3, 64, 9, 30, 17, 12, 2)
    times = [np.sort(rng.uniform(lo, hi, n)) for n in sizes]
    ref = rrun(rc, None, [RR(t, request_id=str(i))
                          for i, t in enumerate(times)])
    port = prun(pc, None, [PR(t, request_id=str(i))
                           for i, t in enumerate(times)])
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p.request_id == r.request_id == str(i)
        assert (p.bucket, p.batch, p.windows) == (r.bucket, r.batch,
                                                  r.windows)
        d = (p.phase_int - r.phase_int) + (p.phase_frac - r.phase_frac)
        assert np.max(np.abs(d)) < 1e-10
        assert np.max(np.abs(p.freq - r.freq) / r.freq) < 1e-12
        # the door's K13 is bitwise the port cache's own numpy Horner
        hi_, hf, hq = pc.predict(times[i])
        assert np.array_equal(p.phase_int, hi_)
        assert np.array_equal(p.phase_frac, hf)
        assert np.array_equal(p.freq, hq)
    assert port[0].compiles == 0
    assert pc.stats()["misses"] == 0


def test_window_of_edges_and_refusal(caches):
    from pint_torch.exceptions import UsageError as PU
    from pint_tpu.exceptions import UsageError as RU

    rc, pc = caches
    assert np.array_equal(rc._tstart, pc._tstart)
    assert rc.coverage() == pc.coverage()
    edges = np.concatenate([rc._tstart, rc._tstop, rc._tstart - 5e-10,
                            rc._tstop + 5e-10])
    assert np.array_equal(rc.window_of(edges), pc.window_of(edges))
    lo, hi = rc.coverage()
    for t in (lo - 2e-9, hi + 2e-9, hi + 1.0):
        with pytest.raises(RU):
            rc.window_of([t])
        with pytest.raises(PU):
            pc.window_of([t])
    assert issubclass(PU, ValueError)


def test_invalidate_span_regenerates_only_the_covered_windows(pulsars):
    from pint_torch.predict import PredictorCache as PC
    from pint_tpu.predict import PredictorCache as RC

    model, m, obs, start = pulsars["ngc"]
    counts = []
    for cls, mm, kw in ((RC, model, {}), (PC, m, {"device": "cpu"})):
        c = cls(mm, start, start + 8 / 24.0, obs=obs, segLength=SEG,
                ncoeff=NC, **kw)
        c.build()
        n = c.invalidate_span(start + 2.2 / 24, start + 3.5 / 24)
        lo, hi = c.coverage()
        W = c.n_windows
        c.predict(lo + (np.arange(W) + 0.5) * (hi - lo) / W)
        counts.append((n, c.regen_count.copy(), c.stats()))
    (rn, rreg, rst), (pn, preg, pst) = counts
    assert rn == pn == 2
    assert np.array_equal(rreg, preg)
    assert list(np.nonzero(preg == 2)[0]) == [2, 3]
    assert rst == pst


def test_tempo_polyco_table_round_trips(generated, tmp_path):
    from pint_torch.polycos import Polycos as PP
    from pint_tpu.polycos import Polycos as RP

    rs, _ = generated["ngc"]["ref"]
    ps, _ = generated["ngc"]["port"]
    for writer, reader, s, tag in ((ps.to_polycos(), RP, ps, "port"),
                                   (rs.to_polycos(), PP, rs, "ref")):
        path = str(tmp_path / f"{tag}.dat")
        writer.write_polyco_file(path)
        back = reader.read_polyco_file(path)
        same = type(writer).read_polyco_file(path)
        assert len(back.entries) == s.n_windows
        for a, b in zip(back.entries, same.entries):
            for f in ("tmid", "mjdspan", "rphase_int", "rphase_frac", "f0",
                      "ncoeff", "obs", "obsfreq", "psrname"):
                assert getattr(a, f) == getattr(b, f), f
            assert np.array_equal(a.coeffs, b.coeffs)
        t = np.array([s.tmid[1] + 0.01])
        assert back.eval_abs_phase(t).int_ == same.eval_abs_phase(t).int_
        assert back.eval_abs_phase(t).frac == same.eval_abs_phase(t).frac


def test_pool_refusals_and_the_card_by_default(pulsars):
    from pint_torch import NoGPUError
    from pint_torch.predict import (PredictorCache, generate_predictors,
                                    warm_predict)
    from pint_torch.predict.door import run_predict_requests
    from pint_torch.predict.generate import fit_windows

    _, m, obs, start = pulsars["ngc"]
    with pytest.raises(NotImplementedError, match="item 8"):
        warm_predict(None, object())
    with pytest.raises(NotImplementedError, match="item 8"):
        fit_windows(np.zeros((1, 24)), np.zeros((1, 24)), NC, 30.0,
                    pool=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        PredictorCache(m, start, start + 0.1, pool=object(), device="cpu")
    c = PredictorCache(m, start, start + 0.1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        run_predict_requests(c, object(), [])
    if torch.cuda.is_available():
        return
    with pytest.raises(NoGPUError):
        PredictorCache(m, start, start + 0.1)
    with pytest.raises(NoGPUError):
        generate_predictors(m, start, start + 0.1, obs)


def test_stream_hook_regenerates_only_the_appended_span():
    """small_stream: the port's engine updates its fitter's model in
    place, so a cache on that model, fed ``update_epoch_span`` of an
    accepted append (the reference service's hook,
    ``serving/service.py:1083-1103``), stales exactly the windows
    spanning the appended epochs; a batch whose every row is quarantined
    moves no parameter and regenerates nothing; the refreshed cache
    predicts bitwise what a new cache on the moved model does."""
    from pint_torch.bridge import (STREAM_SMALL_PATH, load_snapshot,
                                   read_snapshot, stream_schedule)
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import _model_param_sig
    from pint_torch.predict import PredictorCache
    from pint_torch.predict.door import update_epoch_span
    from pint_torch.streaming import (StreamingGLS, UpdateRequest,
                                      run_update_requests)

    meta, _ = read_snapshot(STREAM_SMALL_PATH)
    m, b = load_snapshot(STREAM_SMALL_PATH, device="cpu")
    base, rows, _, _ = stream_schedule(meta)

    def sel(idx):
        k = np.zeros(b.ntoas, dtype=bool)
        k[idx] = True
        return b.select(k, m)

    f = GLSFitter(sel(base), m)
    f.fit_toas(maxiter=meta["reference"]["settings"]["fit_maxiter"])
    eng = StreamingGLS(f)
    block = sel(rows[0])
    lo_b, hi_b = float(block.mjds.min()), float(block.mjds.max())
    cache = PredictorCache(f.model, lo_b - 5.0, hi_b + 5.0, obs="@",
                           segLength=2880.0, ncoeff=6, device="cpu")
    cache.build()
    spanned = np.arange(cache.window_of([lo_b])[0],
                        cache.window_of([hi_b])[0] + 1)
    assert 0 < len(spanned) < cache.n_windows

    def serve(reqs):
        sig = _model_param_sig(f.model)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run_update_requests(eng, reqs)
        if _model_param_sig(f.model) != sig:
            lo, hi = update_epoch_span(reqs)
            cache.invalidate_span(lo, hi)

    serve([UpdateRequest(new_toas=block)])
    assert cache.invalidated == len(spanned)
    lo_c, hi_c = cache.coverage()
    W = cache.n_windows
    mids = lo_c + (np.arange(W) + 0.5) * (hi_c - lo_c) / W
    cache.predict(mids)
    expect = np.ones(W, dtype=np.int64)
    expect[spanned] += 1
    assert np.array_equal(cache.regen_count, expect)

    bad = sel(rows[1])
    bad = dataclasses.replace(bad, error_us=torch.full_like(bad.error_us,
                                                            -1.0))
    inv0, reg0 = cache.invalidated, cache.regenerated
    serve([UpdateRequest(new_toas=bad)])
    assert (cache.invalidated, cache.regenerated) == (inv0, reg0)
    cache.predict(mids)
    assert np.array_equal(cache.regen_count, expect)

    probes = mids[spanned]
    fresh = PredictorCache(f.model, lo_b - 5.0, hi_b + 5.0, obs="@",
                           segLength=2880.0, ncoeff=6, device="cpu")
    for a, c in zip(cache.predict(probes), fresh.predict(probes)):
        assert np.array_equal(a, c)


def test_host_generator_matches_the_reference(pulsars):
    """``Polycos.generate_polycos`` (the host generator: numpy least
    squares a segment) on ngc at the barycentre, two segments: the same
    entries' reference phases and predictions at the bars."""
    from pint_torch.polycos import Polycos as PP
    from pint_tpu.polycos import Polycos as RP

    model, m, obs, start = pulsars["ngc"]
    r = RP.generate_polycos(model, start, start + 2 / 24.0, obs)
    p = PP.generate_polycos(m, start, start + 2 / 24.0, obs)
    assert len(r.entries) == len(p.entries) == 2
    t = np.linspace(start + 0.001, start + 2 / 24.0 - 0.001, 50)
    a, b = r.eval_abs_phase(t), p.eval_abs_phase(t)
    d = (b.int_ - a.int_) + (b.frac - a.frac)
    assert np.max(np.abs(d)) < 1e-10
    for x, y in zip(r.entries, p.entries):
        assert (x.tmid, x.rphase_int) == (y.tmid, y.rphase_int)
