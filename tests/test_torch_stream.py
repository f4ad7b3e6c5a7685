"""The port's streaming GLS engine and K9's plain version
(``pint_torch/streaming``, ``pint_torch/kernels/chol_rank_update.py``)
against the JAX package's on the CPU.

K9's plain version against the reference's ``_rank_pass`` and
``ingest_kernel`` on numpy-seeded factors at K = 12, 23 and 150 (within
1e-13 of the factor's largest entry: XLA's CPU code rounds the sweep's
sums and products in its own order, a few 1e-16 of it measured; the
plain version itself rounds as the kernel does); pad rows bitwise no-ops;
the card's order (a wavefront over the rows, in passes) bitwise the plain
version's; a downdate of absent rows refused with the reference's reason text; the
condition guard.  Then the small stream stand-in (``small_stream``: the
small stand-in without ECORR, five red-noise modes on a 6-yr period, 80
TOAs) in both packages, operation by operation: the kind, block,
quarantined rows, steps, block ids and fallback (the third append opens
a DMX window with no base rows: both refactor) exactly; chi2 1e-6 rel,
values 1e-2 sigma, uncertainties 1e-6 rel (the repo's fit bars); the
factor 1e-9 of its largest entry.  Quarantine, release,
``apply_validation`` and the pen; ``stream_updates`` cut and resumed
bitwise; the update door's coalescing and refusals; each context a block
slices bitwise the reference's evaluation of the block alone; contexts
that depend on the whole set derived from the subset.
"""

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

S = standin.SMALL_STREAM_SETTINGS


def _spd_factor(K, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K + 7, K))
    return np.linalg.cholesky(A.T @ A + np.eye(K)), rng


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["update", "downdate"])
@pytest.mark.parametrize("K", [12, 23, 150])
def test_rank_update_matches_the_reference(K, sign):
    """The sweep within 1e-13 x max|L| of ``_rank_pass`` (the downdate
    removes rows that an update put in)."""
    from pint_torch.kernels.chol_rank_update import chol_rank_update
    from pint_tpu.streaming.lowrank import rank_kernel

    L, rng = _spd_factor(K, K)
    V = rng.normal(size=(16, K))
    if sign < 0:
        L = np.asarray(rank_kernel(1.0)(L, V))
    want = np.asarray(rank_kernel(sign)(L, V))
    got = chol_rank_update(torch.tensor(L), torch.tensor(V), sign).numpy()
    gap = np.max(np.abs(got - want)) / np.max(np.abs(want))
    print(f"K = {K}, sign {sign:+.0f}: gap {gap:.3e} of max|L|")
    assert gap <= 1e-13


@pytest.mark.parametrize("K", [12, 23, 150])
def test_stream_ingest_matches_the_reference(K):
    """``stream_ingest`` against ``ingest_kernel``: the factor within
    1e-13 x max|L|, b' and chi2' within 1e-13 of their sums of |terms|,
    ``ok`` and ``cond`` (1e-13 rel) alike, on a padded block."""
    from pint_torch.kernels.chol_rank_update import stream_ingest
    from pint_tpu.streaming.lowrank import ingest_kernel

    L, rng = _spd_factor(K, 100 + K)
    k = 16
    M, r = rng.normal(size=(k, K)), rng.normal(size=k)
    w = rng.uniform(0.5, 2.0, k)
    M[9:], r[9:], w[9:] = 0.0, 0.0, 0.0
    dx, b = 1e-3 * rng.normal(size=K), rng.normal(size=K)
    args = (L, b, np.float64(3.0), M, r, w, dx)
    want = [np.asarray(a) for a in ingest_kernel(1.0)(*args)]
    got = [a.numpy() for a in stream_ingest(*map(torch.tensor, args), 1.0)]
    assert np.max(np.abs(got[0] - want[0])) <= 1e-13 * np.abs(want[0]).max()
    rnow = r - M @ dx
    b_terms = np.abs(b) + np.abs(M.T) @ np.abs(w * rnow)
    assert np.all(np.abs(got[1] - want[1]) <= 1e-13 * b_terms)
    c_terms = 3.0 + np.sum(np.abs(w * rnow * rnow))
    assert abs(got[2] - want[2]) <= 1e-13 * c_terms
    assert bool(got[3]) == bool(want[3])
    assert abs(got[4] / want[4] - 1.0) <= 1e-13


def test_pad_rows_are_bitwise_no_ops():
    """Zero rows interleaved anywhere leave the factor, b and chi2 bitwise
    as the block without them gives them."""
    from pint_torch.kernels.chol_rank_update import (chol_rank_update,
                                                     stream_ingest)

    L, rng = _spd_factor(23, 5)
    V = rng.normal(size=(5, 23))
    Vp = np.zeros((16, 23))
    Vp[[1, 4, 6, 11, 15]] = V
    t = torch.tensor
    a = chol_rank_update(t(L), t(V), 1.0)
    assert torch.equal(a, chol_rank_update(t(L), t(Vp), 1.0))
    assert torch.equal(chol_rank_update(t(L), t(np.zeros((4, 23))), -1.0),
                       t(L))
    r, w = rng.normal(size=5), rng.uniform(0.5, 2, 5)
    rp, wp = np.zeros(16), np.zeros(16)
    rp[[1, 4, 6, 11, 15]], wp[[1, 4, 6, 11, 15]] = r, w
    dx, b = 1e-3 * rng.normal(size=23), rng.normal(size=23)
    c2 = t(np.float64(2.0))
    x = stream_ingest(t(L), t(b), c2, t(V), t(r), t(w), t(dx), 1.0)
    y = stream_ingest(t(L), t(b), c2, t(Vp), t(rp), t(wp), t(dx), 1.0)
    assert torch.equal(x[0], y[0])
    assert np.allclose(x[1].numpy(), y[1].numpy(), rtol=1e-15, atol=0)


def _k9_wavefront(L, V, sign, pass_rows):
    """K9's order on the card in plain torch: the nonzero rows of ``V`` in
    passes of ``pass_rows``, each pass a wavefront -- at step t, row m of
    the pass takes column j = t - m: its owner's (r, c, s) from L[j, j] and
    x_m[j], L[j, j] = r, then the rows below j of column j and of x_m --
    with the plain version's formulas."""
    L = L.clone()
    K = L.shape[0]
    rows = [V[r].clone() for r in range(V.shape[0])
            if bool((V[r] != 0).any())]
    for p0 in range(0, len(rows), pass_rows):
        xs = rows[p0:p0 + pass_rows]
        n = len(xs)
        for t in range(n + K - 1):
            active = [(m, t - m) for m in range(n) if 0 <= t - m < K]
            cs = {}
            for m, j in active:
                d, xj = L[j, j].clone(), xs[m][j].clone()
                rr = torch.sqrt(d * d + sign * xj * xj)
                cs[m] = (rr / d, xj / d)
                L[j, j] = rr
            for m, j in active:
                c, s = cs[m]
                xi = xs[m][j + 1:]
                col = (L[j + 1:, j] + (sign * s) * xi) / c
                L[j + 1:, j] = col
                xs[m][j + 1:] = c * xi - s * col
    return L


@pytest.mark.parametrize("pass_rows", [3, 48])
@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["update", "downdate"])
@pytest.mark.parametrize("K", [12, 23])
def test_k9_wavefront_order_is_bitwise_the_plain_version(K, sign,
                                                         pass_rows):
    """The wavefront over rows (one pass, or passes of 3 rows), with zero
    rows interleaved, gives ``chol_rank_update_reference``'s factor and,
    on weighted rows, ``stream_ingest_reference``'s, bitwise: each entry
    takes the rows' updates in row order either way."""
    from pint_torch.kernels.chol_rank_update import (
        chol_rank_update_reference, stream_ingest_reference)

    L, rng = _spd_factor(K, 40 + K)
    V = rng.normal(size=(16, K))
    V[[0, 3, 4, 9, 15]] = 0.0
    t = torch.tensor
    L, V = t(L), t(V)
    if sign < 0:
        L = chol_rank_update_reference(L, V, 1.0)
    want = chol_rank_update_reference(L, V, sign)
    assert torch.equal(_k9_wavefront(L, V, sign, pass_rows), want)
    w = t(rng.uniform(0.5, 2.0, 16))
    w[[2, 7]] = 0.0
    r, dx, b = t(rng.normal(size=16)), t(1e-3 * rng.normal(size=K)), \
        t(rng.normal(size=K))
    got = stream_ingest_reference(L, b, t(np.float64(3.0)), V, r, w, dx,
                                  sign)[0]
    mine = _k9_wavefront(L, torch.sqrt(w)[:, None] * V, sign, pass_rows)
    # a weighted downdate may drive a diagonal through zero: NaN alike
    assert torch.equal(torch.isnan(mine), torch.isnan(got))
    assert torch.equal(torch.nan_to_num(mine), torch.nan_to_num(got))


def test_downdate_of_absent_rows_is_refused_like_the_reference():
    """A downdate of rows never in the factor: NaN, ``ok`` false, and the
    reference's reason text; nothing raises."""
    from pint_torch.streaming.lowrank import apply_rank_update as P
    from pint_tpu.streaming.lowrank import apply_rank_update as R

    L, rng = _spd_factor(12, 9)
    V = 40.0 * rng.normal(size=(3, 12))
    got, want = P(torch.tensor(L), V, downdate=True), R(L, V, downdate=True)
    assert not got.ok and not want.ok
    assert got.reason == want.reason \
        == "non-finite/non-PD updated factor (downdate left a non-PD system)"
    assert not bool(torch.isfinite(got.L).all())


def test_condition_guard_refuses_like_the_reference():
    """Past ``cond_limit`` the update is refused with the reference's
    reason (the proxy formatted alike); under it, it stands."""
    from pint_torch.streaming.lowrank import apply_rank_update as P
    from pint_torch.streaming.lowrank import factor_condition
    from pint_tpu.streaming.lowrank import apply_rank_update as R

    L, rng = _spd_factor(12, 11)
    V = rng.normal(size=(2, 12))
    got, want = P(torch.tensor(L), V, cond_limit=1.0), R(L, V, cond_limit=1.0)
    assert not got.ok and got.reason == want.reason
    assert got.reason.startswith("condition proxy ")
    assert abs(got.condition / want.condition - 1.0) <= 1e-13
    ok = P(torch.tensor(L), V)
    assert ok.ok and ok.reason == ""
    assert ok.condition == factor_condition(ok.L)


# ---------------------------------------------------------------------------
# the small stream, live in both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The reference's stand-in and its run of the schedule, and the
    port's model and TOAs from the reference's exported state."""
    from pint_torch.bridge import load_snapshot

    model, toas = standin.make_standin(S, full=False)
    run = standin.reference_stream(
        model, toas, S, tmpdir=str(tmp_path_factory.mktemp("ref")))
    arrays = standin.export_state(model, toas)
    arrays.update(standin._integrity_arrays(toas))
    import json

    meta = json.loads(str(arrays["meta"]))
    meta["coverage"] = standin._integrity_meta(toas)
    meta["reference"] = {"settings": S}
    arrays["meta"] = np.asarray(json.dumps(meta))
    m, b = load_snapshot(arrays, device="cpu")
    return dict(model=model, toas=toas, run=run, m=m, b=b, meta=meta)


def _mask(n, idx):
    k = np.zeros(n, dtype=bool)
    k[idx] = True
    return k


def _port_blocks(m, b, meta):
    from pint_torch.bridge import stream_schedule
    from pint_torch.toa import merge_TOAs

    base, rows, dup, _ = stream_schedule(meta)
    out = []
    for i, r in enumerate(rows):
        blk = b.select(_mask(b.ntoas, r), m)
        if i == dup:
            blk = merge_TOAs([blk, b.select(_mask(b.ntoas, r[:1]), m)])
        out.append(blk)
    return b.select(_mask(b.ntoas, base), m), out


def _port_base_fit(small):
    from pint_torch.gls_fitter import GLSFitter

    base, _ = _port_blocks(small["m"], small["b"], small["meta"])
    f = GLSFitter(base, small["m"])
    f.fit_toas(maxiter=S["fit_maxiter"])
    return f


@pytest.fixture(scope="module")
def port_run(small):
    """The port's run of the schedule: its engine and outcomes, with each
    operation's uncertainties."""
    from pint_torch.streaming import StreamingGLS

    _, blocks = _port_blocks(small["m"], small["b"], small["meta"])
    eng = StreamingGLS(_port_base_fit(small))
    ntm = len(eng.cache.params)
    ops, errs = [], []

    def rec(o):
        ops.append(o)
        e = eng.cache.errors()[:ntm]
        errs.append(np.array([x for p, x in zip(eng.cache.params, e)
                              if p != "Offset"]))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for blk in blocks:
            rec(eng.update_toas(blk))
        after = eng.cache.state_dict()
        qb, qrows = ops[-1].block_id, S["stream"]["quarantine"]
        rec(eng.quarantine_rows(qb, qrows))
        rec(eng.release_quarantined(qb, qrows))
        nval = len(eng.apply_validation())
    return dict(eng=eng, ops=ops, errs=errs, after=after, nval=nval)


def _reason_class(reason):
    return None if reason is None else " ".join(reason.split()[:2])


def test_small_stream_matches_the_reference_op_by_op(small, port_run):
    """Every operation's kind, block, quarantined rows, steps, block id
    and fallback reason class exactly (one fallback, at the third
    append); chi2 1e-6 rel, values within 1e-2 of their uncertainty,
    uncertainties 1e-6 rel."""
    run, design = small["run"], small["run"]["design"]
    assert len(port_run["ops"]) == len(run["ops"])
    fb = [i for i, o in enumerate(run["ops"]) if o["fallback"]]
    assert fb == [2]
    for o, e, want in zip(port_run["ops"], port_run["errs"], run["ops"]):
        assert (o.kind, o.block, o.quarantined, o.steps, o.block_id) == (
            want["kind"], want["block"], want["quarantined"], want["steps"],
            want["block_id"])
        assert _reason_class(o.fallback) == _reason_class(want["fallback"])
        assert abs(o.chi2 / want["chi2"] - 1.0) <= 1e-6
        vals = np.array([o.params[p] for p in design])
        assert np.all(np.abs(vals - want["values"]) <= 1e-2 * want["errors"])
        assert np.all(np.abs(e / want["errors"] - 1.0) <= 1e-6)
    assert port_run["nval"] == run["validation_ops"] == 0
    assert port_run["eng"].rebuilds == run["rebuilds"] == 1


def test_factor_matches_the_reference_and_a_fresh_cholesky(small, port_run):
    """The final factor within 1e-9 x max|L| of the reference's, and of a
    fresh Cholesky of the frame Gram of the alive rows."""
    c = port_run["eng"].cache
    L = c.L.numpy()
    want = small["run"]["states"]["final"]["L"]
    assert np.max(np.abs(L - want)) <= 1e-9 * np.max(np.abs(want))
    A = np.diag(c.phiinv.numpy())
    for blk in c.blocks:
        M, w = blk.M.numpy()[blk.alive], blk.w.numpy()[blk.alive]
        A = A + (M.T * w) @ M
    fresh = np.linalg.cholesky(A)
    assert np.max(np.abs(L - fresh)) <= 1e-9 * np.max(np.abs(fresh))


def test_pen_quarantine_release_and_validation(small, port_run):
    """The duplicate row is penned (one pen entry, its reason the
    reference's check), the quarantined rows leave the certified union and
    come back on release without a rebuild, and ``apply_validation`` of a
    clean union changes nothing."""
    eng = port_run["eng"]
    assert len(eng.pen) == 1
    penned, reasons = eng.pen[0]
    assert penned.ntoas == 1 and reasons[0][0].startswith("duplicate of row")
    n = sum(len(blk.r) for blk in eng.cache.blocks)
    assert eng.cache.toas.ntoas == n == small["b"].ntoas
    assert eng.fitter.batch.ntoas == n
    qb = port_run["ops"][-3].block_id
    before = eng.rebuilds
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        o = eng.quarantine_rows(qb, [1, 2])
        assert o.fallback is None
        assert eng.fitter.batch.ntoas == n - 2
        assert eng.cache.toas.n_quarantined == 2
        assert eng.apply_validation() == []
        o = eng.release_quarantined(qb, [1, 2])
    assert o.fallback is None and eng.rebuilds == before
    assert eng.fitter.batch.ntoas == n
    with pytest.raises(ValueError, match="not quarantined"):
        eng.release_quarantined(qb, [1])


def test_checkpointed_stream_resumes_bitwise(small, port_run, tmp_path,
                                             monkeypatch):
    """``stream_updates`` cut after two of the five appends (just before
    the fallback, after half the chunks) and resumed on a fresh engine
    equals the uninterrupted stream bitwise, as the reference's does."""
    from pint_torch.streaming import StreamingGLS, stream_updates
    from pint_torch.streaming import update as up

    want = small["run"]["checkpoint"]["cut_half"]
    assert want == dict(cut=2, refused=False, ran=3, bitwise=True)
    _, blocks = _port_blocks(small["m"], small["b"], small["meta"])
    orig = up._invoke_stream

    def cut(engine, batch, index):
        if index == want["cut"]:
            raise KeyboardInterrupt
        return orig(engine, batch, index)

    path = str(tmp_path / "stream")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        monkeypatch.setattr(up, "_invoke_stream", cut)
        with pytest.raises(KeyboardInterrupt):
            stream_updates(StreamingGLS(_port_base_fit(small)), blocks,
                           checkpoint=path)
        monkeypatch.setattr(up, "_invoke_stream", orig)
        eng = StreamingGLS(_port_base_fit(small))
        outs = stream_updates(eng, blocks, checkpoint=path)
    assert len(outs) == want["ran"]
    got, ref = eng.cache.state_dict(), port_run["after"]
    for k in ("L", "b", "x", "chi2"):
        assert np.array_equal(got[k], ref[k]), k
    assert len(eng.pen) == 1


def test_resume_refused_after_a_frame_rebuild(small, port_run):
    """A state saved after a fallback rebuild lives in a re-frozen frame:
    a fresh engine refuses it, as the reference's does."""
    from pint_torch.runtime.checkpoint import CheckpointError
    from pint_torch.streaming import StreamingGLS

    eng = StreamingGLS(_port_base_fit(small))
    with pytest.raises(CheckpointError, match="different linearization"):
        eng.cache.load_state(port_run["eng"].cache.state_dict())


def test_update_door_coalesces_and_refuses(small):
    """Two appends in one pass merge into one block (one rank-k
    dispatch); a batch with an invalid member refuses before anything is
    applied (the factor unchanged); row operations apply in order."""
    from pint_torch.fitter import UsageError
    from pint_torch.streaming import (StreamingGLS, UpdateRequest,
                                      run_update_requests, warm_stream)

    _, blocks = _port_blocks(small["m"], small["b"], small["meta"])
    eng = StreamingGLS(_port_base_fit(small))
    res = run_update_requests(eng, [
        UpdateRequest(new_toas=blocks[0], request_id="a"),
        UpdateRequest(new_toas=blocks[1], request_id="b")])
    assert [r.batch for r in res] == [2, 2]
    assert [r.first_in_batch for r in res] == [True, False]
    assert res[0].outcome is res[1].outcome
    assert res[0].outcome.block == blocks[0].ntoas + blocks[1].ntoas
    assert res[0].quarantined == 1 and res[1].quarantined == 0
    bid = res[0].outcome.block_id
    L0 = eng.cache.L.clone()
    for bad in ([UpdateRequest(kind="quarantine", block_id=bid, rows=[0]),
                 UpdateRequest(kind="quarantine", block_id=bid, rows=[0])],
                [UpdateRequest(kind="release", block_id=bid, rows=[1])],
                [UpdateRequest(kind="quarantine", block_id=bid, rows=[99])],
                [UpdateRequest(kind="quarantine", block_id=77, rows=[0])]):
        with pytest.raises(UsageError):
            run_update_requests(eng, bad)
        assert torch.equal(eng.cache.L, L0)
    res = run_update_requests(eng, [
        UpdateRequest(kind="quarantine", block_id=bid, rows=[0, 1]),
        UpdateRequest(kind="release", block_id=bid, rows=[1])])
    assert [r.kind for r in res] == ["quarantine", "release"]
    assert list(eng.cache._block(bid).alive[:2]) == [False, True]
    with pytest.raises(UsageError):
        UpdateRequest(kind="release", block_id=bid, rows=[])
    with pytest.raises(NotImplementedError, match="item 8"):
        warm_stream(eng, pool=object())


def test_sliced_contexts_equal_the_references_block_evaluation(small):
    """A block with the sentinel row (the stream's frame rows): its tdb0
    and seconds, each sliced context (DMX windows, the JUMP and EFAC/EQUAD
    masks), the scaled uncertainties and the red-noise basis and weights
    bitwise the reference's own evaluation of the merged block alone."""
    from pint_torch.toa import merge_TOAs as pmerge
    from pint_tpu.toa import merge_TOAs as rmerge

    model, toas, m, b = small["model"], small["toas"], small["m"], small["b"]
    rows = np.arange(56, 64)
    rt = rmerge([toas[np.array([0])], toas[rows]])
    pt = pmerge([b.select(_mask(b.ntoas, [0]), m),
                 b.select(_mask(b.ntoas, rows), m)])
    rb = rt.to_batch()
    assert pt.tdb0 == float(rb.tdb0)
    assert np.array_equal(pt.tdb_s.hi.numpy(), np.asarray(rb.tdb_s.hi))
    assert np.array_equal(pt.tdb_s.lo.numpy(), np.asarray(rb.tdb_s.lo))
    for name in ("DispersionDMX", "PhaseJump", "ScaleToaError"):
        want = model.components[name].build_context(rt)
        got = pt.contexts[name]
        if name == "ScaleToaError":
            from pint_tpu.models.parameter import maskParameter

            comp = model.components[name]
            for p, mm in got["masks"].items():
                par = comp._params_dict[p]
                assert isinstance(par, maskParameter)
                ref = np.zeros(len(rt), dtype=bool)
                ref[par.select_toa_mask(rt)] = True
                assert np.array_equal(mm, ref), p
            continue
        flat = {}
        standin._flatten(name, want, flat)
        for k, v in flat.items():
            leaf = got
            for part in k.split("/")[1:]:
                leaf = leaf[part]
            assert np.array_equal(np.asarray(leaf, dtype=float),
                                  np.asarray(v, dtype=float)), k
    assert np.array_equal(m.scaled_toa_uncertainty(pt),
                          np.asarray(model.scaled_toa_uncertainty(rt)))
    Ur, wr, _ = model.noise_basis_by_component(rt)
    Up, wp, _ = m.noise_basis_by_component(pt)
    assert np.array_equal(np.hstack(Up), np.hstack(Ur))
    assert np.array_equal(np.concatenate(wp), np.concatenate(wr))


def test_set_dependent_contexts_come_from_the_subset():
    """ECORR epochs and a red-noise basis over the data span depend on the
    whole set: a selected subset derives both from its own rows, as the
    reference's ``toas[mask]`` does (noise bases and weights bitwise)."""
    from pint_torch.toa import _set_dependent

    model, toas, m, b = standin.port_and_reference(standin.SMALL_SETTINGS)
    assert sorted(_set_dependent(m).values()) \
        == ["ECORR epochs", "a basis over the data span"]
    keep = np.arange(b.ntoas) < 40
    Ur, wr, _ = model.noise_basis_by_component(toas[keep])
    Up, wp, _ = m.noise_basis_by_component(b.select(keep, m))
    assert np.array_equal(np.hstack(Up), np.hstack(Ur))
    assert np.array_equal(np.concatenate(wp), np.concatenate(wr))


def test_validate_gate_and_row_delta(small):
    """``validate`` on a batch with a duplicate: strict raises, collect
    quarantines the later copy with the reference's message, the delta
    against the previous pass, certified and quarantined views."""
    from pint_torch.toa import TOAIntegrityError, merge_TOAs
    from pint_tpu.toa import merge_TOAs as rmerge

    m, b, toas = small["m"], small["b"], small["toas"]
    rows = np.arange(40, 48)
    blk = merge_TOAs([b.select(_mask(b.ntoas, rows), m),
                      b.select(_mask(b.ntoas, rows[:1]), m)])
    with pytest.raises(TOAIntegrityError):
        blk.validate()
    rep = blk.validate(policy="collect")
    want = rmerge([toas[rows], toas[rows[:1]]]).validate(policy="collect")
    assert rep.render() == want.render()
    assert rep.delta.added == tuple(range(8)) and rep.n_quarantined == 1
    assert blk.certified().ntoas == 8 and blk.quarantined().ntoas == 1
    again = blk.validate(policy="collect")
    assert again.delta.empty and blk.last_validation is again
