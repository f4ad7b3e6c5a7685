"""The port's PTA catalogue (``pint_torch/catalog``) and its hand kernel K10
(``pint_torch/kernels/hd_cross_lnlike.py``) against the JAX package's
catalogue on the CPU.

The reference catalogue test's own 16-pulsar catalogue (``make_synthetic_
catalog(16, seed=7, ntoa_range=(24, 64), bad_rows_in=(3, 11))``) is built
live by the reference, run through its catalogue path (ingest, buckets, two
``fit(maxiter=1)`` passes, ``refine``, the joint likelihood at 8 points, an
8-walker x 3-step chain) and exported in-process; the port loads the
export with :func:`pint_torch.bridge.load_catalog_snapshot` and runs the
same path.  Bars: the Hellings-Downs curve's pins at 1e-12, the matrix and
its factor at 1e-12; ladders, bucket members, padding waste and the
ingest gate's rows and codes exactly; the port's residuals within 1e-10 s
of the reference's, then, on the reference's residuals (the same inputs:
the reference's jitted residuals round ~1e-13 s apart from its own eager
arithmetic, which the port follows, and that is ~2e-8 of these chi2), each
batched step within 1e-6 of its error, errors and chi2 within 1e-9 rel;
after the passes and the refine, values within 1e-6 sigma; the per-pulsar
log-likelihoods 1e-9 rel, the joint one 1e-9 x max(1, |ref|), its cross
term 1e-8 x max(1, |ref cross|); at zero amplitude the cross term exactly
0.0 and the joint value the per-pulsar sum to 1e-12 rel; K10's plain
version against the reference's ``_joint_kernel`` cross term at 3 and 5
modes and on synthetic operands with a padded member; the card's blocked
schedule bitwise the plain version, its workspace cap, the gradient of
the plain version and the card's refusal of one; the chain bitwise;
the refusals.
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

#: the reference test's catalogue at a short depth: two fit passes, 4 + 4
#: joint-likelihood points, an 8-walker x 3-step chain
S = dict(standin.SMALL_CATALOG_SETTINGS, fit_passes=2, bench_points=4,
         seeded_points=4, walkers=8, chain_steps=3)
P = "ref/catalog/"


def _split(a, lens):
    return np.split(np.asarray(a), np.cumsum(lens)[:-1])


@pytest.fixture(scope="module")
def both():
    """The reference's run and its export, and the port's catalogue loaded
    from the export on the CPU, ingested and fitted, with the requests of
    each pass (captured from the fitter) and the reference's residuals of
    each pass substituted into them."""
    from pint_torch.bridge import load_catalog_snapshot, read_snapshot
    from pint_torch.catalog import CatalogFitter, ingest_catalog

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pairs = standin.catalog_pairs(S)
        run = standin.reference_catalog(pairs, S)
        arrays = standin.export_catalog(S, pairs=pairs, run=run)
        meta, ref = read_snapshot(dict(arrays))
        report = ingest_catalog(load_catalog_snapshot(dict(arrays),
                                                      device="cpu"))
    cf = CatalogFitter(report)
    taken = []
    orig = cf._requests
    cf._requests = lambda: taken.append(orig()) or taken[-1]
    fits = [cf.fit(maxiter=1) for _ in range(S["fit_passes"])]
    refine = cf.refine(steps=S["refine_steps"])
    return dict(run=run, ref=ref, meta=meta["reference"]["catalog"],
                report=report, cf=cf, fits=fits, refine=refine,
                taken=taken, pairs=pairs)


def _on(reqs, r_concat):
    """The requests ``reqs`` with the residuals ``r_concat`` (concatenated
    over the members) in place of their own."""
    from pint_torch.serving import FitRequest

    return [FitRequest(M=q.M, r=x, w=q.w, phiinv=q.phiinv, params=q.params,
                       norm=q.norm, request_id=q.request_id, device="cpu")
            for q, x in zip(reqs, _split(r_concat, [q.n_toas for q in reqs]))]


def _lanes(cf, reqs, fn):
    """Each member's outputs of ``fn`` over the fitter's bucket groups."""
    outs = [None] * len(reqs)
    for bucket, idx in sorted(cf.bucket_plan.buckets.items()):
        o = [x.numpy() for x in fn(*cf._group_operands(
            bucket, [reqs[i] for i in idx]))]
        for j, i in enumerate(idx):
            outs[i] = [x[j] for x in o]
    return outs


@pytest.fixture(scope="module")
def joint(both):
    """The port's joint likelihood on the fitted catalogue (its own
    residuals) and on the reference's residuals of the same state."""
    from pint_torch.catalog import JointLikelihood

    cf = both["cf"]
    same = _on(both["taken"][-1], both["ref"][P + "final_r"])
    return (JointLikelihood(cf, n_modes=S["n_modes"]),
            JointLikelihood(cf, n_modes=S["n_modes"], requests=same))


# ---------------------------------------------------------------------------
# Hellings-Downs geometry
# ---------------------------------------------------------------------------
def test_hd_curve_pins_and_arrays():
    from pint_torch.catalog import hd_curve
    from pint_tpu.catalog import hd_curve as ref

    pins = {np.pi / 3: -0.08236038541995894, np.pi / 2: -0.14486038541995894,
            2 * np.pi / 3: -0.011142331508253611, np.pi: 0.25, 0.0: 0.5}
    for g, want in pins.items():
        assert abs(hd_curve(g) - want) < 1e-12
        assert isinstance(hd_curve(g), float)
    g = np.linspace(0.0, np.pi, 37)
    assert np.array_equal(hd_curve(g), ref(g))
    assert abs(hd_curve(1e-12) - 0.5) < 1e-9


def test_hd_matrix_and_factor_match_the_reference(both):
    from pint_torch.catalog import (angular_separations, hd_cholesky,
                                    hd_matrix, pulsar_directions)
    from pint_tpu.catalog import hd_cholesky as rchol
    from pint_tpu.catalog import hd_matrix as rmat
    from pint_tpu.catalog import pulsar_directions as rdirs

    dirs = pulsar_directions([p.model for p in both["report"].pulsars])
    want = rdirs([p.model for p in both["run"]["report"].pulsars])
    assert np.max(np.abs(dirs - want)) <= 1e-12
    orf = hd_matrix(dirs)
    assert np.max(np.abs(orf - rmat(want))) <= 1e-12
    assert np.array_equal(orf, orf.T) and np.all(np.diag(orf) == 1.0)
    L = hd_cholesky(dirs)
    assert np.max(np.abs(L - rchol(want))) <= 1e-12
    assert np.max(np.abs(L @ L.T - orf)) <= 1e-12
    from pint_torch.fitter import UsageError

    with pytest.raises(UsageError):
        angular_separations(np.array([[2.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    with pytest.raises(UsageError):
        angular_separations(np.zeros((3, 2)))


def test_psr_direction_needs_astrometry(both):
    from pint_torch.models.timing_model import MissingComponent

    m = both["report"].pulsars[0].model.copy()
    for name in [n for n in m.components if n.startswith("Astrometry")]:
        m.components.pop(name)
    with pytest.raises(MissingComponent):
        m.psr_direction()


# ---------------------------------------------------------------------------
# ladders, buckets and the gate
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shapes, budget, rungs", [
    ([(24, 8), (30, 8), (61, 10), (64, 10), (40, 9)], 0.25, 4),
    ([(10, 4), (100, 4), (1000, 4)], 0.1, 1),
    ([(100 + 7 * i, 6 + i % 3) for i in range(40)], 0.05, 3)])
def test_ladders_and_assignment_match_the_reference(shapes, budget, rungs):
    from pint_torch.catalog import assign_buckets, learn_ladders
    from pint_tpu.catalog import assign_buckets as rassign
    from pint_tpu.catalog import learn_ladders as rlearn

    lad = learn_ladders(shapes, pad_budget=budget, max_rungs=rungs)
    assert lad == rlearn(shapes, pad_budget=budget, max_rungs=rungs)
    got = assign_buckets(shapes, *lad)
    want = rassign(shapes, *lad, emit=False)
    assert got.buckets == want.buckets
    assert got.pad_waste_frac == want.pad_waste_frac
    assert got.to_dict() == want.to_dict()
    assert list(assign_buckets([(200, 4)], (64,), (8,)).buckets) \
        == [(256, 8)]


def test_ladder_refusals():
    from pint_torch.catalog import assign_buckets, learn_ladders
    from pint_torch.fitter import UsageError

    for bad in (lambda: learn_ladders([]), lambda: learn_ladders([(0, 4)]),
                lambda: learn_ladders([(10, 4)], pad_budget=1.5),
                lambda: learn_ladders([(10, 4)], max_rungs=0),
                lambda: assign_buckets([], (64,), (8,))):
        with pytest.raises(UsageError):
            bad()


def test_catalogue_buckets_equal_the_reference(both):
    cf, B = both["cf"], both["meta"]["buckets"]
    assert [list(s) for s in cf.shapes] == B["shapes"]
    assert list(cf.bucket_plan.ntoa_ladder) == B["ntoa_ladder"]
    assert list(cf.bucket_plan.nfree_ladder) == B["nfree_ladder"]
    assert {f"{bn}x{bk}": idx for (bn, bk), idx
            in cf.bucket_plan.buckets.items()} == B["members"]
    assert cf.bucket_plan.pad_waste_frac == B["pad_waste_frac"]
    assert cf.bucket_plan.n_buckets < len(cf.pulsars)


def test_ingest_gate_equals_the_reference(both):
    rep, I = both["report"], both["meta"]["ingest"]
    assert {k: v for k, v in rep.to_dict().items()} \
        == {k: v for k, v in I.items()
            if k not in ("members", "quarantined_rows")}
    assert [dict(name=p.name, n_toas=p.n_toas, n_quarantined=p.n_quarantined,
                 codes=list(p.quarantine_codes))
            for p in rep.pulsars] == I["members"]
    assert [p.n_quarantined for p in rep.pulsars].count(1) == 2
    assert [len(rows) for rows in I["quarantined_rows"]].count(1) == 2
    assert "toa-bad-error" in rep.codes()


def test_ingest_excludes_and_refuses():
    from pint_torch.bridge import CATALOG_SMALL_PATH, load_catalog_snapshot
    from pint_torch.catalog import ingest_catalog
    from pint_torch.fitter import UsageError

    pairs = load_catalog_snapshot(CATALOG_SMALL_PATH, device="cpu")[:2]
    # every row of the second member with a zero uncertainty: excluded
    pairs[1][1].error_us.zero_()
    rep = ingest_catalog(pairs)
    assert rep.n_pulsars == 1 and len(rep.excluded) == 1
    assert "cannot constrain" in rep.excluded[0][1]
    with pytest.raises(UsageError):
        ingest_catalog(pairs[1:])
    with pytest.raises(UsageError):
        ingest_catalog([("only-one-element",)])
    with pytest.raises(UsageError):
        ingest_catalog([])
    # a (par, tim) pair is read from its files, absent ones refused
    with pytest.raises(FileNotFoundError):
        ingest_catalog([("J0000.par", "J0000.tim")], device="cpu")


# ---------------------------------------------------------------------------
# the batched fit and the refine
# ---------------------------------------------------------------------------
def test_fit_passes_at_the_serve_bars(both):
    """Each pass: the port's requests' residuals within 1e-10 s of the
    reference's; on the reference's residuals, each batched step within
    1e-6 of its error, errors, chi2 and the initial chi2 within 1e-9 rel;
    the applied steps, errors and values within 1e-6 sigma / 1e-9 rel of
    the reference's pass."""
    from pint_torch.catalog import catalog_batched

    ref, cf = both["ref"], both["cf"]
    for k, (reqs, fit) in enumerate(zip(both["taken"], both["fits"])):
        Q = f"{P}pass{k}/"
        r_own = np.concatenate([q.r.numpy() for q in reqs])
        assert np.max(np.abs(r_own - ref[Q + "r"])) <= 1e-10
        outs = _lanes(cf, _on(reqs, ref[Q + "r"]), catalog_batched())
        dx = np.concatenate([o[0][:len(q.params)]
                             for o, q in zip(outs, reqs)])
        err = np.concatenate([o[1][:len(q.params)]
                              for o, q in zip(outs, reqs)])
        e = ref[Q + "lin_err"]
        assert np.max(np.abs(dx - ref[Q + "lin_dx"]) / e) <= 1e-6
        assert np.max(np.abs(err / e - 1)) <= 1e-9
        assert np.max(np.abs(np.array([o[2] for o in outs])
                             / ref[Q + "lin_chi2"] - 1)) <= 1e-9
        assert np.max(np.abs(np.array([o[3] for o in outs])
                             / ref[Q + "chi2_initial"] - 1)) <= 1e-9
        errs = np.concatenate([[f.errors[n] for n in f.errors]
                               for f in fit.fits])
        steps = np.concatenate([[f.dpars[n] for n in f.dpars]
                                for f in fit.fits])
        assert np.max(np.abs(errs / ref[Q + "errors"] - 1)) <= 1e-9
        assert np.max(np.abs(steps - ref[Q + "dpars"])
                      / ref[Q + "errors"]) <= 1e-6
        assert [list(f.bucket) for f in fit.fits] \
            == both["meta"]["passes"][k]["buckets"]
        assert fit.n_buckets == both["meta"]["passes"][k]["n_buckets"]
        assert fit.pad_waste_frac \
            == both["meta"]["passes"][k]["pad_waste_frac"]
        # the post-fit chi2 of the port's own residuals: the fit bar
        assert np.max(np.abs(np.array([f.chi2 for f in fit.fits])
                             / ref[Q + "chi2"] - 1)) <= 1e-6


def test_values_after_the_passes_within_1e6_sigma(both):
    ref, design = both["ref"], both["meta"]["design"]
    last = f"{P}pass{S['fit_passes'] - 1}/"
    fit = both["fits"][-1]
    vals = np.concatenate([[p.fitted_model[n].value for n in d]
                           for p, d in zip(both["report"].pulsars, design)])
    sig = np.concatenate([[f.errors[n] for n in d]
                          for f, d in zip(fit.fits, design)])
    assert np.max(np.abs(vals - ref[last + "values"]) / sig) <= 1e-6
    # the steps land in the fitters' models; the ingest models stay
    for p, d in zip(both["report"].pulsars, design):
        assert p.model is not p.fitted_model
        assert any(p.model[n].value != p.fitted_model[n].value for n in d)


def test_refine_at_the_bars(both):
    """The fused 8-step refine: one call per bucket; on the reference's
    residuals each member's chi2 trajectory within 1e-9 rel and its first
    step within 1e-6 sigma; the port's own run within 1e-6 rel and
    sigma."""
    from pint_torch.catalog import catalog_fused

    ref, cf, rf = both["ref"], both["cf"], both["refine"]
    reqs = both["taken"][-1]
    outs = _lanes(cf, _on(reqs, ref[P + "final_r"]),
                  catalog_fused(steps=S["refine_steps"]))
    e = ref[f"{P}pass{S['fit_passes'] - 1}/errors"]
    cs = np.stack([o[2] for o in outs])
    assert np.max(np.abs(cs / ref[P + "refine/chi2_steps"] - 1)) <= 1e-9
    d1 = np.concatenate([o[0][0][:len(q.params)] / q.norm[:len(q.params)]
                         for o, q in zip(outs, reqs)])
    assert np.max(np.abs(d1 - ref[P + "refine/dpars_first"]) / e) <= 1e-6
    assert rf.dispatches == both["meta"]["refine"]["dispatches"] \
        == cf.bucket_plan.n_buckets
    own = np.stack([rf.chi2_steps[p.name] for p in both["report"].pulsars])
    assert np.max(np.abs(own / ref[P + "refine/chi2_steps"] - 1)) <= 1e-6
    own1 = np.concatenate([[rf.dpars_first[p.name][n]
                            for n in rf.dpars_first[p.name]]
                           for p in both["report"].pulsars])
    assert np.max(np.abs(own1 - ref[P + "refine/dpars_first"]) / e) <= 1e-6


# ---------------------------------------------------------------------------
# the joint likelihood and K10
# ---------------------------------------------------------------------------
def test_joint_likelihood_at_the_bars(both, joint):
    ref, meta = both["ref"], both["meta"]["likelihood"]
    own, same = joint
    assert same.pad_shape == tuple(meta["pad_shape"]) == own.pad_shape
    assert same.Tspan == meta["Tspan"]
    assert np.max(np.abs(same.Lhd - ref[P + "likelihood/Lhd"])) <= 1e-12
    pp = same.per_pulsar_lnlike()
    assert pp.shape == (len(both["report"].pulsars),)
    assert np.max(np.abs(pp / ref[P + "likelihood/per_pulsar"] - 1)) <= 1e-9
    pts = ref[P + "likelihood/points"]
    want = ref[P + "likelihood/lnlike"]
    got = same.lnlike_batch(pts)
    assert np.max(np.abs(got - want) / np.maximum(1, np.abs(want))) <= 1e-9
    nc = same.lnlike_nocommon()
    cross, want_cross = got - nc, want - meta["nocommon"]
    assert np.max(np.abs(cross - want_cross)
                  / np.maximum(1, np.abs(want_cross))) <= 1e-8
    assert abs(same.lnlike(*pts[2]) - got[2]) == 0.0
    # the port's own residuals: the joint value at its bar too
    mine = own.lnlike_batch(pts)
    assert np.max(np.abs(mine - want) / np.maximum(1, np.abs(want))) <= 1e-9


def test_factorization_pin(joint):
    """At log10_A = -inf the cross term is exactly 0.0 and the joint value
    the per-pulsar sum to 1e-12 rel (the reference's acceptance pin)."""
    for jl in joint:
        cross = jl.cross_batch(np.array([[-np.inf, 4.33], [-np.inf, 2.0]]))
        assert cross.tolist() == [0.0, 0.0]
        parts = jl.per_pulsar_lnlike()
        assert abs(jl.lnlike_nocommon() - parts.sum()) \
            <= 1e-12 * abs(parts.sum())
        assert jl.lnlike(-13.0, 13.0 / 3.0) != jl.lnlike_nocommon()


@pytest.mark.parametrize("n_modes", [3, 5])
def test_k10_plain_version_against_the_reference_cross_term(both, n_modes):
    """K10's plain version (through the port's joint likelihood on the
    reference's residuals) against the reference's ``_joint_kernel``
    cross term, at 8 points and 3 and 5 modes."""
    from pint_torch.catalog import JointLikelihood
    from pint_tpu.catalog import JointLikelihood as RJL

    rjl = RJL(both["run"]["cf"], n_modes=n_modes)
    same = JointLikelihood(both["cf"], n_modes=n_modes, requests=_on(
        both["taken"][-1], both["ref"][P + "final_r"]))
    pts = both["ref"][P + "likelihood/points"]
    want = np.asarray(rjl.lnlike_batch(pts)) - float(rjl.lnlike_nocommon())
    got = same.cross_batch(pts).numpy()
    assert np.max(np.abs(got - want) / np.maximum(1, np.abs(want))) <= 1e-8
    assert same.G.shape == (len(same.pulsars) * 2 * n_modes,) * 2


@pytest.mark.parametrize("n_modes", [2, 3])
def test_k10_and_blocks_against_the_reference_joint_kernel(n_modes):
    """The port's per-pulsar blocks, G, u and K10's plain version against
    the reference's ``_joint_kernel`` on well-conditioned synthetic
    operands with a padded member (its last column and two rows padding),
    at a nonzero and a zero amplitude."""
    import jax.numpy as jnp

    from pint_torch.catalog.crosscorr import hd_cholesky
    from pint_torch.catalog.likelihood import _pulsar_blocks
    from pint_torch.kernels.hd_cross_lnlike import hd_cross_lnlike
    from pint_tpu.catalog.likelihood import _joint_kernel

    rng = np.random.default_rng(2 + n_modes)
    n_p, n, k, m = 4, 14, 3, n_modes
    M = rng.normal(size=(n_p, n, k))
    r = rng.normal(size=(n_p, n))
    w = rng.uniform(0.5, 2.0, size=(n_p, n))
    phiinv = rng.uniform(0.5, 2.0, size=(n_p, k))
    pad = np.zeros((n_p, k))
    F = rng.normal(size=(n_p, n, 2 * m))
    M[2, :, 2], phiinv[2, 2], pad[2, 2] = 0.0, 0.0, 1.0
    M[2, -2:], F[2, -2:], r[2, -2:], w[2, -2:] = 0.0, 0.0, 0.0, 0.0
    dirs = rng.normal(size=(n_p, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    Lhd = hd_cholesky(dirs)
    freqs = np.arange(1, m + 1) * 1.0e-8
    Tspan = 1.0e8
    t = [torch.as_tensor(a, dtype=torch.float64)
         for a in (M, r, w, phiinv, pad, F)]
    lnl, y, X = _pulsar_blocks(*t)
    L = torch.as_tensor(Lhd, dtype=torch.float64)
    R = n_p * 2 * m
    G = torch.einsum("ca,cb,cij->aibj", L, L, X).reshape(R, R)
    u = torch.einsum("ca,ci->ai", L, y).reshape(R)
    for log10_A, gamma in ((-7.0, 3.0), (-6.5, 4.1), (-np.inf, 4.33)):
        want = float(_joint_kernel(
            10.0 ** log10_A, gamma, *(jnp.asarray(a) for a in
                                      (M, r, w, phiinv, pad, F, Lhd,
                                       freqs)), Tspan,
            float(np.log(2 * np.pi))))
        cross = hd_cross_lnlike(
            G, u, torch.tensor([log10_A], dtype=torch.float64),
            torch.tensor([gamma], dtype=torch.float64),
            torch.as_tensor(freqs, dtype=torch.float64), Tspan)
        got = float(torch.sum(lnl) + cross[0])
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want)), \
            (log10_A, got, want)
        if log10_A == -np.inf:
            assert float(cross[0]) == 0.0


def test_k10_plain_version_against_a_dense_factorization():
    """K10's plain version against a dense ``torch.linalg`` evaluation of
    0.5 v^T M^-1 v - 0.5 log det M at random points, within 1e-12 of the
    sum of the magnitudes it adds; the refusals of bad shapes."""
    from pint_torch.kernels.hd_cross_lnlike import (_sqrt_phi,
                                                    hd_cross_lnlike)

    rng = np.random.default_rng(11)
    m, n_p = 3, 5
    R = n_p * 2 * m
    A = rng.normal(size=(R + 4, R))
    G = torch.as_tensor(A.T @ A * 1e14, dtype=torch.float64)
    u = torch.as_tensor(rng.normal(size=R) * 1e7, dtype=torch.float64)
    la = torch.tensor([-15.0, -14.0, -13.2, -np.inf], dtype=torch.float64)
    ga = torch.tensor([4.33, 3.0, 5.5, 4.33], dtype=torch.float64)
    freqs = torch.arange(1, m + 1, dtype=torch.float64) / 3e8
    got = hd_cross_lnlike(G, u, la, ga, freqs, 3e8)
    d = _sqrt_phi(la, ga, freqs, 3e8).repeat_interleave(2, dim=1).repeat(
        1, n_p)
    Mm = d[:, :, None] * G * d[:, None, :] + torch.eye(R, dtype=torch.float64)
    Lc = torch.linalg.cholesky(Mm)
    z = torch.linalg.solve_triangular(Lc, (d * u)[..., None],
                                      upper=False)[..., 0]
    logd = torch.log(torch.diagonal(Lc, dim1=-2, dim2=-1))
    want = 0.5 * (z * z).sum(-1) - logd.sum(-1)
    scale = torch.clamp(logd.abs().sum(-1) + 0.5 * (z * z).sum(-1), min=1.0)
    assert float(((got - want).abs() / scale).max()) <= 1e-12
    assert float(got[-1]) == 0.0
    for bad in ((G[:-1], u), (G, u[:-1])):
        with pytest.raises(ValueError):
            hd_cross_lnlike(*bad, la, ga, freqs, 3e8)
    with pytest.raises(ValueError):
        hd_cross_lnlike(G, u, la, ga, freqs[:2], 3e8)
    with pytest.raises(ValueError):
        hd_cross_lnlike(G, u, la, ga, freqs, 0.0)


def _k10_blocked(G, u, la, ga, freqs, Tspan, nb, chunk, tile=5):
    """K10's schedule on the card in plain torch: the walkers in chunks of
    ``chunk``; M and v formed; per panel of ``nb`` columns its diagonal
    block factored right-looking (pivot, division, the later columns
    updated one product at a time), the rows below it, the augmented row
    among them, solved against it column by column, then the trailing
    lower triangle in ``tile`` x ``tile`` tiles, each tile's entries
    updated by the panel's columns one rounded product at a time in
    ascending k; the sums in column order."""
    from pint_torch.kernels.hd_cross_lnlike import _sqrt_phi

    R, m = G.shape[0], freqs.shape[0]
    eye = torch.eye(R, dtype=torch.float64)
    outs = []
    for b0 in range(0, la.shape[0], chunk):
        l_, g_ = la[b0:b0 + chunk], ga[b0:b0 + chunk]
        n = l_.shape[0]
        d = _sqrt_phi(l_, g_, freqs, Tspan).repeat_interleave(
            2, dim=1).repeat(1, R // (2 * m))
        W = torch.zeros((n, R + 1, R), dtype=torch.float64)
        W[:, :R] = (d[:, :, None] * G) * d[:, None, :] + eye
        W[:, R] = d * u
        piv = torch.zeros((n, R), dtype=torch.float64)
        for k0 in range(0, R, nb):
            k1 = min(R, k0 + nb)
            for j in range(k0, k1):  # the diagonal block, right-looking
                piv[:, j] = torch.sqrt(W[:, j, j])
                W[:, j + 1:k1, j] = W[:, j + 1:k1, j] / piv[:, j, None]
                for c in range(j + 1, k1):
                    W[:, c:k1, c] = W[:, c:k1, c] \
                        - W[:, c:k1, j] * W[:, c, j, None]
            for j in range(k0, k1):  # the rows below it, solved
                W[:, k1:, j] = W[:, k1:, j] / piv[:, j, None]
                for c in range(j + 1, k1):
                    W[:, k1:, c] = W[:, k1:, c] - W[:, k1:, j] * W[:, c, j, None]
            for i0 in range(k1, R + 1, tile):
                for c0 in range(k1, min(i0 + tile, R), tile):
                    c1 = min(c0 + tile, R)
                    blk = W[:, i0:i0 + tile, c0:c1]
                    for k in range(k0, k1):
                        blk -= W[:, i0:i0 + tile, k, None] \
                            * W[:, None, c0:c1, k]
        acc_log = torch.zeros(n, dtype=torch.float64)
        acc_zz = torch.zeros(n, dtype=torch.float64)
        for j in range(R):
            acc_log = acc_log + torch.log(piv[:, j])
            z = W[:, R, j]
            acc_zz = acc_zz + z * z
        outs.append(0.5 * acc_zz - acc_log)
    return torch.cat(outs)


@pytest.mark.parametrize("nb", [2, 3, 8])
def test_k10_tile_schedule_is_bitwise_the_plain_version(joint, nb):
    """K10's blocked schedule (panels of nb columns, each a factored
    diagonal block and a solve of the rows below, tiles updated one
    product at a time in ascending k, the augmented row along, walkers
    chunked and not) is ``torch.equal`` to ``hd_cross_lnlike_reference``
    on small_catalog's G and u (R = 96) and on a random SPD G at R = 26
    (13 pulsars x 2 modes: no multiple of 3 or 8; R is always even), with
    a zero-amplitude point among the walkers."""
    from pint_torch.kernels.hd_cross_lnlike import hd_cross_lnlike_reference

    jl = joint[0]
    rng = np.random.default_rng(nb)
    A = rng.normal(size=(30, 26))
    cases = [(jl.G, jl.u, jl._freqs_t, jl.Tspan),
             (torch.as_tensor(A.T @ A * 1e14), torch.as_tensor(
                 rng.normal(size=26) * 1e7), torch.tensor([1.0 / 3e8]),
              3e8)]
    la = torch.tensor([-14.5, -13.9, -np.inf, -15.2, -14.1],
                      dtype=torch.float64)
    ga = torch.tensor([4.33, 3.1, 4.33, 5.0, 2.5], dtype=torch.float64)
    for G, u, f, T in cases:
        want = hd_cross_lnlike_reference(G, u, la, ga, f, T)
        assert float(want[2]) == 0.0
        for chunk in (5, 2):
            assert torch.equal(_k10_blocked(G, u, la, ga, f, T, nb, chunk),
                               want), (G.shape, chunk)


def test_k10_workspace_cap_and_chunks():
    """The walkers a launch takes keep the workspace (factor and pivots)
    within ``WORKSPACE_CAP_BYTES`` and split as evenly as may be; a single
    walker over the cap is refused."""
    from pint_torch.kernels.hd_cross_lnlike import (WORKSPACE_CAP_BYTES,
                                                    walkers_per_chunk)

    for B, R in ((32, 1876), (48, 1876), (1, 1876), (7, 96), (500, 96)):
        n = walkers_per_chunk(B, R)
        assert 1 <= n <= B
        assert n * 8 * (R * (R + 1) + R) <= WORKSPACE_CAP_BYTES
        chunks = -(-B // n)
        assert chunks == -(-B // (WORKSPACE_CAP_BYTES
                                  // (8 * (R * (R + 1) + R))))
    assert walkers_per_chunk(32, 1876) == 32
    assert walkers_per_chunk(48, 1876) == 24
    with pytest.raises(ValueError):
        walkers_per_chunk(1, 12000)


def test_k10_plain_version_differentiates_and_the_card_refuses():
    """The gradient to log10_A and gamma is K12's (its plain version on CPU
    tensors, bitwise), finite and nonzero, within 1e-12 of autograd through
    K10's plain version; a gradient to the data (G, u, freqs) is refused on
    either device instead of coming back empty."""
    from pint_torch.kernels import hd_cross_lnlike as K10

    rng = np.random.default_rng(3)
    A = rng.normal(size=(16, 12))
    G = torch.as_tensor(A.T @ A * 1e14)
    u = torch.as_tensor(rng.normal(size=12) * 1e7)
    f = torch.tensor([1.0 / 3e8, 2.0 / 3e8], dtype=torch.float64)
    la = torch.tensor([-14.0, -13.5], dtype=torch.float64,
                      requires_grad=True)
    ga = torch.tensor([4.33, 3.0], dtype=torch.float64, requires_grad=True)
    K10.hd_cross_lnlike(G, u, la, ga, f, 3e8).sum().backward()
    assert bool(torch.isfinite(la.grad).all()) and bool((la.grad != 0).all())
    assert bool(torch.isfinite(ga.grad).all())
    D = K10.hd_cross_grad_reference(G, u, la.detach(), ga.detach(), f, 3e8)
    assert torch.equal(la.grad, D[:, 0]) and torch.equal(ga.grad, D[:, 1])
    want = torch.autograd.grad(K10.hd_cross_lnlike_reference(
        G, u, la, ga, f, 3e8).sum(), [la, ga])
    for g, w in zip((la.grad, ga.grad), want):
        assert bool(((g - w).abs() <= 1e-12 * w.abs()).all())
    with pytest.raises(ValueError, match="data"):
        K10.hd_cross_lnlike(G.clone().requires_grad_(True), u, la, ga, f,
                            3e8)


def test_chain_on_lnlike_batch_is_the_reference_chain(both, joint):
    """An 8-walker x 3-step ``EnsembleSampler(seed=42)`` on the port's
    ``lnlike_batch`` (on the reference's residuals) from the reference's
    start: every decision the reference's, the walkers bitwise, lnprob at
    the joint bar."""
    from pint_torch.sampler import EnsembleSampler

    ref, ch = both["ref"], both["meta"]
    _, same = joint
    s = EnsembleSampler(S["walkers"], seed=S["seeds"]["sampler"])
    s.initialize_batched(same.lnlike_batch, 2)
    s.run_mcmc(ref[P + "chain/pos"].copy(), S["chain_steps"])
    chain = s.get_chain()
    assert np.array_equal(chain,
                          ref[P + "chain/walker_chain"].transpose(2, 0, 1))
    want = ref[P + "chain/lnprob"]
    assert np.max(np.abs(s.get_log_prob() - want)
                  / np.maximum(1, np.abs(want))) <= 1e-9
    assert s.naccepted == ch["chain"]["naccepted"]
    assert np.all(np.isfinite(s.get_log_prob()))


# ---------------------------------------------------------------------------
# refusals and the snapshot
# ---------------------------------------------------------------------------
def test_refusals(both):
    from pint_torch.catalog import CatalogFitter, JointLikelihood
    from pint_torch.fitter import UsageError
    from pint_torch.serving import SegmentSpec

    rep, cf = both["report"], both["cf"]
    with pytest.raises(NotImplementedError, match="item 9"):
        CatalogFitter(rep, plan="auto")
    with pytest.raises(NotImplementedError, match="item 8"):
        CatalogFitter(rep, pool=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        cf.warm(pool=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        JointLikelihood(cf, n_modes=3, plan=object())
    with pytest.raises(UsageError, match="compute_dtype"):
        SegmentSpec("catalog.lnlike", "float16")
    with pytest.raises(UsageError):
        JointLikelihood(cf, n_modes=3, precision="float32")
    with pytest.raises(UsageError):
        JointLikelihood(rep.pulsars[:1])
    with pytest.raises(UsageError):
        JointLikelihood(cf, n_modes=0)
    with pytest.raises(UsageError):
        JointLikelihood(cf, n_modes=3, requests=[])
    jl = JointLikelihood(cf, n_modes=3,
                         precision=SegmentSpec(segment="catalog.lnlike"))
    with pytest.raises(UsageError):
        jl.lnlike_batch(np.zeros((3, 4)))
    with pytest.raises(UsageError):
        CatalogFitter([])


def test_warm_runs_every_bucket(both):
    names = both["cf"].warm()
    assert len(names) == both["cf"].bucket_plan.n_buckets
    assert all(n.startswith("catalog.fit[") for n in names)


def test_committed_catalog_snapshots_load():
    """Both committed catalogues load as (model, batch) pairs with their
    corrupt rows, and the stated sizes: 67 and 16 members, 14 and 3
    modes."""
    from pint_torch.bridge import (CATALOG_PATH, CATALOG_SMALL_PATH,
                                   load_catalog_snapshot, read_snapshot)

    for path, n, modes in ((CATALOG_PATH, 67, 14),
                           (CATALOG_SMALL_PATH, 16, 3)):
        meta, arrays = read_snapshot(path)
        assert meta["catalog"]["members"] == n
        assert meta["reference"]["settings"]["n_modes"] == modes
        pairs = load_catalog_snapshot(path, device="cpu")
        assert len(pairs) == n
        zero = sum(int((b.error_us == 0).sum()) for _, b in pairs)
        assert zero == 2
        assert arrays[P + "likelihood/points"].shape == (48, 2)
