"""The port's precision layer (``pint_torch/precision``) and its hand kernel
K11 (``pint_torch/kernels/compensated_matmul.py``, through its plain twin)
against the JAX package's ``pint_tpu/precision`` on the CPU.

* fault C8: ``SegmentSpec`` and ``build_grid_gls_chi2_fn``'s signature are
  the reference's;
* the registry, policies and decision validation equal the reference's;
* ``downcast`` to float32 and bfloat16 bitwise the reference's on values
  at and beside bfloat16 ties (XLA's CPU code flushes bfloat16 subnormals,
  so those are held against the reference's numpy path, which keeps them);
  ``_split_slices`` equal for k = 1..300, split = 1..16; ``two_sum_accumulate``
  bitwise on the same partials;
* ``matmul`` against the reference's, on its traced and its numpy path:
  ``f64``/``two_sum``/``two_prod`` within ``4 k_blk 2^-53 (|a|@|b|)``,
  ``native`` float32 within ``2 k 2^-24 (|a|@|b|)`` and bfloat16 within
  that plus one bfloat16 ulp of the result; a zero column exactly 0; NaN
  and Inf where the reference's fall; a 1-D rhs, broadcast batches, k = 1,
  k < split and k off the tile;
* every consumer with no policy and under ``PrecisionPolicy.f64()``
  bitwise, and K11 never called;
* under forced specs each consumer against the reference's forced output
  on the same inputs: the GLS fit (chi2 1e-6 rel, values 1e-2 sigma), the
  grid (chi2 1e-6 rel, argmin and rungs), the serve and catalogue kernels
  (chi2 1e-9 rel, steps 1e-6 of their errors) and the joint likelihood
  (1e-9 x max(1, |ref|)) for float32 at ``f64``, ``two_sum`` and
  ``two_prod``; float32 ``native`` and bfloat16 ``two_prod`` within the
  segment's forced budget of the reference's, scaled as the reference's
  tests scale it; each consumer within its forced budget of its own
  float64 output; a fused sweep bitwise its unfused surface;
* the probes' ``rel_err`` within 1e-3 rel (or 1e-14 abs) of the
  reference's for the float64-accumulated modes, their decisions the
  reference's outside 2x of the deciding threshold; a forced run writes
  the manifest, a fresh fitter resolves ``source="tuned"``, a stale vkey
  or a tampered value gives float64.
"""

import copy
import dataclasses
import inspect
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

#: the forced specs of the bars: (compute dtype, accumulation)
FORCED = [("float32", "native"), ("float32", "f64"), ("float32", "two_sum"),
          ("float32", "two_prod"), ("bfloat16", "two_prod")]
#: every reduced mode of the primitive bars
MODES = [(ct, acc) for ct in ("float32", "bfloat16")
         for acc in ("native", "f64", "two_sum", "two_prod")]


def _tag(ct, acc):
    return f"{ct}-{acc}"


def _exact(ct, acc) -> bool:
    """The modes held at the standing bars (float64 accumulation of
    float32 parts)."""
    return ct == "float32" and acc != "native"


# ---------------------------------------------------------------------------
# fault C8: the signatures
# ---------------------------------------------------------------------------
def test_segment_spec_is_the_references():
    """C8: the reference's ``SegmentSpec(segment, compute_dtype,
    accumulation, budget, rel_err, source)`` with ``reduced``, ``key``,
    ``tag``, ``suffix``, ``to_value`` and its ``UsageError``s; the port's
    stub took ``(compute, accumulate)``."""
    from pint_tpu import precision as R
    from pint_tpu.exceptions import UsageError as RUsage

    from pint_torch import precision as P
    from pint_torch.exceptions import UsageError
    from pint_torch.serving import SegmentSpec as Served

    assert Served is P.SegmentSpec

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(P.SegmentSpec) == fields(R.SegmentSpec)
    assert P.SegmentSpec.__dataclass_params__.frozen
    for ct in ("float64", "float32", "bfloat16"):
        for acc in ("native", "f64", "two_sum", "two_prod"):
            kw = dict(segment="serve.gram", compute_dtype=ct,
                      accumulation=acc, budget=1e-3, rel_err=2e-7,
                      source="forced")
            p, r = P.SegmentSpec(**kw), R.SegmentSpec(**kw)
            assert (p.reduced, p.key(), p.tag(), p.suffix(), p.to_value()) \
                == (r.reduced, r.key(), r.tag(), r.suffix(), r.to_value())
            assert hash(p) == hash(P.SegmentSpec(**kw))
    p, r = P.SegmentSpec("float32", "float64"), R.SegmentSpec("float32",
                                                              "float64")
    assert (p.segment, p.compute_dtype, p.reduced) \
        == (r.segment, r.compute_dtype, r.reduced) == ("float32", "float64",
                                                       False)
    for kw in (dict(compute_dtype="float16"), dict(accumulation="kahan")):
        with pytest.raises(UsageError) as pe:
            P.SegmentSpec(segment="gls.design", **kw)
        with pytest.raises(RUsage) as re_:
            R.SegmentSpec(segment="gls.design", **kw)
        assert str(pe.value) == str(re_.value)


def test_grid_builder_signature_is_the_references():
    """C8: ``build_grid_gls_chi2_fn`` takes the reference's
    ``correction_dtype=None, precision=None`` in its order (the port's took
    neither: a call passing them raised ``TypeError``)."""
    import pint_tpu.grid as rgrid

    import pint_torch.grid as pgrid

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(pgrid.build_grid_gls_chi2_fn) \
        == params(rgrid.build_grid_gls_chi2_fn)


# ---------------------------------------------------------------------------
# the registry, policies and decisions
# ---------------------------------------------------------------------------
def test_registry_and_policies_are_the_references():
    from pint_tpu import precision as R

    from pint_torch import precision as P

    assert P.COMPUTE_DTYPES == R.COMPUTE_DTYPES
    assert P.ACCUMULATIONS == R.ACCUMULATIONS
    assert P.DEFAULT_SPLIT == R.DEFAULT_SPLIT
    assert sorted(P.__all__) == sorted(R.__all__)
    assert {k: dataclasses.astuple(v) for k, v in P.SEGMENTS.items()} \
        == {k: dataclasses.astuple(v) for k, v in R.SEGMENTS.items()}
    for ct in ("float64", "float32", "bfloat16"):
        for acc in ("f64", "two_prod"):
            pp, rp = (M.PrecisionPolicy.forced(ct, accumulation=acc)
                      for M in (P, R))
            assert {k: v.to_value() | {"source": v.source}
                    for k, v in pp.specs.items()} \
                == {k: v.to_value() | {"source": v.source}
                    for k, v in rp.specs.items()}
    for M in (P, R):
        assert not M.PrecisionPolicy.f64().spec_for("grid.gram").reduced
        with M.use_policy(M.PrecisionPolicy.forced("float32")):
            assert M.segment_spec("serve.gram").reduced
            assert M.override_spec("catalog.fit").source == "forced"
        assert M.active_policy() is None
    assert P.describe_segments() == R.describe_segments()
    good = {"compute_dtype": "float32", "accumulation": "two_prod",
            "budget": 1e-3, "rel_err": 2e-8}
    for value in (good, dict(good, compute_dtype="float8"),
                  dict(good, accumulation="dd"), dict(good, budget=-1.0),
                  dict(good, budget=True), dict(good, rel_err="x"),
                  dict(good, rel_err=None), {"compute_dtype": "bfloat16"},
                  [1, 2], None):
        p = P.spec_from_decision("serve.gram", value)
        r = R.spec_from_decision("serve.gram", value)
        assert (p is None) == (r is None)
        if p is not None:
            assert dataclasses.astuple(p) == dataclasses.astuple(r)
    for M in (P, R):
        assert M.precision_vkey("serve.gram") == ("precision", "serve.gram",
                                                  1)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def _tie_values():
    """float64 values at, just above and just below bfloat16 ties and float32
    ties (where rounding through float32 and directly differ), around
    powers of two, large and small."""
    out = []
    for e in (-30, -3, 0, 7, 60, 126):
        base = 2.0 ** e
        for m in range(1, 6):
            tie = base * (1.0 + (2 * m - 1) * 2.0 ** -8)
            t32 = base * (1.0 + (2 * m - 1) * 2.0 ** -24)
            for t in (tie, t32):
                for d in (0.0, 2.0 ** -40, -(2.0 ** -40), 2.0 ** -30):
                    out += [t * (1.0 + d), -t * (1.0 + d)]
    rng = np.random.default_rng(20261018)
    out += list(rng.standard_normal(200) * 10.0 ** rng.integers(-20, 20, 200))
    out += [3.3961e38, 3.4e38, 0.0, -0.0, np.inf, -np.inf, np.nan]
    return np.asarray(out, dtype=np.float64)


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
@pytest.mark.parametrize("ct", ["float32", "bfloat16"])
def test_downcast_bitwise(ct, kind):
    import jax.numpy as jnp
    from pint_tpu.precision import downcast as ref

    from pint_torch.precision import downcast, promote_f64

    x = _tie_values()
    if kind == "tensor":
        got = downcast(torch.from_numpy(x), ct)
        assert got.dtype == getattr(torch, ct)
        got = promote_f64(got).numpy()
        want = np.asarray(ref(jnp.asarray(x), ct).astype(jnp.float64))
    else:
        got = promote_f64(downcast(x, ct))
        assert got.dtype == np.float64
        want = ref(x, ct).astype(np.float64)
    assert np.array_equal(got, want, equal_nan=True)
    num = ~np.isnan(want)
    assert np.array_equal(np.signbit(got[num]), np.signbit(want[num]))
    if ct == "bfloat16":
        # bfloat16 subnormals: XLA's CPU code flushes them, the reference's
        # numpy path (ml_dtypes) and the port keep them
        sub = np.array([1e-39, -3e-40, 9.2e-41 * (1 + 2.0 ** -30)])
        want = ref(sub, ct).astype(np.float64)
        for x_in in (sub, torch.from_numpy(sub)):
            got = promote_f64(downcast(x_in, ct))
            got = got if isinstance(got, np.ndarray) else got.numpy()
            assert np.array_equal(got, want)
    assert downcast(x, "float64") is x


@pytest.mark.parametrize("split", range(1, 17))
def test_split_slices_are_the_references(split):
    from pint_tpu.precision.compensated import _split_slices as ref

    from pint_torch.precision.compensated import _split_slices

    for k in range(1, 301):
        assert _split_slices(k, split) == ref(k, split), (k, split)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_two_sum_accumulate_bitwise(kind):
    import jax.numpy as jnp
    from pint_tpu.precision import two_sum_accumulate as ref

    from pint_torch.precision import two_sum_accumulate

    rng = np.random.default_rng(3)
    parts = [rng.standard_normal((5, 7)) * 10.0 ** e for e in (0, 16, -16, 8)]
    parts.append(-parts[1])
    want_np = ref(parts)
    want_j = np.asarray(ref([jnp.asarray(p) for p in parts]))
    assert np.array_equal(want_np, want_j)
    if kind == "numpy":
        got = two_sum_accumulate(parts)
    else:
        got = two_sum_accumulate([torch.from_numpy(p) for p in parts]).numpy()
    assert np.array_equal(got, want_np)
    # error-free where plain summation loses the small terms
    assert not np.array_equal(got, sum(parts))
    assert np.array_equal(two_sum_accumulate(parts[:1]), parts[0])


#: (a shape, b shape): plain, 1-D rhs, a batch against a shared b, batches
#: on both sides broadcast, k = 1, k < split, k off the 16-deep tile
SHAPES = [((7, 37), (37, 5)), ((6, 29), (29,)), ((3, 9, 40), (40, 4)),
          ((2, 1, 5, 19), (3, 19, 6)), ((4, 1), (1, 3)), ((5, 5), (5, 2)),
          ((33, 50), (50, 17)), ((29,), (29, 4))]


def _operands(sa, sb, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(sa) * np.exp(rng.uniform(-3, 3, sa))
    b = rng.standard_normal(sb) * np.exp(rng.uniform(-3, 3, sb))
    return a, b


def _bound(a, b, ct, acc, split=8):
    """The elementwise bar against the reference's result (module
    docstring)."""
    k = a.shape[-1]
    scale = np.abs(a) @ np.abs(b)
    if acc == "native":
        return 2.0 * k * 2.0 ** -24 * scale
    if acc == "two_sum":
        from pint_torch.kernels.compensated_matmul import split_bounds

        bd = split_bounds(k, split)
        k = max(hi - lo for lo, hi in zip(bd[:-1], bd[1:]))
    return 4.0 * k * 2.0 ** -53 * scale


def _bf16_ulp(x):
    """One bfloat16 ulp of each element of ``x``."""
    ax = np.abs(x)
    e = np.floor(np.log2(np.where(ax > 0, ax, 1.0)))
    return np.where(ax > 0, 2.0 ** (e - 7), 2.0 ** -133)


def _within(got, want, a, b, ct, acc):
    bar = _bound(a, b, ct, acc)
    if ct == "bfloat16" and acc == "native":
        bar = bar + _bf16_ulp(want)
    return np.all(np.abs(got - want) <= bar)


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES, ids=lambda m: _tag(*m))
def test_matmul_matches_the_references(mode, shapes):
    import jax.numpy as jnp
    from pint_tpu import precision as R

    from pint_torch import precision as P

    ct, acc = mode
    a, b = _operands(*shapes, seed=len(shapes[0]) * 7 + shapes[0][-1])
    rs = R.SegmentSpec(segment="serve.gram", compute_dtype=ct,
                       accumulation=acc)
    ps = P.SegmentSpec(segment="serve.gram", compute_dtype=ct,
                       accumulation=acc)
    want = np.asarray(R.matmul(jnp.asarray(a), jnp.asarray(b), rs))
    got = P.matmul(torch.from_numpy(a), torch.from_numpy(b), ps).numpy()
    assert got.shape == want.shape == np.matmul(a, b).shape
    assert _within(got, want, a, b, ct, acc)
    # the reference's numpy path too, and the port's numpy operands
    want_np = R.matmul(a, b, rs)
    got_np = P.matmul(a, b, ps)
    assert isinstance(got_np, np.ndarray)
    assert np.array_equal(got_np, got)
    assert _within(got_np, np.asarray(want_np, dtype=np.float64), a, b, ct,
                   acc)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: _tag(*m))
def test_zero_columns_and_nonfinite_fall_where_the_references(mode):
    import jax.numpy as jnp
    from pint_tpu import precision as R

    from pint_torch import precision as P

    ct, acc = mode
    a, b = _operands((9, 21), (21, 6), seed=5)
    b[:, 2] = 0.0
    a[3, 4] = np.nan
    a[5, 7] = np.inf
    b[10, 4] = -np.inf
    rs = R.SegmentSpec(segment="grid.gram", compute_dtype=ct,
                       accumulation=acc)
    ps = P.SegmentSpec(segment="grid.gram", compute_dtype=ct,
                       accumulation=acc)
    want = np.asarray(R.matmul(jnp.asarray(a), jnp.asarray(b), rs))
    got = P.matmul(torch.from_numpy(a), torch.from_numpy(b), ps).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    col = got[[0, 1, 2, 4, 6, 7, 8], 2]
    assert np.all(col == 0.0)


def test_default_spec_is_plain_matmul(monkeypatch):
    """``spec=None`` and a float64 spec are ``a @ b``, bit for bit, with no
    K11 call."""
    from pint_torch import precision as P
    from pint_torch.precision import compensated

    def boom(*a, **k):
        raise AssertionError("K11 called on the float64 path")

    monkeypatch.setattr(compensated, "compensated_matmul", boom)
    a, b = _operands((4, 30, 20), (20, 6), seed=9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for spec in (None, P.SegmentSpec(segment="gls.design"),
                 P.PrecisionPolicy.f64().spec_for("grid.gram")):
        assert torch.equal(P.matmul(ta, tb, spec), ta @ tb)
        assert np.array_equal(P.matmul(a, b, spec), a @ b)


# ---------------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    """The small GLS stand-in in both packages, unfitted (reference model,
    TOAs, port model, batch)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return standin.port_and_reference(standin.SMALL_SETTINGS)


def _fit_both(small, rpol, ppol, maxiter=2):
    from pint_tpu.gls_fitter import GLSFitter as RG
    from pint_tpu.precision import use_policy as ruse

    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.precision import use_policy

    model, toas, m, b = small
    rf = RG(toas, copy.deepcopy(model))
    with ruse(rpol), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rf.fit_toas(maxiter=maxiter)
    pf = GLSFitter(b, m.copy())
    with use_policy(ppol):
        pf.fit_toas(maxiter=maxiter)
    return rf, pf


def _policies(ct, acc):
    from pint_tpu import precision as R

    from pint_torch import precision as P

    return (R.PrecisionPolicy.forced(ct, accumulation=acc),
            P.PrecisionPolicy.forced(ct, accumulation=acc))


@pytest.fixture(scope="module")
def fits64(small):
    """Both packages' float64 GLS fits of the small stand-in, each its
    own."""
    return _fit_both(small, None, None)


@pytest.fixture(scope="module")
def fitted(small):
    """Both packages' float64 GLS fits of the small stand-in, the port's
    model then set to the reference's fitted values and its residuals
    refreshed."""
    rf, pf = _fit_both(small, None, None)
    m = pf.model
    for p in rf.model.free_params:
        m[p].value = float(getattr(rf.model, p).value)
        m[p].uncertainty = float(getattr(rf.model, p).uncertainty)
    pf.update_resids()
    return rf, pf


class _K11Spy:
    """Counts calls of K11's wrapper through the precision layer."""

    def __init__(self, monkeypatch):
        from pint_torch.precision import compensated

        self.calls = 0
        orig = compensated.compensated_matmul

        def spied(*a, **k):
            self.calls += 1
            return orig(*a, **k)

        monkeypatch.setattr(compensated, "compensated_matmul", spied)


def _consumer_outputs(which, small, fitted, cat):
    """One consumer's outputs under whatever policy is active: the GLS fit,
    the grid, the serve kernel, the catalogue's fit and joint likelihood."""
    from pint_torch.catalog import CatalogFitter, JointLikelihood
    from pint_torch.gls_fitter import GLSFitter
    from pint_torch.grid import build_grid_gls_chi2_fn
    from pint_torch.serving import FitRequest, pad_request, serve_batched

    model, toas, m, b = small
    if which == "gls.design":
        f = GLSFitter(b, m.copy())
        f.fit_toas(maxiter=2)
        return [f.resids.time_resids.numpy(),
                np.array([f.model.value(p) for p in f.model.free_params])]
    rf, pf = fitted
    if which == "grid":
        fn, _, _ = build_grid_gls_chi2_fn(pf.model, b, ("M2", "SINI"),
                                          niter=1, chunk=4)
        return list(fn(_grid_points(rf.model)))
    if which == "serve.gram":
        q = FitRequest.from_fitter(pf)
        ops = [x[None] for x in pad_request(q, 96, 48)]
        return [o.numpy() for o in serve_batched()(*ops)]
    pairs = cat["port_pairs"]
    if which == "catalog.fit":
        from pint_torch.catalog import ingest_catalog

        res = CatalogFitter(ingest_catalog(pairs)).fit(maxiter=1)
        return [np.array([f.chi2 for f in res.fits])]
    jl = JointLikelihood(cat["port_report"], n_modes=2)
    return [jl.lnlike_batch(np.array([[-14.0, 13.0 / 3.0], [-13.5, 4.0]]))]


def _grid_points(model, n=3):
    g1, g2 = standin.grid_axes(model, n)
    return np.stack([g.ravel() for g in np.meshgrid(g1, g2, indexing="ij")],
                    axis=-1)


@pytest.fixture(scope="module")
def cat():
    """A 4-pulsar synthetic catalogue (the reference's precision test's
    shape) in both packages: the reference's pairs and ingest report, the
    port's pairs loaded from their exported state, ingested."""
    from pint_tpu.catalog import ingest_catalog as ringest

    from pint_torch.bridge import load_catalog_snapshot
    from pint_torch.catalog import ingest_catalog

    s = dict(catalog=dict(n_pulsars=4, seed=42, ntoa_range=[24, 40],
                          bad_rows_in=[3, 11]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pairs = standin.catalog_pairs(s)
        arrays = {}
        for i, (model, toas) in enumerate(pairs):
            st = standin.export_state(model, toas)
            st.update(standin._integrity_arrays(toas))
            arrays.update({f"psr/{i}/{k}": v for k, v in st.items()})
        arrays["meta"] = np.asarray(json.dumps(
            {"format": "pint_torch-snapshot-1", "name": "catalog",
             "catalog": {"members": len(pairs)}}))
        port_pairs = load_catalog_snapshot(arrays, device="cpu")
        rreport = ringest(copy.deepcopy(pairs))
    return dict(pairs=pairs, port_pairs=port_pairs,
                port_report=ingest_catalog(port_pairs), report=rreport)


@pytest.mark.parametrize("which", ["gls.design", "grid", "serve.gram",
                                   "catalog.fit", "catalog.lnlike"])
def test_default_and_f64_policy_are_bitwise(which, small, fitted, cat,
                                            monkeypatch):
    """No policy and ``PrecisionPolicy.f64()`` give the same bits, and K11
    is never called (the float64 products are the plain ones)."""
    from pint_torch.precision import PrecisionPolicy, use_policy

    spy = _K11Spy(monkeypatch)
    plain = _consumer_outputs(which, small, fitted, cat)
    with use_policy(PrecisionPolicy.f64()):
        f64 = _consumer_outputs(which, small, fitted, cat)
    assert spy.calls == 0
    assert all(np.array_equal(x, y, equal_nan=True)
               for x, y in zip(plain, f64))
    forced = PrecisionPolicy.forced("float32", accumulation="two_prod")
    with use_policy(forced):
        _consumer_outputs(which, small, fitted, cat)
    assert spy.calls > 0


@pytest.mark.parametrize("mode", FORCED, ids=lambda m: _tag(*m))
def test_forced_gls_fit_matches_the_reference(mode, small, fits64):
    """``gls.design``: the fit under the forced policy against the
    reference's (chi2 1e-6 rel, values within 1e-2 of their uncertainty,
    and within the budget of its own float64 fit as the reference's test
    holds it; float32 ``native`` and bfloat16 within the budget of the
    reference's forced fit, scaled so)."""
    from pint_torch.precision import SEGMENTS

    budget = SEGMENTS["gls.design"].forced_budget
    rpol, ppol = _policies(*mode)
    rf, pf = _fit_both(small, rpol, ppol)
    _, p64 = fits64
    chi2_r, chi2_p = float(rf.resids.calc_chi2()), float(pf.resids.calc_chi2())
    if _exact(*mode):
        chi2_64 = float(p64.resids.calc_chi2())
        assert abs(chi2_p - chi2_64) / abs(chi2_64) <= budget
        for p in pf.model.free_params:
            v, v64 = pf.model.value(p), p64.model.value(p)
            u = float(p64.model[p].uncertainty or 0.0)
            assert abs(v - v64) <= budget * max(abs(v64), u, 1e-300), p
        assert abs(chi2_p / chi2_r - 1) <= 1e-6
        for p in pf.model.free_params:
            rp = getattr(rf.model, p)
            assert abs(pf.model.value(p) - float(rp.value)) \
                <= 1e-2 * float(rp.uncertainty), p
    else:
        assert abs(chi2_p - chi2_r) / abs(chi2_r) <= budget
        for p in pf.model.free_params:
            rp = getattr(rf.model, p)
            v = float(rp.value)
            u = float(rp.uncertainty or 0.0)
            assert abs(pf.model.value(p) - v) <= budget * max(abs(v), u,
                                                              1e-300), p


@pytest.mark.parametrize("mode", [("float32", "two_prod"),
                                  ("float32", "native"),
                                  ("bfloat16", "two_prod")],
                         ids=lambda m: _tag(*m))
def test_forced_grid_matches_the_reference(mode, fitted):
    """``grid.gram`` and ``grid.correction`` under the forced policy: the
    3 x 3 M2 x SINI surface against the reference's (1e-6 rel, argmin and
    rungs; or the forced budget) and within the budget of its own float64
    surface."""
    import jax.numpy as jnp
    from pint_tpu.grid import build_grid_gls_chi2_fn as rbuild
    from pint_tpu.precision import use_policy as ruse

    from pint_torch.grid import build_grid_gls_chi2_fn
    from pint_torch.precision import SEGMENTS, use_policy

    rf, pf = fitted
    rpol, ppol = _policies(*mode)
    pts = _grid_points(rf.model)
    with ruse(rpol):
        rfn, _, _ = rbuild(rf.model, rf.toas, ("M2", "SINI"), niter=1,
                           chunk=4)
    rc2, _, rdg = (np.asarray(x) for x in rfn(jnp.asarray(pts)))
    with use_policy(ppol):
        fn, _, _ = build_grid_gls_chi2_fn(pf.model, pf.batch, ("M2", "SINI"),
                                          niter=1, chunk=4)
    c2, vf, dg = fn(pts)
    c64, _, _ = build_grid_gls_chi2_fn(pf.model, pf.batch, ("M2", "SINI"),
                                       niter=1, chunk=4)[0](pts)
    budget = SEGMENTS["grid.gram"].forced_budget
    assert np.all(np.isfinite(c2))
    assert np.max(np.abs(c2 - c64)) / np.max(np.abs(c64)) <= budget
    if _exact(*mode):
        assert np.abs(c2 / rc2 - 1).max() <= 1e-6
        assert np.argmin(c2) == np.argmin(rc2)
        assert np.array_equal(dg[:, 0], rdg[:, 0])
    else:
        assert np.max(np.abs(c2 - rc2)) / np.max(np.abs(rc2)) <= budget
    # fn.fused on the CPU runs the same chunks: bitwise the unfused surface
    with use_policy(ppol):
        assert all(np.array_equal(x, y, equal_nan=True)
                   for x, y in zip(fn.fused(pts, fuse=2), (c2, vf, dg)))


def _same_serve(got, want, mode, budget):
    """The serve kernel's (dx, err, chi2, chi2_initial) against the
    reference's on the same operands."""
    dx, err, chi2, chi2_0 = got
    rdx, rerr, rchi2, rchi2_0 = (np.asarray(x) for x in want)
    assert np.allclose(chi2_0, rchi2_0, rtol=1e-12, atol=0)
    if _exact(*mode):
        assert np.all(np.abs(chi2 / rchi2 - 1) <= 1e-9)
        assert np.all(np.abs(err / rerr - 1) <= 1e-9)
        assert np.all(np.abs(dx - rdx) <= 1e-6 * rerr)
    else:
        assert np.all(np.abs(chi2 - rchi2) <= budget * np.abs(rchi2))
        assert np.all(np.abs(dx - rdx) <= budget * np.maximum(
            np.abs(rdx), rerr))


@pytest.mark.parametrize("mode", FORCED, ids=lambda m: _tag(*m))
def test_forced_serve_kernel_matches_the_reference(mode, fitted):
    """``serve.gram``: the batched serve call and its three fused Huber steps
    under a forced spec against the reference's on the same padded
    operands (two lanes, padded rows and columns)."""
    import jax.numpy as jnp
    from pint_tpu import precision as R
    from pint_tpu.serving.batcher import FitRequest as RReq
    from pint_tpu.serving.batcher import pad_request as rpad
    from pint_tpu.serving.batcher import serve_batched as rbatched
    from pint_tpu.serving.batcher import serve_fused as rfused

    from pint_torch import precision as P
    from pint_torch.serving import serve_batched, serve_fused

    rf, pf = fitted
    q = RReq.from_fitter(rf)
    ops = [np.stack(x) for x in zip(rpad(q, 96, 48), rpad(
        RReq(M=q.M[:60, :30], r=q.r[:60], w=q.w[:60], phiinv=q.phiinv[:30]),
        96, 48))]
    ct, acc = mode
    rs = R.SegmentSpec(segment="serve.gram", compute_dtype=ct,
                       accumulation=acc, source="forced")
    ps = P.SegmentSpec(segment="serve.gram", compute_dtype=ct,
                       accumulation=acc, source="forced")
    budget = P.SEGMENTS["serve.gram"].forced_budget
    want = rbatched(rs)(*[jnp.asarray(o) for o in ops])
    got = [o.numpy() for o in serve_batched(ps)(
        *[torch.from_numpy(o) for o in ops])]
    _same_serve(got, want, mode, budget)
    f64 = [o.numpy() for o in serve_batched()(
        *[torch.from_numpy(o) for o in ops])]
    assert np.all(np.abs(got[2] - f64[2]) <= budget * np.abs(f64[2]))
    wantf = rfused(rs, steps=3, reweight="huber")(*[jnp.asarray(o)
                                                    for o in ops])
    gotf = [o.numpy() for o in serve_fused(ps, steps=3, reweight="huber")(
        *[torch.from_numpy(o) for o in ops])]
    rdx, rerr, rchi2, _ = (np.asarray(x) for x in wantf)
    if _exact(*mode):
        assert np.all(np.abs(gotf[2] / rchi2 - 1) <= 1e-9)
        assert np.all(np.abs(gotf[0] - rdx) <= 1e-6 * rerr[:, None, :])
    else:
        assert np.all(np.abs(gotf[2] - rchi2) <= budget * np.abs(rchi2))


@pytest.mark.parametrize("mode", FORCED, ids=lambda m: _tag(*m))
def test_forced_catalog_fit_matches_the_reference(mode, cat):
    """``catalog.fit``: each bucket's batched call under a forced spec
    against the reference's on the same operands (the reference's
    ``bucket_executables``), and the port's whole fit pass within the
    budget of its own float64 pass, as the reference's test holds it."""
    from pint_tpu import precision as R
    from pint_tpu.catalog import CatalogFitter as RCF

    from pint_torch import precision as P
    from pint_torch.catalog import CatalogFitter, catalog_batched
    from pint_torch.catalog import ingest_catalog

    ct, acc = mode
    rs = R.SegmentSpec(segment="catalog.fit", compute_dtype=ct,
                       accumulation=acc, source="forced")
    ps = P.SegmentSpec(segment="catalog.fit", compute_dtype=ct,
                       accumulation=acc, source="forced")
    budget = P.SEGMENTS["catalog.fit"].forced_budget
    rcf = RCF(copy.deepcopy(cat["report"]))
    for fn, operands in rcf.bucket_executables(spec=rs).values():
        want = fn(*operands)
        got = [o.numpy() for o in catalog_batched(ps)(
            *[torch.from_numpy(np.asarray(o)) for o in operands])]
        _same_serve(got, want, mode, budget)
    res64 = CatalogFitter(ingest_catalog(cat["port_pairs"])).fit(maxiter=1)
    _, ppol = _policies(ct, acc)
    with P.use_policy(ppol):
        mix = CatalogFitter(ingest_catalog(cat["port_pairs"])).fit(maxiter=1)
    by64 = res64.by_name()
    for fit in mix.fits:
        ref = by64[fit.name]
        assert abs(fit.chi2 - ref.chi2) <= budget * max(abs(ref.chi2), 1.0)
        for par, dv in fit.dpars.items():
            scale = max(abs(ref.dpars[par]), abs(ref.errors.get(par, 0.0)),
                        1e-300)
            assert abs(dv - ref.dpars[par]) <= budget * scale, par


@pytest.mark.parametrize("mode", FORCED, ids=lambda m: _tag(*m))
def test_forced_joint_likelihood_matches_the_reference(mode, cat):
    """``catalog.lnlike``: the joint likelihood under a forced spec on the
    reference's requests against the reference's (1e-9 x max(1, |ref|); or
    the budget, x max(1, |ref|) as the reference's test scales it), within
    the budget of its own float64 value, and the amplitude -> 0
    factorization at the reduced spec."""
    from pint_tpu import precision as R
    from pint_tpu.catalog.likelihood import JointLikelihood as RJL
    from pint_tpu.serving.batcher import FitRequest as RReq

    from pint_torch import precision as P
    from pint_torch.catalog import JointLikelihood
    from pint_torch.serving import FitRequest

    ct, acc = mode
    rs = R.SegmentSpec(segment="catalog.lnlike", compute_dtype=ct,
                       accumulation=acc, source="forced")
    ps = P.SegmentSpec(segment="catalog.lnlike", compute_dtype=ct,
                       accumulation=acc, source="forced")
    budget = P.SEGMENTS["catalog.lnlike"].forced_budget
    rep = cat["report"]
    reqs = [RReq.from_fitter(p.fitter) for p in rep.pulsars]
    same = [FitRequest(M=q.M, r=q.r, w=q.w, phiinv=q.phiinv, params=q.params,
                       norm=q.norm, device="cpu") for q in reqs]
    pts = np.array([[-14.5, 13.0 / 3.0], [-13.8, 3.5], [-15.2, 5.0]])
    rjl = RJL(rep, n_modes=3, precision=rs)
    want = np.array([rjl.lnlike(*p) for p in pts])
    jl = JointLikelihood(cat["port_report"], n_modes=3, precision=ps,
                         requests=same)
    got = jl.lnlike_batch(pts)
    if _exact(*mode):
        assert np.all(np.abs(got - want) <= 1e-9 * np.maximum(1.0,
                                                              np.abs(want)))
    else:
        assert np.all(np.abs(got - want) <= budget * np.maximum(
            1.0, np.abs(want)))
    l64 = JointLikelihood(cat["port_report"], n_modes=3,
                          requests=same).lnlike_batch(pts)
    assert np.all(np.abs(got - l64) <= budget * np.maximum(1.0, np.abs(l64)))
    assert np.isclose(jl.lnlike_nocommon(),
                      float(np.sum(jl.per_pulsar_lnlike())), rtol=1e-9,
                      atol=1e-6)


# ---------------------------------------------------------------------------
# probes and the manifest
# ---------------------------------------------------------------------------
@pytest.fixture
def tune_dirs(tmp_path):
    """A tuning directory for each package, reset after the test."""
    from pint_tpu import autotune as rauto
    from pint_tpu import config as rconf

    from pint_torch import autotune
    from pint_torch import config

    config.set_tune_dir(str(tmp_path / "port"))
    rconf.set_tune_dir(str(tmp_path / "ref"))
    autotune.reset_manifest_singleton()
    rauto.reset_manifest_singleton()
    yield tmp_path
    config.set_tune_dir(None)
    rconf.set_tune_dir(None)
    autotune.reset_manifest_singleton()
    rauto.reset_manifest_singleton()


def _reference_system(rf, monkeypatch):
    """Feed the port's probes the reference's linearized system (the same
    operands): the port's ``linearized_system`` returns the reference's
    arrays as tensors."""
    from pint_tpu.gls_fitter import linearized_system as rlin

    from pint_torch import gls_fitter

    M, r, w, phiinv, params, norm = rlin(rf.model, rf.toas, resids=rf.resids)

    def same(*a, **k):
        t = [torch.from_numpy(np.array(x, dtype=np.float64))
             for x in (M, r, w, phiinv, norm)]
        return t[0], t[1], t[2], t[3], tuple(params), t[4]

    monkeypatch.setattr(gls_fitter, "linearized_system", same)


@pytest.mark.parametrize("segment", ["gls.design", "serve.gram",
                                     "catalog.fit"])
@pytest.mark.parametrize("acc", ["f64", "two_sum", "two_prod"])
def test_probe_rel_err_and_decisions_match_the_references(segment, acc,
                                                         fitted,
                                                         monkeypatch):
    """Each probe's measured float64-vs-float32 disagreement, on the
    reference's linearized system, within 1e-3 rel (or 1e-14 abs) of the
    reference's for ``f64`` and ``two_sum``; under ``two_prod`` the
    disagreement is float64's own rounding of the solve (1e-13 to 1e-11
    here, not reproducible across two summation orders), so both are held
    below 1e-10 instead.  The decision -- forced and unforced -- is the
    reference's unless the reference's ``rel_err`` is within 2x of the
    deciding threshold."""
    from pint_tpu.precision import tune as rtune

    from pint_torch.precision import SEGMENTS, tune

    rf, pf = fitted
    _reference_system(rf, monkeypatch)
    rcand = rtune.SegmentSpec(segment=segment, compute_dtype="float32",
                              accumulation=acc)
    pcand = tune.SegmentSpec(segment=segment, compute_dtype="float32",
                             accumulation=acc)
    rrel = rtune.probe_segment(segment, rf, rcand)
    prel = tune.probe_segment(segment, pf, pcand)
    assert np.isfinite(prel) == np.isfinite(rrel)
    if acc == "two_prod":
        assert max(prel, rrel) <= 1e-10, (prel, rrel)
    else:
        assert abs(prel - rrel) <= max(1e-3 * abs(rrel), 1e-14), (prel, rrel)
    d = SEGMENTS[segment]
    for force in (False, True):
        bar = d.forced_budget if force else d.safe_rel
        if bar / 2 <= rrel <= 2 * bar:
            continue
        rdec = rtune.tune_precision_segments(
            rf, segments=(segment,), accumulation=acc, force=force)
        pdec = tune.tune_precision_segments(
            pf, segments=(segment,), accumulation=acc, force=force)
        assert pdec[segment].value["compute_dtype"] \
            == rdec[segment].value["compute_dtype"]
        assert pdec[segment].basis == rdec[segment].basis
        assert pdec[segment].name == rdec[segment].name


@pytest.mark.parametrize("acc", ["f64", "two_prod"])
def test_grid_probe_decides_as_the_references(acc, fitted):
    """The ``grid.gram`` probe on each package's own grid (its operands are
    the model's own per-point design products, which differ between the
    packages in the last bits and so flip some float32 roundings): the
    same decisions, forced and unforced, and ``rel_err`` of the same size
    (within a factor 3)."""
    from pint_tpu.precision import tune as rtune

    from pint_torch.precision import tune

    rf, pf = fitted
    kw = dict(grid_params=("M2", "SINI"), points=_grid_points(rf.model))
    for force in (False, True):
        rdec = rtune.tune_precision_segments(
            rf, segments=("grid.gram",), accumulation=acc, force=force, **kw)
        pdec = tune.tune_precision_segments(
            pf, segments=("grid.gram",), accumulation=acc, force=force, **kw)
        r, p = rdec["grid.gram"], pdec["grid.gram"]
        assert p.value["compute_dtype"] == r.value["compute_dtype"]
        assert p.vkey == r.vkey or repr(p.vkey) == repr(r.vkey)
        rr, pr = r.measured["rel_err"], p.measured["rel_err"]
        assert rr / 3 <= pr <= 3 * rr or max(rr, pr) <= 1e-10, (pr, rr)


def test_forced_probe_writes_the_manifest_and_resolves(fitted, tune_dirs):
    """``force=True`` at float32 ``two_prod`` records each probeable
    segment inside its forced budget; a fresh fitter resolves the reduced
    spec with ``source="tuned"`` from the manifest alone and its fit stays
    within the budget of the float64 one."""
    from pint_torch import autotune
    from pint_torch import precision as P
    from pint_torch.gls_fitter import GLSFitter

    rf, pf = fitted
    out = P.tune_precision_segments(
        pf, force=True, grid_params=("M2", "SINI"),
        points=_grid_points(rf.model), tuning_manifest=autotune.manifest())
    assert set(out) == {"gls.design", "grid.gram", "serve.gram",
                        "catalog.fit"}
    for segment, dec in out.items():
        assert dec.value["compute_dtype"] == "float32", segment
        assert dec.value["rel_err"] <= dec.value["budget"], segment
        assert dec.basis == "forced"
    doc = json.loads((tune_dirs / "port" / "tuning.json").read_text())
    assert doc["schema"] == "pint_tpu.autotune.manifest/1"
    assert len(doc["decisions"]) == 4
    fresh = GLSFitter(pf.batch, pf.model.copy())
    sp = P.segment_spec("gls.design", model=fresh.model, toas=fresh.batch)
    assert sp.reduced and sp.source == "tuned" and sp.rel_err <= sp.budget
    assert P.segment_spec("serve.gram").reduced
    assert P.describe_segments(fresh.model, fresh.batch)["gls.design"][
        "source"] == "tuned"
    chi2_64 = float(pf.resids.calc_chi2())
    fresh.fit_toas(maxiter=1)
    assert abs(float(fresh.resids.calc_chi2()) - chi2_64) / chi2_64 \
        <= out["gls.design"].value["budget"]


def test_forced_probe_refuses_past_the_forced_budget(fitted, tune_dirs,
                                                     monkeypatch):
    from pint_torch import autotune
    from pint_torch.precision import tune

    monkeypatch.setitem(tune._PROBES, "serve.gram",
                        lambda *a, **kw: float("inf"))
    out = tune.tune_precision_segments(
        fitted[1], segments=("serve.gram",), force=True,
        tuning_manifest=autotune.manifest())
    dec = out["serve.gram"]
    assert dec.value["compute_dtype"] == "float64"
    assert "f64 retained" in dec.reason
    assert dec.measured["rel_err"] == 1e300 and dec.measured["probe_failed"]


def test_stale_vkey_and_tampered_value_degrade_to_f64(fitted, tune_dirs):
    from pint_torch import autotune
    from pint_torch import precision as P
    from pint_torch.autotune.manifest import MANIFEST_BASENAME

    pf = fitted[1]
    P.tune_precision_segments(pf, segments=("gls.design", "serve.gram"),
                              force=True,
                              tuning_manifest=autotune.manifest())
    model = pf.model.copy()
    assert P.segment_spec("gls.design", model=model, toas=pf.batch).reduced
    model["M2"].value = model.value("M2") + 1e-6
    assert not P.segment_spec("gls.design", model=model,
                              toas=pf.batch).reduced
    mpath = tune_dirs / "port" / MANIFEST_BASENAME
    doc = json.loads(mpath.read_text())
    for entry in doc["decisions"].values():
        if entry["name"] == "precision.serve.gram":
            entry["decision"]["value"]["compute_dtype"] = "float8"
    mpath.write_text(json.dumps(doc))
    autotune.reset_manifest_singleton()
    assert not P.segment_spec("serve.gram").reduced
    with pytest.raises(P.policy.UsageError):
        P.tune_precision_segments(pf, compute_dtype="float64")
    with pytest.raises(P.policy.UsageError):
        P.tune_precision_segments(pf, segments=("grid.correction",))
