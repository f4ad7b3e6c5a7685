"""Amortized inference on the CPU: the port's flows, ELBO, training and
posterior (``pint_torch/amortized/``) against the JAX package's.

The random stream (``pint_torch.amortized._prng``): keys, splits, 64-bit
words and uniforms bitwise ``jax.random``'s; normals within one ulp (on
200000 draws 4 differ, by one ulp: XLA's fused multiply-adds, emulated).
The flow: ``init()`` bitwise, forward and inverse against the reference's
on random weights (1e-12), the inverse undoing the forward; the clip's
gradient at a tie one half, as ``jnp.clip``'s.

On ngc_phoff (its ``ref/bayes/`` prior box; the posterior through K1's
``backward``), with ``AmortizedVI.from_bayesian(n_layers=4, hidden=32,
seed=1)`` in both packages:

* at the initial parameters and the first step's samples: the ELBO, each
  sample's lnpost within 5e-7 x its chi2, logq within 1e-12 x max(1,
  |logq|), each gradient leaf within 1e-6 of its largest |g_ref| (exact
  zeros where the reference's are);
* training (``TrainConfig(steps=4, n_samples=64, lr=1e-2, seed=2)``): the
  first two steps' ELBO within 1e-6 rel free-running; at the reference's
  state before its last step the ELBO (1e-6 rel) and the gradient (1e-6
  of each leaf's largest), and Adam's update from the reference's
  gradient within 1e-12 of each leaf's largest final weight.  A
  free-running trace is held no further: one ulp of one initial weight
  moves the reference's own trace past 1e-6 by the sixth step here
  (measured), and Adam's per-entry normalization turns rounding in a
  small gradient entry into a whole step;
* a crash after the first checkpoint chunk resumes bitwise; a fixed seed
  repeats bitwise; another problem's checkpoint raises ``CheckpointError``;
* the reference's trained posterior carried into the port
  (``bridge.flow_params``): draws within 1e-12 of each box's width,
  log-probs within 1e-12 x max(1, |ref|) with ``-inf`` exactly where the
  reference's; saved by either package, loaded by the other, bitwise;
* ``train_flow(plan=)`` refused; under a reduced ``flow.coupling`` spec
  it trains (K11's backward; its bars against the reference are in
  ``test_torch_amortized_reduced.py``); ``AmortizedPosterior.load``
  defaults to the card.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

from pint_torch.amortized import _prng  # noqa: E402

pytestmark = pytest.mark.torch

F64 = torch.float64
SPEC = dict(n_layers=4, hidden=32, seed=1)
CFG = dict(steps=4, n_samples=64, lr=1e-2, seed=2)


def _leaves_ref(tree):
    return [np.array(x) for x in jax.tree_util.tree_leaves(tree)]


def _leaves_port(tree):
    from pint_torch.amortized.flows import leaves

    return [x.detach().cpu().numpy() for x in leaves(tree)]


def first_step(rvi, init, z):
    """The reference's ELBO at ``(init, z)`` with its samples, lnposts and
    logq, and its gradient: one compiled function."""
    def f(p):
        x, logq = rvi.sample_and_logq(p, z)
        lp = rvi.lnpost_batch(x)
        return jnp.mean(lp - logq), (x, lp, logq)

    return jax.jit(jax.value_and_grad(f, has_aux=True))(init)


def _port_tree(flat, n_layers):
    from pint_torch.amortized.flows import unflatten

    return unflatten([torch.as_tensor(np.asarray(x), dtype=F64)
                      for x in flat], n_layers)


# -- the random stream --------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 2, 5, 20261025, 2**40 + 3])
def test_keys_bits_and_uniforms_are_the_references(seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(k), _prng.prng_key(seed))
    ks = jax.random.split(k)
    assert np.array_equal(np.asarray(ks), _prng.split(_prng.prng_key(seed)))
    assert np.array_equal(np.asarray(jax.random.split(k, 5)),
                          _prng.split(_prng.prng_key(seed), 5))
    sub = _prng.split(_prng.prng_key(seed))[1]
    assert np.array_equal(np.asarray(jax.random.bits(
        ks[1], (7, 13), dtype=jnp.uint64)), _prng.random_bits(sub, (7, 13)))
    assert np.array_equal(np.asarray(jax.random.uniform(
        ks[1], (64, 89), dtype=np.float64)), _prng.uniform(sub, (64, 89)))
    assert np.array_equal(np.asarray(jax.random.uniform(
        ks[1], (33,), dtype=np.float64, minval=-2.0, maxval=3.0)),
        _prng.uniform(sub, (33,), -2.0, 3.0))


def test_normals_are_within_one_ulp_of_the_references():
    """200000 normals: bitwise but for a handful (measured 4), those one
    ulp apart."""
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (200000,),
                                     dtype=np.float64))
    zp = _prng.normal(_prng.prng_key(3), (200000,))
    ulp = np.abs(z - zp) / np.spacing(np.abs(z))
    assert ulp.max() <= 1.0
    assert np.count_nonzero(z != zp) <= 20
    x = np.linspace(-1.0, 1.0, 2001)
    e = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    ep = _prng.erfinv(x)
    assert np.array_equal(np.isinf(e), np.isinf(ep))
    fin = np.isfinite(e)
    assert (np.abs(e[fin] - ep[fin]) <= np.spacing(np.abs(e[fin]))).all()


# -- the flow -----------------------------------------------------------------
@pytest.mark.parametrize("ndim,n_layers", [(89, 4), (2, 4), (7, 2), (1, 3)])
def test_flow_init_is_the_references_bitwise(ndim, n_layers):
    from pint_torch.amortized import Flow, FlowConfig
    from pint_tpu.amortized import Flow as RFlow, FlowConfig as RFlowConfig

    got = _leaves_port(Flow(FlowConfig(ndim, n_layers, 32, seed=1))
                       .init("cpu"))
    want = _leaves_ref(RFlow(RFlowConfig(ndim, n_layers, 32, seed=1))
                       .init())
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert FlowConfig(ndim, n_layers, 32, seed=1).digest() \
        == RFlowConfig(ndim, n_layers, 32, seed=1).digest()


def test_flow_maps_match_the_reference_and_invert():
    from pint_torch.amortized import Flow, FlowConfig
    from pint_tpu.amortized import Flow as RFlow, FlowConfig as RFlowConfig

    rng = np.random.default_rng(4)
    cfg = dict(ndim=7, n_layers=3, hidden=8, seed=3)
    rf, pf = RFlow(RFlowConfig(**cfg)), Flow(FlowConfig(**cfg))
    flat = [x + 0.3 * rng.standard_normal(x.shape)
            for x in _leaves_ref(rf.init())]
    rp = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(rf.init()),
        [jnp.asarray(x) for x in flat])
    pp = _port_tree(flat, 3)
    z = rng.standard_normal((50, 7))
    ru, rld = rf.forward(rp, jnp.asarray(z))
    pu, pld = pf.forward(pp, torch.tensor(z))
    assert np.abs(pu.numpy() - np.asarray(ru)).max() <= 1e-12 * np.abs(
        np.asarray(ru)).max()
    assert np.abs(pld.numpy() - np.asarray(rld)).max() <= 1e-12 * max(
        1.0, np.abs(np.asarray(rld)).max())
    rz, rli = rf.inverse(rp, ru)
    pz, pli = pf.inverse(pp, pu)
    assert np.abs(pz.numpy() - np.asarray(rz)).max() <= 1e-12
    assert np.abs(pz.numpy() - z).max() <= 1e-12
    assert np.abs((pli + pld).numpy()).max() <= 1e-12


def test_prior_transform_matches_and_its_clip_ties_split_the_gradient():
    """``constrain``/``unconstrain`` against the reference's (1e-12); a
    box so narrow that lo + width * sigmoid(u) rounds onto its edge gives
    the clip's gradient one half there, as ``jnp.clip``'s."""
    from pint_torch.amortized import PriorTransform
    from pint_tpu.amortized import PriorTransform as RPT

    specs = [("uniform", 339.31568728824, 339.31568728824 + 22 * 5.7e-14),
             ("normal", 1.5, 0.25), ("uniform", -3.0, 2.0)]
    rt, pt = RPT(specs), PriorTransform(specs)
    u = np.array([[40.0, 0.3, -0.7], [-40.0, -2.0, 35.0], [0.1, 0.0, 1.0]])
    rx, rlj = rt.constrain(jnp.asarray(u))
    px, plj = pt.constrain(torch.tensor(u))
    assert np.abs(px.numpy() - np.asarray(rx)).max() <= 1e-12 * 340
    assert np.abs(plj.numpy() - np.asarray(rlj)).max() <= 1e-12 * 40
    ru, rli, rin = rt.unconstrain(rx)
    pu, pli, pin = pt.unconstrain(px)
    assert np.array_equal(pin.numpy(), np.asarray(rin))
    assert np.abs(pli.numpy() - np.asarray(rli)).max() <= 1e-9 * np.abs(
        np.asarray(rli)).max()
    want = np.asarray(jax.grad(lambda a: jnp.sum(rt.constrain(a)[0][:, 0]))(
        jnp.asarray(u)))
    uu = torch.tensor(u, requires_grad=True)
    (got,) = torch.autograd.grad(pt.constrain(uu)[0][:, 0].sum(), uu)
    tie = px.numpy()[:, 0] == np.array([s[2] for s in specs])[0]
    assert tie.any()
    assert np.array_equal(got.numpy()[tie], want[tie])
    assert (got.numpy()[tie, 0] == 0.5 * got.numpy()[tie, 0] * 2).all()


# -- ngc_phoff: the ELBO, training, the posterior ------------------------------
@pytest.fixture(scope="module")
def ngc():
    """(reference AmortizedVI, port AmortizedVI) on ngc_phoff with its
    ``ref/bayes/`` box, the port on the CPU."""
    from pint_torch import bridge
    from pint_torch.amortized import AmortizedVI
    from pint_torch.bayesian import BayesianTiming as PBT
    from pint_tpu.amortized import AmortizedVI as RVI
    from pint_tpu.bayesian import BayesianTiming as RBT

    model, toas, m, b = standin.port_and_reference(
        standin.NGC_PHOFF_SETTINGS, full=True)
    meta, ref = bridge.read_snapshot(bridge.NGC_PHOFF_PATH)
    bz = meta["reference"]["bayes"]
    info = {p: dict(distr="uniform", pmin=lo, pmax=hi) for p, lo, hi in
            zip(bz["params"], ref["ref/bayes/pmin"], ref["ref/bayes/pmax"])}
    rvi = RVI.from_bayesian(RBT(model, toas, prior_info=info), **SPEC)
    pbt = PBT(m, b, prior_info=info)
    pvi = AmortizedVI.from_bayesian(pbt, **SPEC)
    return rvi, pvi, pbt


def test_elbo_and_its_gradient_match_the_reference(ngc):
    rvi, pvi, pbt = ngc
    zs = standin.amortized_z_stream(CFG["seed"], 1, CFG["n_samples"],
                                    rvi.ndim)
    k = _prng.split(_prng.prng_key(CFG["seed"]))[1]
    assert np.array_equal(zs[0], _prng.normal(k, zs[0].shape))
    init = jax.tree_util.tree_map(jnp.asarray, rvi.flow.init())
    z = jnp.asarray(zs[0])
    (rval, (rx, rl, rq)), rgrad = first_step(rvi, init, z)
    rl = np.asarray(rl)
    from pint_torch.amortized.flows import leaves, unflatten

    ps = [x.requires_grad_(True) for x in leaves(pvi.flow.init("cpu"))]
    params = unflatten(ps, SPEC["n_layers"])
    zt = torch.tensor(zs[0])
    pval = pvi.elbo_fn()(params, zt)
    pgrad = torch.autograd.grad(pval, ps)
    px, pq = pvi.sample_and_logq(params, zt)
    pl = pvi.lnpost_batch(px).detach().numpy()
    lnpr = np.array([pbt.lnprior(x) for x in np.asarray(rx)])
    chi2 = -2.0 * (rl - lnpr + pbt.lognorm)
    assert np.all(np.abs(pl - rl) <= 5e-7 * chi2)
    rq = np.asarray(rq)
    assert np.all(np.abs(pq.detach().numpy() - rq)
                  <= 1e-12 * np.maximum(1.0, np.abs(rq)))
    assert abs(float(pval.detach()) - float(rval)) <= 5e-7 * float(np.mean(chi2))
    for g, w in zip(pgrad, _leaves_ref(rgrad)):
        g = g.numpy()
        assert np.array_equal(g == 0, w == 0)
        assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-300)


def _ref_run(rvi, steps):
    """The reference's run: (trace, state before the last step, final)."""
    from pint_tpu.amortized import TrainConfig
    from pint_tpu.amortized.train import _adam_step_fn

    cfg = TrainConfig(**dict(CFG, steps=steps))
    step = _adam_step_fn(rvi, cfg)
    params = jax.tree_util.tree_map(jnp.asarray, rvi.flow.init())
    m = jax.tree_util.tree_map(jnp.zeros_like, params)
    v = jax.tree_util.tree_map(jnp.zeros_like, params)
    t, trace = 0, []
    zs = standin.amortized_z_stream(cfg.seed, steps, cfg.n_samples,
                                    rvi.ndim)
    for i, z in enumerate(zs):
        if i == steps - 1:
            before = (params, m, v, int(t))
        params, m, v, t, e = step(params, m, v, t, jnp.asarray(z))
        trace.append(float(e))
    return np.array(trace), before, params, zs


def check_training(rvi, pvi, steps):
    """The port's run against the reference's: the first two steps' ELBO
    free-running within 1e-6 rel; at the reference's state before its last
    step the ELBO (1e-6 rel) and the gradient (1e-6 of each leaf's
    largest, zeros alike), and the port's Adam update from the
    reference's gradient within 1e-12 of each leaf's largest final
    weight."""
    from pint_torch.amortized import TrainConfig, train_flow
    from pint_torch.amortized.train import adam_update, loss_and_grad

    trace, before, final, zs = _ref_run(rvi, steps)
    cfg = TrainConfig(**dict(CFG, steps=steps))
    res = train_flow(pvi, cfg)
    assert np.all(np.abs(res.elbo_trace[:2] - trace[:2])
                  <= 1e-6 * np.abs(trace[:2]))
    zl = jnp.asarray(zs[-1])
    g_ref = _leaves_ref(jax.jit(jax.grad(
        lambda p: -rvi.elbo_fn()(p, zl)))(before[0]))
    p, m, v = ([torch.as_tensor(x, dtype=F64) for x in _leaves_ref(tr)]
               for tr in before[:3])
    loss, g = loss_and_grad(pvi, p, torch.tensor(zs[-1]))
    assert abs(-float(loss) - trace[-1]) <= 1e-6 * abs(trace[-1])
    for a, w in zip(g, g_ref):
        a = a.numpy()
        assert np.array_equal(a == 0, w == 0)
        assert np.abs(a - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-300)
    p_last = adam_update(p, m, v, before[3],
                         [torch.as_tensor(x, dtype=F64) for x in g_ref],
                         cfg)[0]
    for a, w in zip(p_last, _leaves_ref(final)):
        assert np.abs(a.numpy() - w).max() <= 1e-12 * max(np.abs(w).max(),
                                                            1e-300)


def test_training_matches_the_reference_step_by_step(ngc):
    rvi, pvi, _ = ngc
    check_training(rvi, pvi, CFG["steps"])


def test_crash_resume_and_seed_are_bitwise(ngc, tmp_path):
    from pint_torch.amortized import TrainConfig, train_flow
    from pint_torch.exceptions import CheckpointError

    _, pvi, _ = ngc
    cfg = TrainConfig(**dict(CFG, checkpoint_chunk=2))
    whole = train_flow(pvi, cfg)
    again = train_flow(pvi, cfg)
    assert np.array_equal(whole.elbo_trace, again.elbo_trace)
    ck = str(tmp_path / "ck")
    first = train_flow(pvi, cfg, checkpoint=ck)
    assert np.array_equal(first.elbo_trace, whole.elbo_trace)
    os.remove(os.path.join(ck, "chunk_00001.npz"))  # the crash
    resumed = train_flow(pvi, cfg, checkpoint=ck)
    assert resumed.resumed_steps == 2
    assert np.array_equal(resumed.elbo_trace, whole.elbo_trace)
    for a, b in zip(_leaves_port(resumed.params), _leaves_port(whole.params)):
        assert np.array_equal(a, b)
    with pytest.raises(CheckpointError):
        train_flow(pvi, TrainConfig(**dict(CFG, checkpoint_chunk=2,
                                           lr=2e-2)), checkpoint=ck)


def test_draws_and_log_probs_of_the_references_posterior(ngc, tmp_path):
    """The reference's posterior after its 4-step run, carried into the
    port by ``bridge.flow_params`` and by files either package saved."""
    from pint_torch.amortized import AmortizedPosterior
    from pint_torch.bridge import flow_params
    from pint_tpu.amortized import AmortizedPosterior as RAP

    rvi, pvi, _ = ngc
    _, _, final, _ = _ref_run(rvi, CFG["steps"])

    class Res:
        params = final

    rpost = RAP.from_training(rvi, Res)
    ppost = AmortizedPosterior(pvi.flow, pvi.transform,
                               flow_params(final, device="cpu"),
                               pvi.param_labels)
    width = np.array([s[2] - s[1] for s in rvi.transform.specs])
    rd, pd = rpost.draw(300, seed=5), ppost.draw(300, seed=5)
    assert np.all(np.abs(pd - rd) <= 1e-12 * width)
    pts = np.array(rpost.draw(40, seed=7))
    pts[:4, 0] = rvi.transform.specs[0][2] + 0.05 * width[0]
    pts[4:6, 1] = rvi.transform.specs[1][1]
    want, got = rpost.log_prob(pts), ppost.log_prob(pts)
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(want).sum() == 4
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= 1e-12 * np.maximum(1.0, np.abs(want[fin])))
    # saved by the reference, loaded by the port; and back
    rpost.save(str(tmp_path / "ref"))
    loaded = AmortizedPosterior.load(str(tmp_path / "ref"), device="cpu")
    for a, b in zip(_leaves_port(loaded.params), _leaves_ref(final)):
        assert np.array_equal(a, b)
    assert loaded.ident() == rpost.ident()
    loaded.save(str(tmp_path / "port"))
    back = RAP.load(str(tmp_path / "port"))
    for a, b in zip(_leaves_ref(back.params), _leaves_ref(final)):
        assert np.array_equal(a, b)
    assert np.array_equal(loaded.draw(50, seed=5), ppost.draw(50, seed=5))


def test_plan_reduced_spec_and_missing_card_are_refused(ngc, tmp_path):
    from pint_torch import NoGPUError
    from pint_torch.amortized import (AmortizedPosterior, AmortizedVI, Flow,
                                      FlowConfig, TrainConfig, train_flow)
    from pint_torch.precision import SegmentSpec

    _, pvi, _ = ngc
    with pytest.raises(NotImplementedError, match="item 9"):
        train_flow(pvi, TrainConfig(**CFG), plan="auto")
    spec = SegmentSpec(segment="flow.coupling", compute_dtype="float32",
                       accumulation="two_prod", source="forced")
    flow = Flow(FlowConfig(pvi.ndim, **SPEC), spec=spec)
    vi = AmortizedVI(pvi.lnpost_batch, pvi.transform.specs, flow=flow,
                     device="cpu")
    res = train_flow(vi, TrainConfig(**dict(CFG, steps=2)))
    assert res.steps == 2 and np.all(np.isfinite(res.elbo_trace))
    post = AmortizedPosterior(flow, pvi.transform, flow.init("cpu"),
                              pvi.param_labels)
    assert post.draw(8, seed=1).shape == (8, pvi.ndim)
    post.save(str(tmp_path / "f"))
    if not torch.cuda.is_available():
        with pytest.raises(NoGPUError):
            AmortizedPosterior.load(str(tmp_path / "f"))
        with pytest.raises(NoGPUError):
            AmortizedVI(pvi.lnpost_batch, pvi.transform.specs)
