"""The port's ensemble sampler and MCMC fitter (``pint_torch/sampler.py``,
``pint_torch/mcmc_fitter.py``, ``pint_torch/runtime/checkpoint.py``)
against the JAX package's on the CPU.

The sampler on a numpy Gaussian posterior: chain, log-probabilities and
acceptance bitwise the reference's (the bookkeeping is the same numpy on
the same generator); the autocorrelation estimators; the checkpoint saved
on an early break; a checkpoint of another run refused with
``CheckpointError``.  ``MCMCFitter`` on the small ELL1 stand-in (32
walkers x 20 steps, live in both packages) and on the committed ngc_phoff
and small_wb_white snapshots (``ref/bayes/``) at the chain bars: every
accept decision the reference's unless the port's own margin
``|lnratio - log u|`` is within twice the lnposterior bar (5e-7 of the
chi2), the walkers bitwise up to the first decision that differs, and with
no decision inside the margin the whole chain bitwise, ``lnprob`` at the
lnposterior bar, the acceptance fraction and the maximum's index exact,
its values and the posterior stds bitwise and the returned chi2 to 1e-6.
Also the custom ``lnprior``/``lnlike`` path, ``set_priors_basic``, the
resync after the free set changes, and a resumed run equal to an
uninterrupted one.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import _torch_standin as standin  # noqa: E402

pytestmark = pytest.mark.torch

LNPOST_BAR = 5e-7
SEED = 20261019


def _gaussian(pts):
    pts = np.atleast_2d(pts)
    return -0.5 * np.sum(((pts - [1.0, -2.0]) / [0.5, 2.0]) ** 2, axis=1)


def _run(mod, nsteps=60, **kw):
    s = mod.EnsembleSampler(20, seed=1, **kw)
    s.initialize_batched(_gaussian, 2)
    pos = np.array([1.0, -2.0]) \
        + 0.1 * np.random.default_rng(2).standard_normal((20, 2))
    s.run_mcmc(pos, nsteps)
    return s


def test_sampler_chain_is_the_references_bitwise():
    from pint_torch import sampler as P
    from pint_tpu import sampler as R

    a, b = _run(P), _run(R)
    assert np.array_equal(a.get_chain(), b.get_chain())
    assert np.array_equal(a.get_log_prob(), b.get_log_prob())
    assert a.acceptance_fraction == b.acceptance_fraction
    assert (a.naccepted, a.ntotal) == (b.naccepted, b.ntotal)
    assert np.array_equal(a.get_chain(flat=True, discard=10, thin=3),
                          b.get_chain(flat=True, discard=10, thin=3))
    d = a.chains_to_dict(["x", "y"])
    assert d["x"].shape == (60, 20)
    a.reset()
    assert a.iteration == 0 and a.acceptance_fraction == 0.0


def test_sampler_decision_log_holds_each_margin():
    """``decision_log`` records each half-ensemble's lnratio - log u and
    its proposals' log-posteriors; a decision accepts where the margin is
    positive, and recording leaves the chain as it was."""
    from pint_torch import sampler as P

    plain = _run(P, nsteps=10)
    s = P.EnsembleSampler(20, seed=1)
    s.decision_log = []
    s.initialize_batched(_gaussian, 2)
    pos = np.array([1.0, -2.0]) \
        + 0.1 * np.random.default_rng(2).standard_normal((20, 2))
    s.run_mcmc(pos, 10)
    assert np.array_equal(s.get_chain(), plain.get_chain())
    assert len(s.decision_log) == 20
    acc = sum(int((m > 0).sum()) for m, _ in s.decision_log)
    assert acc == s.naccepted
    assert all(lp.shape == (10,) for _, lp in s.decision_log)


def test_mesh_and_plan_wait_for_their_item():
    from pint_torch.sampler import EnsembleSampler

    for kw in (dict(mesh=object()), dict(plan="auto")):
        with pytest.raises(NotImplementedError, match="item 9"):
            EnsembleSampler(8, **kw)
    with pytest.raises(ValueError):
        EnsembleSampler(7)


def test_autocorrelation_estimators_match_the_reference():
    from pint_torch import sampler as P
    from pint_tpu import sampler as R

    rng = np.random.default_rng(7)
    x = np.zeros((2000, 4, 2))
    for i in range(1, 2000):
        x[i] = 0.9 * x[i - 1] + rng.standard_normal((4, 2))
    assert np.array_equal(P.integrated_autocorr_time(x),
                          R.integrated_autocorr_time(x))
    assert np.array_equal(P._acf_1d(x[:, 0, 0]), R._acf_1d(x[:, 0, 0]))

    def lnpost(pts):
        return -0.5 * np.sum(np.atleast_2d(pts) ** 2, axis=1)

    out = []
    for mod in (P, R):
        s = mod.EnsembleSampler(nwalkers=20, seed=5)
        s.initialize_batched(lnpost, ndim=2)
        pos = np.random.default_rng(1).standard_normal((20, 2)) * 0.1
        ac = mod.run_sampler_autocorr(s, pos, nsteps=1300, burnin=100,
                                      csteps=100, crit1=10)
        out.append((ac, s.iteration, s.get_autocorr_time(tol=0, quiet=True)))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    assert np.array_equal(out[0][2], out[1][2])
    s = P.EnsembleSampler(nwalkers=10, seed=2)
    s.initialize_batched(lnpost, ndim=1)
    s.run_mcmc(np.random.default_rng(0).standard_normal((10, 1)), 40)
    with pytest.raises(RuntimeError):
        s.get_autocorr_time(tol=50.0, quiet=False)


def test_checkpoint_saved_on_an_early_break(tmp_path):
    from pint_torch.sampler import EnsembleSampler

    path = str(tmp_path / "chain")
    s = EnsembleSampler(nwalkers=10, seed=3, backend=path,
                        checkpoint_every=1000)
    s.initialize_batched(_gaussian, ndim=2)
    pos = np.random.default_rng(0).standard_normal((10, 2))
    for i, _ in enumerate(s.sample(pos, iterations=500)):
        if i == 42:
            break
    s2 = EnsembleSampler(nwalkers=10, backend=path)
    s2.initialize_batched(_gaussian, ndim=2)
    x = s2.resume()
    assert len(s2._chain) == 43 and np.array_equal(x, s.get_chain()[-1])
    assert s2.rng.bit_generator.state == s.rng.bit_generator.state


def test_mismatched_fingerprint_raises_checkpoint_error(tmp_path):
    from pint_torch.runtime.checkpoint import CheckpointError, fingerprint_of
    from pint_torch.sampler import EnsembleSampler

    path = str(tmp_path / "chain.npz")
    s = EnsembleSampler(nwalkers=10, seed=3, backend=path)
    s.fingerprint = fingerprint_of(fitkeys=("F0",), ntoas=10)
    s.initialize_batched(_gaussian, ndim=2)
    s.run_mcmc(np.zeros((10, 2)) + 0.1, 3)
    s2 = EnsembleSampler(nwalkers=10, backend=path)
    s2.fingerprint = fingerprint_of(fitkeys=("F1",), ntoas=10)
    with pytest.raises(CheckpointError):
        s2.resume()
    assert fingerprint_of(a=np.arange(3), b=(1, "x")) \
        == fingerprint_of(b=(1, "x"), a=np.arange(3))


def test_emcee_wrapper_needs_emcee():
    from pint_torch.sampler import EmceeSampler

    try:
        import emcee  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="emcee"):
            EmceeSampler(8)
    else:
        assert EmceeSampler(8).method == "emcee"


# -- the chain bars -----------------------------------------------------------
def _uniform_lnprior(bt) -> float:
    """Each uniform prior's log-density inside its box, summed."""
    return float(sum(p.prior.logpdf(p.prior.ppf(0.5)) for p in bt.params))


def chain_bars(ref, s, bt, pos):
    """Check the port's chain in sampler ``s`` (its ``decision_log`` set)
    against the reference's ``ref`` (chain, lnprob, accepted) from the
    same ``pos``; returns (decisions inside the margin, the (step, half)
    where a decision first differs or None)."""
    chain, lnprob = s.get_chain(), s.get_log_prob()
    T, W, _ = ref["chain"].shape
    half = W // 2
    lnpr = _uniform_lnprior(bt)

    def chi2_of(lp):
        return -2.0 * (lp - lnpr + bt.lognorm)

    lp_cur = bt.lnposterior_batch(pos)
    inside, diverged = [], None
    for t in range(T):
        for h in (0, 1):
            sl = slice(0, half) if h == 0 else slice(half, W)
            marg, lp_prop = s.decision_log[2 * t + h]
            with np.errstate(invalid="ignore"):
                tol = 2.0 * LNPOST_BAR * np.maximum(chi2_of(lp_prop),
                                                    chi2_of(lp_cur[sl]))
                inm = np.isfinite(marg) & (np.abs(marg) <= tol)
            inside += [t] * int(inm.sum())
            differ = (marg > 0) != ref["accepted"][t, sl]
            assert not (differ & ~inm).any(), (t, h)
            if differ.any():
                diverged = (t, h)
                break
        if diverged:
            break
        lp_cur = lnprob[t]
    upto = diverged[0] if diverged else T
    assert np.array_equal(chain[:upto], ref["chain"][:upto])
    return inside, diverged


def full_chain_bars(ref, f, chi2):
    """With no decision inside the margin: the whole chain bitwise,
    lnprob at the lnposterior bar, acceptance and the maximum's index
    exact, its values and the stds bitwise, chi2 to 1e-6."""
    s, bt = f.sampler, f.bt
    assert np.array_equal(s.get_chain(), ref["chain"])
    lnpr = _uniform_lnprior(bt)
    c2 = -2.0 * (ref["lnprob"] - lnpr + bt.lognorm)
    assert np.all(np.abs(s.get_log_prob() - ref["lnprob"])
                  <= LNPOST_BAR * c2)
    assert s.naccepted == ref["naccepted"]
    n = s.get_chain().shape[0]
    lnp = s.get_log_prob(flat=True, discard=int(n * 0.25))
    assert int(np.argmax(lnp)) == ref["maxpost_index"]
    assert np.array_equal(f.maxpost_fitvals, ref["maxpost_fitvals"])
    assert np.array_equal([f.errors[p] for p in f.fitkeys], ref["stds"])
    assert abs(chi2 - ref["chi2"]) <= 1e-6 * abs(ref["chi2"])


def _ref_of(f, chi2, pos):
    """The chain outputs the exporter stores, from a reference fitter."""
    chain = f.sampler.get_chain()
    prev = np.concatenate([pos[None], chain[:-1]])
    n = chain.shape[0]
    lnp = f.sampler.get_log_prob(flat=True, discard=int(n * 0.25))
    return dict(chain=chain, lnprob=f.sampler.get_log_prob(),
                accepted=np.any(chain != prev, axis=2),
                naccepted=f.sampler.naccepted,
                maxpost_index=int(np.argmax(lnp)),
                maxpost_fitvals=np.asarray(f.maxpost_fitvals),
                stds=np.array([f.errors[p] for p in f.fitkeys]), chi2=chi2)


@pytest.fixture(scope="module")
def ell1():
    """The small ELL1 stand-in in both packages, with the prior box of
    ``set_priors_basic`` about a reference WLS fit's uncertainties and the
    reference's seeded ball of walkers."""
    from pint_tpu.fitter import WLSFitter
    from pint_tpu.mcmc_fitter import MCMCFitter
    from pint_tpu.sampler import EnsembleSampler

    model, toas, m, b = standin.port_and_reference(
        standin.SMALL_ELL1_SETTINGS)
    w = WLSFitter(toas, model)
    w.fit_toas(maxiter=1)
    names = list(model.free_params)
    unc = [float(getattr(w.model, p).uncertainty) for p in names]
    info = standin.bayes_prior_info(model, toas, names, unc)
    f = MCMCFitter(toas, model, prior_info=info,
                   sampler=EnsembleSampler(32, seed=SEED))
    for p, u in zip(names, unc):
        getattr(f.model, p).uncertainty = u
    pos = f.sampler.get_initial_pos(f.fitkeys, f.get_fitvals(),
                                    f.get_fiterrs(), f.errfact, seed=4)
    bad = ~np.isfinite(f.bt.lnposterior_batch(pos))
    pos[bad] = f.get_fitvals()
    chi2 = f.fit_toas(maxiter=20, pos=pos.copy())
    return dict(model=model, toas=toas, m=m, b=b, info=info, pos=pos,
                unc=dict(zip(names, unc)), ref=_ref_of(f, chi2, pos))


def _port_fit(m, b, info, pos, nsteps, nwalkers=32, **kw):
    from pint_torch.mcmc_fitter import MCMCFitter
    from pint_torch.sampler import EnsembleSampler

    s = EnsembleSampler(nwalkers, seed=SEED)
    s.decision_log = []
    f = MCMCFitter(b, m, prior_info=info, sampler=s)
    chi2 = f.fit_toas(maxiter=nsteps, pos=pos.copy(), **kw)
    return f, chi2


def test_mcmc_fitter_chain_matches_the_reference(ell1):
    f, chi2 = _port_fit(ell1["m"], ell1["b"], ell1["info"], ell1["pos"], 20)
    ref = ell1["ref"]
    assert f.sampler.get_chain().shape == (20, 32, len(ell1["info"]))
    inside, diverged = chain_bars(ref, f.sampler, f.bt, ell1["pos"])
    if not inside:
        assert diverged is None
        full_chain_bars(ref, f, chi2)
    assert f.converged and f.model["CHI2"].value == chi2
    assert f.fitted_params == f.fitkeys
    for i, p in enumerate(f.fitkeys):
        assert f.model.value(p) == f.maxpost_fitvals[i]
    samples = f.get_posterior_samples()
    assert samples.shape == (15 * 32, len(f.fitkeys))
    text = f.get_fit_summary()
    assert "32 walkers x 20 steps" in text and f.fitkeys[0] in text


def test_mcmc_fitter_resume_equals_an_uninterrupted_run(ell1, tmp_path):
    """10 checkpointed steps, then a new fitter and sampler resuming from
    the file to 20, equal an uninterrupted 20-step run bitwise."""
    from pint_torch.mcmc_fitter import MCMCFitter
    from pint_torch.runtime.checkpoint import CheckpointError
    from pint_torch.sampler import EnsembleSampler

    path = str(tmp_path / "run.npz")
    whole, c_whole = _port_fit(ell1["m"], ell1["b"], ell1["info"],
                               ell1["pos"], 20)
    first, _ = _port_fit(ell1["m"], ell1["b"], ell1["info"], ell1["pos"],
                         10, checkpoint=path)
    assert os.path.exists(path) and first.sampler.iteration == 10
    f = MCMCFitter(ell1["b"], ell1["m"], prior_info=ell1["info"],
                   sampler=EnsembleSampler(32))
    chi2 = f.fit_toas(maxiter=20, checkpoint=path)
    assert np.array_equal(f.sampler.get_chain(), whole.sampler.get_chain())
    assert np.array_equal(f.sampler.get_log_prob(),
                          whole.sampler.get_log_prob())
    assert f.sampler.naccepted == whole.sampler.naccepted
    assert chi2 == c_whole
    # the checkpoint of a run whose frozen parameters differ is refused
    other = MCMCFitter(ell1["b"], ell1["m"], prior_info=ell1["info"],
                       sampler=EnsembleSampler(32))
    frozen = next(n for n, p in other.model.params_table.items()
                  if p.frozen and p.kind == "float" and p.value
                  and p.component != "TimingModel")
    other.model[frozen].value *= 1.0 + 1e-9
    with pytest.raises(CheckpointError):
        other.fit_toas(maxiter=20, checkpoint=path)


def test_custom_lnlike_path_matches_the_reference(ell1):
    """The reference's custom-callable constructor: the posterior sampled
    through the scalar host path, in both packages, at the chain bars;
    lnposterior is lnprior_basic + lnlikelihood_chi2."""
    from pint_torch import mcmc_fitter as PM
    from pint_torch.sampler import EnsembleSampler as PS
    from pint_tpu import mcmc_fitter as RM
    from pint_tpu.sampler import EnsembleSampler as RS

    pos = ell1["pos"][:8]
    r = RM.MCMCFitter(ell1["toas"], ell1["model"], RS(8, seed=SEED),
                      resids=True, phs=0.5, phserr=0.01,
                      prior_info=ell1["info"], lnlike=RM.lnlikelihood_chi2)
    rc = r.fit_toas(4, pos=pos.copy())
    s = PS(8, seed=SEED)
    s.decision_log = []
    f = PM.MCMCFitter(ell1["b"], ell1["m"], s, resids=True, phs=0.5,
                      phserr=0.01, prior_info=ell1["info"],
                      lnlike=PM.lnlikelihood_chi2)
    chi2 = f.fit_toas(4, pos=pos.copy())
    assert f.phs == 0.5 and f.use_resids and f._custom_post
    inside, diverged = chain_bars(_ref_of(r, rc, pos), s, f.bt, pos)
    if not inside:
        assert diverged is None and abs(chi2 - rc) <= 1e-6 * abs(rc)
    th = f.get_fitvals()
    want = PM.lnprior_basic(f, th) + PM.lnlikelihood_chi2(f, th)
    assert f.lnposterior(th) == pytest.approx(want, rel=1e-12)
    with pytest.raises(TypeError):
        PM.lnlikelihood_chi2(object(), th)
    with pytest.raises(TypeError):
        PM.lnlikelihood_basic(f, th)


def test_set_priors_basic_matches_the_reference(ell1):
    from pint_torch import mcmc_fitter as PM
    from pint_tpu import mcmc_fitter as RM

    r = RM.MCMCFitter(ell1["toas"], ell1["model"])
    f = PM.MCMCFitter(ell1["b"], ell1["m"])
    for p, u in ell1["unc"].items():
        getattr(r.model, p).uncertainty = u
        f.model[p].uncertainty = u
    f._bt = object()
    got, want = PM.set_priors_basic(f, 7.0), RM.set_priors_basic(r, 7.0)
    assert got == want and f._bt is None
    bt = f.bt
    assert bt.params[0].prior.jax_spec() == ("uniform",
                                             got[f.fitkeys[0]]["pmin"],
                                             got[f.fitkeys[0]]["pmax"])
    f.model[f.fitkeys[0]].uncertainty = None
    with pytest.raises(ValueError, match="no uncertainty"):
        PM.set_priors_basic(f)


@pytest.mark.parametrize("custom", [False, True])
def test_free_set_change_resyncs(ell1, custom):
    """Freezing a parameter after construction: the fit samples the
    smaller set, on the batched and the custom-callable path."""
    from pint_torch import mcmc_fitter as PM
    from pint_torch.sampler import EnsembleSampler

    kw = dict(lnlike=PM.lnlikelihood_chi2) if custom else {}
    f = PM.MCMCFitter(ell1["b"], ell1["m"], EnsembleSampler(8, seed=1),
                      prior_info=ell1["info"], **kw)
    n0 = f.n_fit_params
    f.model["DMX_0001"].frozen = True
    chi2 = f.fit_toas(2, seed=3)
    assert np.isfinite(chi2)
    assert f.n_fit_params == n0 - 1 and "DMX_0001" not in f.fitkeys
    assert f.sampler.get_chain().shape[-1] == n0 - 1


def test_module_surface_and_refusals(ell1):
    from pint_torch import event_fitter as EF
    from pint_torch import mcmc_fitter as PM

    # the photon-template fitters import from here, as the reference's do
    assert PM.MCMCFitterBinnedTemplate is EF.MCMCFitterBinnedTemplate
    assert PM.MCMCFitterAnalyticTemplate is EF.MCMCFitterAnalyticTemplate
    # concat_toas is merge_TOAs: two halves of the batch, selected with
    # their DMX and mask contexts, join into the whole batch's rows
    b, m = ell1["b"], ell1["m"]
    first = np.arange(b.ntoas) < 2000
    both = PM.concat_toas([b.select(first, m), b.select(~first, m)])
    assert both.ntoas == b.ntoas and np.array_equal(both.mjds, b.mjds)
    assert np.array_equal(both.tdb.hi.numpy(), b.tdb.hi.numpy())
    assert np.array_equal(
        both.contexts["DispersionDMX"]["masks"].numpy(),
        m.components["DispersionDMX"].context["masks"].numpy())
    with pytest.raises(ValueError):
        PM.concat_toas([])
    with pytest.raises(AttributeError):
        PM.no_such_thing
    with pytest.raises(TypeError, match="photon-template"):
        PM.MCMCFitter(ell1["b"], ell1["m"], resids=False)
    f = PM.MCMCFitter(ell1["b"], ell1["m"], prior_info=ell1["info"])
    with pytest.raises(NotImplementedError, match="item 9"):
        f.fit_toas(2, plan="auto")
    bp = f.batched_posterior()
    assert bp.param_labels == tuple(f.fitkeys)


# -- the committed snapshots --------------------------------------------------
def _committed(attr):
    from pint_torch import bridge

    meta, ref = bridge.read_snapshot(getattr(bridge, attr))
    m, b = bridge.load_snapshot(getattr(bridge, attr), device="cpu")
    bz = meta["reference"]["bayes"]
    info = {p: dict(distr="uniform", pmin=lo, pmax=hi) for p, lo, hi in
            zip(bz["params"], ref["ref/bayes/pmin"], ref["ref/bayes/pmax"])}
    stored = {k.split("/")[-1]: v for k, v in ref.items()
              if k.startswith("ref/bayes/")}
    stored.update(naccepted=bz["naccepted"], maxpost_index=bz["maxpost_index"],
                  chi2=bz["chi2"],
                  chain=stored["walker_chain"].transpose(2, 0, 1))
    return m, b, info, bz, stored


@pytest.mark.parametrize("attr", ["NGC_PHOFF_PATH", "WB_WHITE_SMALL_PATH"])
def test_committed_mcmc_run_matches_the_reference(attr):
    """The stored seeded run (32 walkers x 50 steps from the stored
    walkers) at the chain bars."""
    m, b, info, bz, stored = _committed(attr)
    f, chi2 = _port_fit(m, b, info, stored["pos"], bz["nsteps"],
                        nwalkers=bz["nwalkers"])
    inside, diverged = chain_bars(stored, f.sampler, f.bt, stored["pos"])
    if not inside:
        assert diverged is None
        full_chain_bars(stored, f, chi2)
        assert f.sampler.acceptance_fraction == bz["acceptance"]
        assert f.maxpost == pytest.approx(bz["maxpost"], abs=LNPOST_BAR
                                          * abs(bz["chi2"]))


def test_committed_ngc_phoff_resume_is_bitwise(tmp_path):
    """25 checkpointed steps plus 25 resumed equal 50 uninterrupted."""
    from pint_torch.mcmc_fitter import MCMCFitter
    from pint_torch.sampler import EnsembleSampler

    m, b, info, bz, stored = _committed("NGC_PHOFF_PATH")
    path = str(tmp_path / "phoff.npz")
    whole, c_whole = _port_fit(m, b, info, stored["pos"], 50)
    _port_fit(m, b, info, stored["pos"], 25, checkpoint=path)
    f = MCMCFitter(b, m, prior_info=info, sampler=EnsembleSampler(32))
    chi2 = f.fit_toas(maxiter=50, checkpoint=path)
    assert np.array_equal(f.sampler.get_chain(), whole.sampler.get_chain())
    assert np.array_equal(f.sampler.get_log_prob(),
                          whole.sampler.get_log_prob())
    assert chi2 == c_whole
