"""Amortized inference over the PTA catalogue's joint likelihood, and K12,
on the CPU, on small_catalog (16 pulsars, 3 GWB modes: R = 96), against
the reference's outputs stored in its snapshot (``ref/amortized/``,
written by ``tests/test_torch_snapshot.py --settings small_catalog
--amortized``).

The port's ``JointLikelihood`` at the ingest state on the reference's
residuals (``ref/catalog/pass0/r``):

``AmortizedVI.from_joint_likelihood(n_layers=4, hidden=32, seed=1)``: the
  initial parameters bitwise; at them and the first step's samples each
  sample's lnpost (1e-9 x max(1, |ref|)), logq (1e-12 x max(1, |logq|)),
  the ELBO and each gradient leaf (1e-6 of its largest |g_ref|, zeros
  alike); the 20-step schedule's first two steps free-running within
  1e-6 rel; at the reference's state before the last step the ELBO (1e-6
  rel) and gradient (1e-6 of each leaf's largest), and Adam's update from
  the reference's gradient within 1e-12 of each leaf's largest final
  weight; the reference's trained posterior's draws within 1e-12 of each
  box's width and log-probs within 1e-12 x max(1, |ref|), -inf alike.

K12 on the same likelihood is held in ``test_torch_k12.py``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

F64 = torch.float64
P = "ref/amortized/"


def _leaves(ref, prefix):
    return [ref[k] for k in sorted(k for k in ref
                                   if k.startswith(P + prefix))]


def catalog_vi():
    """(port AmortizedVI, its joint likelihood, the reference's amortized
    meta, the snapshot's arrays)."""
    from pint_torch.amortized import AmortizedVI
    from pint_torch.bridge import (CATALOG_SMALL_PATH, load_catalog_snapshot,
                                   read_snapshot)
    from pint_torch.catalog import (CatalogFitter, JointLikelihood,
                                    ingest_catalog)
    from pint_torch.serving import FitRequest

    meta, ref = read_snapshot(CATALOG_SMALL_PATH)
    A = meta["reference"]["amortized"]
    cf = CatalogFitter(ingest_catalog(load_catalog_snapshot(
        CATALOG_SMALL_PATH, device="cpu")))
    reqs = cf._requests()
    parts = np.split(ref["ref/catalog/pass0/r"],
                     np.cumsum([q.n_toas for q in reqs])[:-1])
    reqs = [FitRequest(M=q.M, r=x, w=q.w, phiinv=q.phiinv, params=q.params,
                       norm=q.norm, request_id=q.request_id,
                       device=q.M.device) for q, x in zip(reqs, parts)]
    jl = JointLikelihood(cf, n_modes=meta["reference"]["settings"]["n_modes"],
                         requests=reqs)
    vi = AmortizedVI.from_joint_likelihood(
        jl, n_layers=A["n_layers"], hidden=A["hidden"], seed=A["flow_seed"])
    return vi, jl, A, ref


@pytest.fixture(scope="module")
def cat():
    return catalog_vi()


def test_catalog_elbo_training_and_posterior_match_the_reference(cat):
    from pint_torch.amortized import (AmortizedPosterior, TrainConfig,
                                      _prng, train_flow)
    from pint_torch.amortized.flows import leaves, unflatten
    from pint_torch.amortized.train import adam_update, loss_and_grad

    vi, _, A, ref = cat
    nl = vi.flow.n_coupling_layers
    init = leaves(vi.flow.init("cpu"))
    assert all(np.array_equal(a.numpy(), b)
               for a, b in zip(init, _leaves(ref, "init/")))
    z0 = ref[P + "z0"]
    k = _prng.split(_prng.prng_key(A["train_seed"]))[1]
    assert np.abs(_prng.normal(k, z0.shape) - z0).max() == 0.0
    ps = [x.clone().requires_grad_(True) for x in init]
    x, logq = vi.sample_and_logq(unflatten(ps, nl), torch.tensor(z0))
    lp = vi.lnpost_batch(x)
    elbo = torch.mean(lp - logq)
    grad = torch.autograd.grad(elbo, ps)
    want = ref[P + "lnpost0"]
    assert np.all(np.abs(lp.detach().numpy() - want)
                  <= 1e-9 * np.maximum(1.0, np.abs(want)))
    wq = ref[P + "logq0"]
    assert np.all(np.abs(logq.detach().numpy() - wq)
                  <= 1e-12 * np.maximum(1.0, np.abs(wq)))
    assert abs(float(elbo.detach()) - A["elbo0"]) \
        <= 1e-9 * max(1.0, abs(A["elbo0"]))
    for g, w in zip(grad, _leaves(ref, "grad0/")):
        g = g.numpy()
        assert np.array_equal(g == 0, w == 0)
        assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1e-300)
    cfg = TrainConfig(steps=A["steps"], n_samples=A["n_samples"],
                      lr=A["lr"], seed=A["train_seed"])
    trace = ref[P + "trace"]
    # the schedule's first two steps (the same samples and updates)
    res = train_flow(vi, TrainConfig(steps=2, n_samples=cfg.n_samples,
                                     lr=cfg.lr, seed=cfg.seed))
    assert np.all(np.abs(res.elbo_trace - trace[:2])
                  <= 1e-6 * np.abs(trace[:2]))
    st = [[torch.as_tensor(v, dtype=F64) for v in _leaves(ref, f"state/{t}_")]
          for t in ("p", "m", "v")]
    key = _prng.prng_key(cfg.seed)
    for _ in range(cfg.steps):
        key, sub = _prng.split(key)
    zl = torch.tensor(_prng.normal(sub, (cfg.n_samples, vi.ndim)))
    loss, g_last = loss_and_grad(vi, st[0], zl)
    assert abs(-float(loss) - trace[-1]) <= 1e-6 * abs(trace[-1])
    g_ref = _leaves(ref, "grad_last/")
    for g, w in zip(g_last, g_ref):
        g = g.numpy()
        assert np.array_equal(g == 0, w == 0)
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    final = _leaves(ref, "final/")
    p_last = adam_update(*st, A["t_state"],
                         [torch.as_tensor(w, dtype=F64) for w in g_ref],
                         cfg)[0]
    for a, w in zip(p_last, final):
        assert np.abs(a.numpy() - w).max() <= 1e-12 * max(np.abs(w).max(),
                                                            1e-300)
    post = AmortizedPosterior(vi.flow, vi.transform, unflatten(
        [torch.as_tensor(w, dtype=F64) for w in final], nl),
        vi.param_labels, vi.vkey)
    kept = ref[P + "draws"]
    width = np.array([s[2] - s[1] for s in vi.transform.specs])
    draws = post.draw(A["draws"], seed=A["draw_seed"])
    assert np.all(np.abs(draws[:len(kept)] - kept) <= 1e-12 * width)
    want = ref[P + "logprob"]
    got = post.log_prob(ref[P + "logprob_points"])
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= 1e-12 * np.maximum(1.0, np.abs(want[fin])))
