"""Amortized training under a reduced ``flow.coupling`` spec on the CPU:
the port's ``train_flow`` inside ``use_policy(PrecisionPolicy.forced(
"float32"))`` (every segment float32 with ``f64`` accumulation) against
the reference's run under the same policy on ell1, stored in
``ref/amortized_reduced/`` (``tests/test_torch_snapshot.py --settings
ell1 --amortized-reduced``), at the bars the amortized phase holds ell1 to.

``AmortizedVI.from_bayesian(n_layers=4, hidden=32, seed=1)`` on the
``ref/bayes/`` box and ``TrainConfig(steps=20, n_samples=64, lr=1e-2,
seed=2)``: the ELBO and its gradient at the initial parameters (1e-6 rel;
1e-6 of each leaf's largest); the first two steps' ELBO within 1e-6 rel of
both reference runs (jitted and op by op); at the stored state before the
last step the gradient within 1e-6 of each leaf's largest of both
reference gradients there.  The coupling matmuls' gradient goes through
K11's backward (its twin here), counted.  The whole 20-step trace and the
final weights are held on the card (``chip_smoke.py``'s
``amortized_reduced`` phase): on the CPU the suite's parallel workers
make each of the flow's small operations slow.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch

F64 = torch.float64
P = "ref/amortized_reduced/"
BAR = 1e-6


def _leaves(ref, prefix):
    return [ref[k] for k in sorted(k for k in ref
                                   if k.startswith(P + prefix))]


def _leaf_gap(got, want):
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-300))
               for g, w in zip(got, want))


def _z(seed, step, n, ndim):
    from pint_torch.amortized import _prng

    key = _prng.prng_key(seed)
    for _ in range(step + 1):
        key, sub = _prng.split(key)
    return torch.tensor(_prng.normal(sub, (n, ndim)))


def test_reduced_training_follows_the_references(monkeypatch):
    from pint_torch import bridge, precision
    from pint_torch.amortized import AmortizedVI, TrainConfig, train_flow
    from pint_torch.amortized.flows import leaves
    from pint_torch.amortized.train import loss_and_grad
    from pint_torch.bayesian import BayesianTiming
    from pint_torch.kernels import compensated_matmul as K11

    calls = []
    twin = K11.compensated_matmul_backward_reference
    monkeypatch.setattr(K11, "compensated_matmul_backward_reference",
                        lambda *a: calls.append(a[3:]) or twin(*a))
    meta, ref = bridge.read_snapshot(bridge.ELL1_PATH)
    A = meta["reference"]["amortized_reduced"]
    bz = meta["reference"]["bayes"]
    info = {p: dict(distr="uniform", pmin=lo, pmax=hi) for p, lo, hi in
            zip(bz["params"], ref["ref/bayes/pmin"], ref["ref/bayes/pmax"])}
    model, batch = bridge.load_snapshot(bridge.ELL1_PATH, device="cpu")
    with precision.use_policy(
            precision.PrecisionPolicy.forced(*A["policy"])):
        vi = AmortizedVI.from_bayesian(
            BayesianTiming(model, batch, prior_info=info),
            n_layers=A["n_layers"], hidden=A["hidden"], seed=A["flow_seed"])
        assert vi.flow.spec.reduced and vi.flow.spec.tag() == A["flow_spec"]
        cfg = TrainConfig(steps=A["steps"], n_samples=A["n_samples"],
                          lr=A["lr"], seed=A["train_seed"])
        n = cfg.n_samples
        loss0, g0 = loss_and_grad(vi, leaves(vi.flow.init("cpu")),
                                  _z(cfg.seed, 0, n, vi.ndim))
        assert abs(-float(loss0) / A["elbo0"] - 1) <= BAR
        assert _leaf_gap([-x.numpy() for x in g0], _leaves(ref, "grad0/")) \
            <= BAR
        assert calls and set(calls) == {("float32", "f64")}
        res = train_flow(vi, TrainConfig(steps=2, n_samples=cfg.n_samples,
                                         lr=cfg.lr, seed=cfg.seed))
        for key in ("trace", "op_by_op/trace"):
            want = ref[P + key][:2]
            gap = np.abs(res.elbo_trace / want - 1)
            assert gap.max() <= BAR, (key, gap)
        state = [torch.as_tensor(x, dtype=F64)
                 for x in _leaves(ref, "state/p_")]
        _, g = loss_and_grad(vi, state, _z(cfg.seed, cfg.steps - 1, n,
                                           vi.ndim))
        g = [x.numpy() for x in g]
        for key in ("grad_last/", "op_by_op/grad_last/"):
            want = _leaves(ref, key)
            assert all(np.array_equal(a == 0, w == 0)
                       for a, w in zip(g, want)), key
            assert _leaf_gap(g, want) <= BAR, key
