"""The reparameterized ELBO over the port's batched posteriors (port of
``pint_tpu/amortized/elbo.py``).

:class:`AmortizedVI` bundles a :class:`~pint_torch.amortized.flows.Flow`,
its :class:`~pint_torch.amortized.flows.PriorTransform` and a batched
lnposterior on tensors, and builds the scalar ELBO the trainer
differentiates::

    z ~ N(0, I)                       (base samples, made on the host)
    u, logdet = flow.forward(params, z)
    x, logjac = transform.constrain(u)
    log q(x)  = logN(z) - logdet - logjac
    ELBO      = mean_z[ lnposterior(x) - log q(x) ]

The lnposterior is :meth:`pint_torch.bayesian.BayesianTiming.
batched_posterior`'s ``fn`` (``torch.autograd`` reaches the parameters
through the hand kernels' ``backward``) or the catalogue's
:meth:`~pint_torch.catalog.likelihood.JointLikelihood.lnlike_fn` (the
``(log10_A, gamma)`` surface, its gradient K12).  The flow's samples lie
in the prior's open support, so every training sample has a finite
lnposterior and gradient.  The training device is the posterior's own:
the model's, or the joint likelihood's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from pint_torch.amortized.flows import Flow, FlowConfig, PriorTransform
from pint_torch.exceptions import UsageError

__all__ = ["AmortizedVI"]


class AmortizedVI:
    """One variational-inference problem: flow + prior transform + batched
    lnposterior.

    ``lnpost_batch`` maps a ``(N, ndim)`` float64 tensor on ``device`` to
    ``(N,)`` log-posteriors, keeping the autograd graph.  ``specs`` are the
    per-parameter prior specs the transform aligns with.  ``vkey`` is the
    caller's identity material for checkpoints and saved flows."""

    def __init__(self, lnpost_batch: Callable, specs: Sequence[tuple],
                 param_labels: Optional[Sequence[str]] = None,
                 flow: Optional[Flow] = None,
                 n_layers: int = 4, hidden: int = 32, seed: int = 0,
                 vkey: tuple = (), device=None):
        from pint_torch import resolve_device

        if not callable(lnpost_batch):
            raise UsageError("lnpost_batch must be callable "
                             f"(got {type(lnpost_batch).__name__})")
        self.transform = PriorTransform(specs)
        ndim = self.transform.ndim
        if param_labels is None:
            param_labels = tuple(f"p{i}" for i in range(ndim))
        if len(param_labels) != ndim:
            raise UsageError(
                f"{len(param_labels)} labels for {ndim} prior specs")
        self.param_labels = tuple(str(p) for p in param_labels)
        self.lnpost_batch = lnpost_batch
        if flow is None:
            flow = Flow(FlowConfig(ndim=ndim, n_layers=n_layers,
                                   hidden=hidden, seed=seed))
        if flow.cfg.ndim != ndim:
            raise UsageError(
                f"flow ndim {flow.cfg.ndim} != {ndim} prior specs")
        self.flow = flow
        self.vkey = tuple(vkey)
        self.device = resolve_device(device)

    # -- constructors over the port's posteriors ----------------------------
    @classmethod
    def from_bayesian(cls, bt, **flow_kw) -> "AmortizedVI":
        """From a :class:`~pint_torch.bayesian.BayesianTiming`: its
        ``batched_posterior`` supplies the function, labels and prior
        specs; the vkey carries the model's parameter signature and the
        TOAs' version and count; the device is the model's."""
        from pint_torch.grid import _model_param_sig

        bp = bt.batched_posterior()
        vkey = (_model_param_sig(bt.model),
                getattr(bt.batch, "_version", 0), bt.batch.ntoas)
        return cls(bp.fn, bp.prior_specs, param_labels=bp.param_labels,
                   vkey=vkey, device=bt.model.device, **flow_kw)

    @classmethod
    def from_fitter(cls, ftr, **flow_kw) -> "AmortizedVI":
        """From an :class:`~pint_torch.mcmc_fitter.MCMCFitter` (or any
        fitter with a BayesianTiming ``bt``)."""
        bt = getattr(ftr, "bt", None)
        if bt is None:
            raise UsageError(
                f"{type(ftr).__name__} has no BayesianTiming surface; "
                "build an MCMCFitter (or pass a BayesianTiming to "
                "from_bayesian)")
        return cls.from_bayesian(bt, **flow_kw)

    @classmethod
    def from_joint_likelihood(cls, jl,
                              log10_A_bounds: Tuple[float, float]
                              = (-18.0, -12.0),
                              gamma_bounds: Tuple[float, float]
                              = (0.0, 7.0),
                              **flow_kw) -> "AmortizedVI":
        """From the catalogue's :class:`~pint_torch.catalog.likelihood.
        JointLikelihood`: the 2-d ``(log10_A, gamma)`` GW-background
        posterior under uniform box priors, on the likelihood's device."""
        specs = (("uniform", float(log10_A_bounds[0]),
                  float(log10_A_bounds[1])),
                 ("uniform", float(gamma_bounds[0]),
                  float(gamma_bounds[1])))
        fn = jl.lnlike_fn()
        widths = np.log(float(log10_A_bounds[1])
                        - float(log10_A_bounds[0])) \
            + np.log(float(gamma_bounds[1]) - float(gamma_bounds[0]))
        lnprior = -float(widths)

        def lnpost(points):
            return fn(points) + lnprior

        return cls(lnpost, specs, param_labels=("log10_A", "gamma"),
                   vkey=("joint_lnlike", jl.n_pulsars, jl.n_modes,
                         jl.pad_shape), device=jl.device, **flow_kw)

    # -- the ELBO -----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return self.transform.ndim

    def sample_and_logq(self, params, z):
        """``z (N, ndim)`` base samples -> ``(x, log_q)``: the flow's
        samples in parameter space and their variational log-density (the
        ELBO's and the draws' one path)."""
        u, logdet = self.flow.forward(params, z)
        x, logjac = self.transform.constrain(u)
        return x, self.flow.base_logpdf(z) - logdet - logjac

    def elbo_fn(self) -> Callable:
        """The scalar ELBO: ``(params, z) -> mean(lnpost(x) - log q(x))``
        over the base batch ``z``."""
        def elbo(params, z):
            x, logq = self.sample_and_logq(params, z)
            return torch.mean(self.lnpost_batch(x) - logq)

        return elbo
