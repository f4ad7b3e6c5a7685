"""Amortized inference: variational inference with normalizing flows over
the port's posteriors (port of ``pint_tpu/amortized/``).

* :mod:`~pint_torch.amortized.flows` -- RealNVP affine couplings with
  fixed seeded permutations, and the :class:`PriorTransform` onto the
  uniform/normal prior families;
* :mod:`~pint_torch.amortized.elbo` -- the reparameterized ELBO over
  ``BayesianTiming.batched_posterior`` or the catalogue's
  ``JointLikelihood``;
* :mod:`~pint_torch.amortized.train` -- a host-side Adam loop around one
  reverse-mode step, deterministic for a seed (the reference's random
  stream, :mod:`~pint_torch.amortized._prng`), checkpointed and resumable;
* :mod:`~pint_torch.amortized.posterior` -- the trained flow's draws and
  log-probabilities, saved and loaded in the reference's format.
"""

from pint_torch.amortized.elbo import AmortizedVI
from pint_torch.amortized.flows import Flow, FlowConfig, PriorTransform
from pint_torch.amortized.posterior import AmortizedPosterior
from pint_torch.amortized.train import TrainConfig, TrainResult, train_flow

__all__ = [
    "AmortizedVI",
    "AmortizedPosterior",
    "Flow",
    "FlowConfig",
    "PriorTransform",
    "TrainConfig",
    "TrainResult",
    "train_flow",
]
