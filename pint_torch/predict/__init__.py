"""Phase prediction: batched polyco generation, caches and serving (port
of ``pint_tpu/predict/``).

* :mod:`pint_torch.predict.generate` -- predictor generation: the host
  layer's TOAs at every window's Chebyshev nodes, the model's absolute
  phase there, and one batched least-squares fit of every (pulsar, window)
  row on kernel K14 (:mod:`pint_torch.kernels.polyco_fit`), rows padded
  onto the window ladder;
* :mod:`pint_torch.predict.cache` -- :class:`PredictorCache`: one
  pulsar's predictor grid, built lazily per window and invalidated by
  span;
* :mod:`pint_torch.predict.door` -- :class:`PredictRequest` /
  :class:`PredictResult` and the batched evaluation of coalesced requests
  on kernel K13 (:mod:`pint_torch.kernels.polyco_eval`).
"""

from pint_torch.predict.cache import PredictorCache
from pint_torch.predict.door import (DEFAULT_TIME_BUCKETS, PredictRequest,
                                     PredictResult, warm_predict)
from pint_torch.predict.generate import (DEFAULT_WINDOW_BUCKETS,
                                         PredictorSet,
                                         generate_predictor_sets,
                                         generate_predictors)

__all__ = [
    "PredictorCache",
    "PredictRequest",
    "PredictResult",
    "PredictorSet",
    "generate_predictors",
    "generate_predictor_sets",
    "warm_predict",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_WINDOW_BUCKETS",
]
