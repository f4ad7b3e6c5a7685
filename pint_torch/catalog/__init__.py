"""The PTA catalog (port of ``pint_tpu/catalog/``): many pulsars through
one integrity gate (:mod:`~pint_torch.catalog.ingest`), ragged shapes onto
learned padded buckets (:mod:`~pint_torch.catalog.buckets`), one batched
GLS call per bucket (:mod:`~pint_torch.catalog.batchfit`), the
Hellings-Downs geometry (:mod:`~pint_torch.catalog.crosscorr`) and the
joint log-likelihood with the common gravitational-wave background
(:mod:`~pint_torch.catalog.likelihood`, its cross term on the hand kernel
K10).  The reference's ``make_synthetic_catalog`` simulates TOAs (ROADMAP
queue A item 11) and is not ported: catalogs come from snapshots
(:func:`pint_torch.bridge.load_catalog_snapshot`)."""

from pint_torch.catalog.batchfit import (CatalogFitResult, CatalogFitter,
                                         CatalogRefineResult, PulsarFit,
                                         catalog_batched, catalog_fused)
from pint_torch.catalog.buckets import (BucketPlan, assign_buckets,
                                        learn_ladders)
from pint_torch.catalog.crosscorr import (angular_separations, hd_cholesky,
                                          hd_curve, hd_matrix,
                                          pulsar_directions)
from pint_torch.catalog.ingest import (CatalogIngestReport, CatalogPulsar,
                                       ingest_catalog)
from pint_torch.catalog.likelihood import JointLikelihood

__all__ = [
    "CatalogFitResult", "CatalogFitter", "CatalogRefineResult",
    "PulsarFit", "catalog_batched", "catalog_fused",
    "BucketPlan", "assign_buckets", "learn_ladders",
    "angular_separations", "hd_cholesky", "hd_curve", "hd_matrix",
    "pulsar_directions",
    "CatalogIngestReport", "CatalogPulsar", "ingest_catalog",
    "JointLikelihood",
]
