"""Serving: the shape-bucketed request batcher (port of
``pint_tpu/serving/batcher.py``).  The reference's service shell
(admission, journal, AOT cache, warm pool, scheduler, SLOs, load
generator) waits for ROADMAP queue A item 8."""

from pint_torch.serving.batcher import (DEFAULT_BATCH_BUCKETS,
                                        DEFAULT_NFREE_BUCKETS,
                                        DEFAULT_NTOA_BUCKETS, HUBER_STEP_K,
                                        FitRequest, FitResult, SegmentSpec,
                                        ShapeBatcher, bucket_of, pad_request,
                                        resolve_serve_spec, serve_batched,
                                        serve_fused, serve_kernel,
                                        serve_kernel_steps)

__all__ = ["DEFAULT_BATCH_BUCKETS", "DEFAULT_NFREE_BUCKETS",
           "DEFAULT_NTOA_BUCKETS", "HUBER_STEP_K", "FitRequest", "FitResult",
           "SegmentSpec", "ShapeBatcher", "bucket_of", "pad_request",
           "resolve_serve_spec", "serve_batched", "serve_fused",
           "serve_kernel", "serve_kernel_steps"]
