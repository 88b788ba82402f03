"""Serving: continuous batching over a paged KV cache.
Reference: ``src/repro/serve/`` (engine, paged model, pages, trace)."""
from repro_torch.serve.engine import (CompletedRequest, ServeEngine,
                                      ServeReport, StepSession,
                                      restore_params)
from repro_torch.serve.pages import PagePool, PoolConfig, pages_for
from repro_torch.serve.paged_model import supports_paged
from repro_torch.serve.trace import (Request, TraceConfig, bucket_for,
                                     make_trace, trace_buckets)

__all__ = [
    "CompletedRequest", "PagePool", "PoolConfig", "Request", "ServeEngine",
    "ServeReport", "StepSession", "TraceConfig", "bucket_for", "make_trace",
    "pages_for", "restore_params", "supports_paged", "trace_buckets",
]
