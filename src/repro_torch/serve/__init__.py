"""Serving: continuous batching over a paged KV cache, fronted by the
replica router with its health and SLO controls.
Reference: ``src/repro/serve/`` (trace, pages, paged model, engine with
``StepSession`` and the checkpoint bridge, router, slo, health)."""
from repro_torch.serve.engine import (SERVE_FAULT_KINDS, SERVE_POLICIES,
                                      CompletedRequest, ServeEngine,
                                      ServeReport, StepSession,
                                      restore_params)
from repro_torch.serve.health import HEALTH_STATES, HealthMonitor
from repro_torch.serve.pages import PagePool, PoolConfig, pages_for
from repro_torch.serve.paged_model import supports_paged
from repro_torch.serve.router import (ROUTER_FAULT_KINDS, ReplicaRouter,
                                      RouterCompleted, RouterConfig,
                                      RouterReport)
from repro_torch.serve.slo import SLO_MODES, SLOConfig, SLOController
from repro_torch.serve.trace import (Request, TraceConfig, bucket_for,
                                     make_trace, trace_buckets)

__all__ = [
    "CompletedRequest", "HEALTH_STATES", "HealthMonitor", "PagePool",
    "PoolConfig", "ROUTER_FAULT_KINDS", "ReplicaRouter", "Request",
    "RouterCompleted", "RouterConfig", "RouterReport", "SERVE_FAULT_KINDS",
    "SERVE_POLICIES", "SLO_MODES", "SLOConfig", "SLOController",
    "ServeEngine", "ServeReport", "StepSession", "TraceConfig", "bucket_for",
    "make_trace", "pages_for", "restore_params", "supports_paged",
    "trace_buckets",
]
