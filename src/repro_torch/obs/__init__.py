"""Telemetry pieces the ported serve engine uses (reference: ``repro.obs``)."""
from repro_torch.obs.trace import NULL, NullTracer, Tracer, as_tracer

__all__ = ["NULL", "NullTracer", "Tracer", "as_tracer"]
