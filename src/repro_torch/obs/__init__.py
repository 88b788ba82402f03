"""Telemetry pieces the port uses (reference: ``repro.obs``): the serve
engine's tracer, the windowed-quantile estimator and the measured latency
model behind ``DynamicBackup``'s ``latency_source='measured'``. The
metrics registry and the trainer's spans are not ported yet (ROADMAP
Queue 1 item 7, telemetry)."""
from repro_torch.obs.latency import EmpiricalLatencyModel
from repro_torch.obs.quantiles import WindowedQuantile, windowed_quantile
from repro_torch.obs.trace import NULL, NullTracer, Tracer, as_tracer

__all__ = ["EmpiricalLatencyModel", "WindowedQuantile", "windowed_quantile",
           "NULL", "NullTracer", "Tracer", "as_tracer"]
