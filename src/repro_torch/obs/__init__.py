"""Observability (reference: ``repro.obs``): the tracer and its span
taxonomy, the metrics registry, the windowed-quantile estimator and the
measured latency model behind ``DynamicBackup``'s
``latency_source='measured'``. Numpy and stdlib only. Pass ``tracer=None``
anywhere and :func:`as_tracer` substitutes the shared no-op :data:`NULL`
tracer."""
from repro_torch.obs.latency import EmpiricalLatencyModel
from repro_torch.obs.metrics import (METRIC_NAMES, Counter, Gauge, Histogram,
                                     MetricsRegistry, load_jsonl)
from repro_torch.obs.quantiles import WindowedQuantile, windowed_quantile
from repro_torch.obs.trace import (NULL, SPAN_NAMES, NullTracer, Tracer,
                                   as_tracer, load_trace, span_tree)

__all__ = ["EmpiricalLatencyModel", "METRIC_NAMES", "Counter", "Gauge",
           "Histogram", "MetricsRegistry", "load_jsonl", "WindowedQuantile",
           "windowed_quantile", "NULL", "SPAN_NAMES", "NullTracer", "Tracer",
           "as_tracer", "load_trace", "span_tree"]
