"""Unified metrics: counters / gauges / histograms behind one registry.
Reference: ``src/repro/obs/metrics.py`` (``METRIC_NAMES``, ``Counter``,
``Gauge``, ``Histogram``, ``MetricsRegistry``, ``load_jsonl``), copied
unchanged so the two packages emit one schema and byte-identical JSONL.

The :class:`MetricsRegistry` is the one schema of the trainer, the serve
engine and the replica router: ``subsystem/name`` keys (the canonical set
in :data:`METRIC_NAMES`, pinned in docs/observability.md), three
instrument kinds, a JSONL sink (``dump_jsonl``) and an end-of-run
``summary()``. Histograms keep a bounded window of recent observations
(:class:`repro_torch.obs.quantiles.WindowedQuantile`) plus exact running
count/sum/min/max. Numpy and stdlib only.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Tuple, Union

from repro_torch.obs.quantiles import WindowedQuantile

# The canonical metric schema. Every name the built-in subsystems emit;
# the docs drift guard pins each into docs/observability.md.
METRIC_NAMES = (
    # train/loop.py
    "train/steps",            # counter: optimizer updates applied
    "train/wall_time_s",      # gauge: total wall-clock of run()
    "train/dispatch_s",       # gauge: time in device dispatch (+ fences)
    "train/data_s",           # gauge: time staging batches / prefetching
    "train/ckpt_s",           # gauge: time committing checkpoints
    "train/chunk_time_s",     # histogram: fenced per-chunk wall time
    "train/step_time_s",      # histogram: fenced per-step wall time
    # distributed/spmd_engine.py (via the trainer's measured feed)
    "spmd/worker_step_s",     # histogram: measured per-worker step time
    # serve/engine.py
    "serve/completed",        # counter
    "serve/rejected",         # counter (all structured reasons)
    "serve/slo_shed",         # counter: wall-clock SLO gate sheds
    "serve/tokens",           # counter: tokens produced
    "serve/latency",          # histogram: request latency (engine clock)
    "serve/ttft",             # histogram: time to first token
    "serve/prefill_s",        # histogram: wall time per prefill call
    "serve/decode_s",         # histogram: wall time per decode step
    "serve/wall_time_s",      # gauge: total wall-clock of run()
    # serve/router.py (virtual-clock units where time-valued)
    "router/completed",       # counter
    "router/rejected",        # counter
    "router/hedges",          # counter: backup copies issued
    "router/hedge_wins",      # counter: backups that beat the primary
    "router/timeouts",        # counter: attempts cancelled at deadline
    "router/retries",         # counter: timed-out attempts re-dispatched
    "router/drained",         # counter: failover requeues
    "router/latency",         # histogram: completed latency (virtual)
)


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "value")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def summary(self) -> Dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins sample (plus ``add`` for accumulated durations)."""

    __slots__ = ("name", "value")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += float(v)

    def summary(self) -> Dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Running count/sum/min/max + windowed p50/p99 of recent samples."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_window")
    kind = "histogram"

    def __init__(self, name: str, window: int = 1024):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._window = WindowedQuantile(window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._window.observe(v)

    @property
    def values(self) -> List[float]:
        """The retained window (most recent samples, oldest first)."""
        return list(self._window.values)

    def quantile(self, q: float, default: float = 0.0) -> float:
        return self._window.estimate(default, quantile=q)

    def summary(self) -> Dict:
        if not self.count:
            return {"kind": self.kind, "count": 0}
        return {"kind": self.kind, "count": self.count,
                "mean": self.total / self.count,
                "min": self.vmin, "max": self.vmax,
                "p50": self.quantile(50.0), "p99": self.quantile(99.0)}


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Name -> instrument, one schema across train/SPMD/serve.

    ``counter``/``gauge``/``histogram`` are get-or-create and
    kind-checked: asking for an existing name as a different kind is an
    error (one schema means one type per name). Iteration is sorted by
    name, so summaries and JSONL dumps are deterministic.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[Tuple[str, Metric]]:
        return iter(sorted(self._metrics.items()))

    def _get(self, name: str, cls, **kwargs) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kwargs)
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} is a {m.kind}, not a "
                             f"{cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        return self._get(name, Histogram, window=window)

    # -- export ---------------------------------------------------------------

    def summary(self) -> Dict[str, Dict]:
        """End-of-run snapshot: {name: {kind, value | count/mean/...}}."""
        return {name: m.summary() for name, m in self}

    def dump_jsonl(self, path: str) -> str:
        """One JSON object per line per metric — the machine-readable
        sink behind the launchers' ``--metrics PATH``."""
        with open(path, "w") as f:
            for name, m in self:
                f.write(json.dumps({"name": name, **m.summary()},
                                   default=float) + "\n")
        return path


def load_jsonl(path: str) -> List[Dict]:
    """Read a ``dump_jsonl`` file back (round-trip tests / tooling)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
