"""Host-side tracer: nested spans, ring-buffered, Chrome-trace export.
Reference: ``src/repro/obs/trace.py`` (``SPAN_NAMES``, ``NullTracer``,
``as_tracer``, ``Tracer``, ``load_trace``, ``span_tree``), copied unchanged
so every span keeps its name (docs/observability.md pins them).

Spans are host wall-clock intervals (``time.perf_counter_ns``). Device
work inside a span is fenced by the caller: the trainer's
``train/device_wait`` and the spmd engine's ``spmd/collective_wait`` are
``torch.cuda.synchronize`` at a chunk edge, and the serve engine's token
reads fence its spans, so a span covers the device time it launched.
Disabled tracing is the shared :data:`NULL` no-op singleton. Stdlib only.
"""
from __future__ import annotations

import collections
import json
import time
from typing import Any, Deque, Dict, List

# The span taxonomy: every name an instrumentation site emits. cat is
# the prefix; docs/observability.md documents each name.
SPAN_NAMES = (
    # train/loop.py
    "train/step",             # per-step dispatch (chunk_size=1)
    "train/chunk",            # one K-step chunk (graph replays on the card)
    "train/device_wait",      # torch.cuda.synchronize at the chunk edge
    "train/data_wait",        # prefetcher / batch staging
    "train/ckpt_save",        # atomic checkpoint commit
    # distributed/spmd_engine.py
    "spmd/dispatch",          # the engine's step/chunk call
    "spmd/collective_wait",   # torch.cuda.synchronize: collectives + compute
    # serve/engine.py (+ StepSession)
    "serve/admit",            # admission: slot+pages grant, incl. prefill
    "serve/prefill",          # the bucketed prefill call
    "serve/decode",           # one decode step over every active slot
    "serve/evict",            # instant: preempt evicted the batch
    # serve/router.py (instants on the virtual-clock event loop)
    "router/dispatch",        # primary copy dispatched to a replica
    "router/hedge",           # backup copy issued past the p95 threshold
    "router/timeout",         # attempt cancelled at its deadline
    "router/failover",        # unhealthy replica drained back to the queue
)


class _NullSpan:
    """Shared no-op context manager — the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: every method is a no-op, ``span()`` allocates
    nothing (returns one shared context manager)."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, cat: str = "", **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "", **args) -> None:
        pass

    def counter(self, name: str, value: float) -> None:
        pass

    def export(self, path: str) -> None:
        pass


NULL = NullTracer()


def as_tracer(tracer) -> Any:
    """None -> the shared no-op tracer; anything else passes through."""
    return NULL if tracer is None else tracer


class _Span:
    """One live span: ``with tracer.span(...):`` emits an "X" event."""

    __slots__ = ("_tracer", "name", "cat", "args", "_start")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        tr = self._tracer
        tr._emit({"name": self.name, "cat": self.cat, "ph": "X",
                  "ts": (self._start - tr._t0) / 1e3,
                  "dur": (end - self._start) / 1e3,
                  "pid": tr.pid, "tid": tr.tid, "args": self.args})
        return False


class Tracer:
    """Ring-buffered span recorder with Chrome-trace JSON export.

    * ``span(name, **args)`` — a context manager ("X" complete event).
    * ``instant(name, **args)`` — a zero-duration marker ("i" event).
    * ``counter(name, value)`` — a "C" counter sample.
    * ``export(path)`` / ``to_dict()`` — the ``{"traceEvents": [...]}``
      JSON object perfetto loads directly.

    Timestamps are microseconds since the tracer's construction. The
    oldest events drop past ``capacity`` and ``dropped`` counts them.
    """

    enabled = True

    def __init__(self, capacity: int = 1 << 16, pid: int = 0, tid: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.capacity = int(capacity)
        self.pid = pid
        self.tid = tid
        self.events: Deque[Dict] = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self._t0 = time.perf_counter_ns()

    def __len__(self) -> int:
        return len(self.events)

    def _emit(self, ev: Dict) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # -- recording ------------------------------------------------------------

    def span(self, name: str, cat: str = "", **args) -> _Span:
        return _Span(self, name, cat or name.split("/", 1)[0], args)

    def instant(self, name: str, cat: str = "", **args) -> None:
        self._emit({"name": name, "cat": cat or name.split("/", 1)[0],
                    "ph": "i", "ts": self._now_us(), "s": "t",
                    "pid": self.pid, "tid": self.tid, "args": args})

    def counter(self, name: str, value: float) -> None:
        self._emit({"name": name, "ph": "C", "ts": self._now_us(),
                    "pid": self.pid, "tid": self.tid,
                    "args": {"value": float(value)}})

    # -- export ---------------------------------------------------------------

    def to_dict(self) -> Dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped,
                              "clock": "perf_counter_ns",
                              "capacity": self.capacity}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path


def load_trace(path: str) -> Dict:
    """Load + structurally validate a Chrome-trace JSON file.

    The round-trip check the tests and the CI sample-trace step use:
    the object form with a ``traceEvents`` list whose entries carry the
    required ``name``/``ph``/``ts`` keys.
    """
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError(f"{path}: not a Chrome-trace JSON object "
                         "(missing 'traceEvents')")
    for i, ev in enumerate(data["traceEvents"]):
        for key in ("name", "ph", "ts"):
            if key not in ev:
                raise ValueError(f"{path}: traceEvents[{i}] missing {key!r}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"{path}: traceEvents[{i}] is a complete "
                             "event without 'dur'")
    return data


def span_tree(events: List[Dict]) -> List[Dict]:
    """Nest "X" events by interval containment (per pid/tid track).

    Returns the roots; each node gains a ``children`` list. Used by the
    round-trip tests to assert the recorded nesting is well-formed.
    """
    spans = [dict(e) for e in events if e.get("ph") == "X"]
    spans.sort(key=lambda e: (e.get("pid", 0), e.get("tid", 0),
                              e["ts"], -e["dur"]))
    roots: List[Dict] = []
    stack: List[Dict] = []
    for ev in spans:
        ev["children"] = []
        while stack and not (
                stack[-1].get("pid", 0) == ev.get("pid", 0)
                and stack[-1].get("tid", 0) == ev.get("tid", 0)
                and ev["ts"] + ev["dur"]
                <= stack[-1]["ts"] + stack[-1]["dur"] + 1e-6):
            stack.pop()
        (stack[-1]["children"] if stack else roots).append(ev)
        stack.append(ev)
    return roots
