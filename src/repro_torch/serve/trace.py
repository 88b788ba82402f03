"""Open-loop arrival traces: seeded, replayable request streams.
Reference: ``src/repro/serve/trace.py`` (unchanged numpy).

Arrivals come from ``sources`` independent exponential inter-arrival
processes merged on one :class:`~repro_torch.core.coordination.
EventScheduler` heap, so a trace is a pure function of its
:class:`TraceConfig` and replays bit-identically to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.coordination import EventScheduler
from repro_torch.core.straggler import LatencyModel


@dataclasses.dataclass(frozen=True)
class ExpInterarrival(LatencyModel):
    """Exponential inter-arrival times (one Poisson source)."""

    mean: float = 1.0

    def sample(self, rng, shape):
        return rng.exponential(self.mean, size=shape)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request from the trace."""

    rid: int
    arrival: float                 # seconds (or virtual units) from t=0
    prompt: np.ndarray             # [prompt_len] int32 token ids
    max_new: int                   # token budget incl. the prefill sample

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """A replayable open-loop trace is a pure function of this config."""

    num_requests: int = 32
    rate: float = 8.0              # aggregate arrivals per time unit
    sources: int = 4               # independent Poisson arrival sources
    prompt_len_min: int = 4
    prompt_len_max: int = 24
    max_new_min: int = 4
    max_new_max: int = 24
    vocab: int = 256
    seed: int = 0


def make_trace(tc: TraceConfig) -> List[Request]:
    """Materialize the trace: ``num_requests`` requests sorted by arrival."""
    if tc.rate <= 0:
        raise ValueError(f"rate must be > 0 (got {tc.rate})")
    sources = max(1, min(tc.sources, tc.num_requests))
    sched = EventScheduler(sources, ExpInterarrival(sources / tc.rate),
                           seed=tc.seed)
    rng = np.random.RandomState(tc.seed + 1)
    out: List[Request] = []
    for rid in range(tc.num_requests):
        t, src = sched.pop()
        sched.push(t, src)
        plen = int(rng.randint(tc.prompt_len_min, tc.prompt_len_max + 1))
        max_new = int(rng.randint(tc.max_new_min, tc.max_new_max + 1))
        prompt = rng.randint(0, tc.vocab, size=plen).astype(np.int32)
        out.append(Request(rid, float(t), prompt, max_new))
    out.sort(key=lambda r: (r.arrival, r.rid))
    return out


def bucket_for(length: int, *, floor: int, cap: int = 1 << 30) -> int:
    """Power-of-two padding bucket: one prefill shape per bucket."""
    b = floor
    while b < length:
        b *= 2
    if b > cap:
        raise ValueError(f"length {length} exceeds the bucket cap {cap}")
    return b


def trace_buckets(trace: List[Request], *, floor: int,
                  cap: int) -> Tuple[int, ...]:
    """Distinct prompt buckets a trace will run (ascending)."""
    return tuple(sorted({bucket_for(r.prompt_len, floor=floor, cap=cap)
                         for r in trace}))
