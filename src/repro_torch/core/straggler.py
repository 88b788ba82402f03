"""Worker-latency models and straggler statistics (paper §3.1, Figs. 3/4).
Reference: ``src/repro/core/straggler.py``.

Per-worker iteration latency is a calibrated mixture:

    T = base + Exp(jitter)                 (healthy worker)
    T = base + Exp(jitter) + Exp(tail)     (w.p. p_tail)

which reproduces the paper's flat-then-exponential order-statistic curve.
All sampling is host-side numpy with the reference's draw order, so the
port's arrival times equal the reference's bit for bit; the serve trace's
arrival process (``serve/trace.py``) subclasses ``LatencyModel`` too.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


class LatencyModel:
    """sample(rng, (iters, workers)) -> seconds array."""

    def sample(self, rng: np.random.RandomState, shape: Tuple[int, ...]) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PaperCalibrated(LatencyModel):
    """Calibrated to Figs. 3/4: ~1.4s median, exponential tail to ~310s."""

    base: float = 1.3
    jitter: float = 0.12
    p_tail: float = 0.015
    tail: float = 25.0
    cap: float = 310.0

    def sample(self, rng, shape):
        t = self.base + rng.exponential(self.jitter, size=shape)
        straggle = rng.rand(*shape) < self.p_tail
        t = t + straggle * rng.exponential(self.tail, size=shape)
        return np.minimum(t, self.cap)


@dataclasses.dataclass(frozen=True)
class LogNormal(LatencyModel):
    median: float = 1.4
    sigma: float = 0.15

    def sample(self, rng, shape):
        return self.median * np.exp(self.sigma * rng.randn(*shape))


@dataclasses.dataclass(frozen=True)
class DeterministicStragglers(LatencyModel):
    """Specific workers are consistently slow (failing/contended hardware)."""

    base: float = 1.4
    jitter: float = 0.1
    slow_workers: Tuple[int, ...] = ()
    slowdown: float = 5.0

    def sample(self, rng, shape):
        t = self.base + rng.exponential(self.jitter, size=shape)
        for w in self.slow_workers:
            t[..., w] *= self.slowdown
        return t


@dataclasses.dataclass(frozen=True)
class Uniform(LatencyModel):
    lo: float = 1.0
    hi: float = 2.0

    def sample(self, rng, shape):
        return rng.uniform(self.lo, self.hi, size=shape)


# ---------------------------------------------------------------------------
# Order statistics (Figs. 3 and 4)
# ---------------------------------------------------------------------------


def arrival_order_stats(latencies: np.ndarray) -> np.ndarray:
    """latencies: [iters, workers] -> sorted arrival times per iteration."""
    return np.sort(latencies, axis=-1)


def mean_median_time_to_k(latencies: np.ndarray):
    """Fig. 4: mean and median (over iterations) of time-to-k, per k."""
    sorted_t = arrival_order_stats(latencies)
    return sorted_t.mean(axis=0), np.median(sorted_t, axis=0)


def cdf_of_time_to_k(latencies: np.ndarray, k: int, grid: np.ndarray):
    """Fig. 3: P(time to collect k-th gradient <= t) over `grid`."""
    tk = arrival_order_stats(latencies)[:, k - 1]
    return np.array([(tk <= t).mean() for t in grid])
