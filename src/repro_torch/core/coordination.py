"""Coordination strategies and the discrete-event arrival queue.
Reference: ``src/repro/core/coordination.py`` (``CoordinationStrategy``,
``MaskStrategy``, ``FullSync``, ``BackupWorkers``, ``Timeout``, :84-232;
``encode_rng``, ``decode_rng`` and ``EventScheduler``, :387-464).

Pure numpy, so masks, iteration times and the serve trace replay the
reference bit for bit.

* **Mask strategies** (``kind == "mask"``) turn one iteration's worker
  arrival times into ``(mask over W workers, iteration wall time)``: the
  mask is data to the train step, and dropped workers still compute, as
  in the paper. ``FullSync`` waits for everyone, ``BackupWorkers(N, b)``
  takes the first N arrivals (Alg. 3/4), ``Timeout(d)`` everything within
  d of the first. Only the host ``select`` is ported: the chunked loop
  stacks per-step selections, and the traceable ``select_jax`` belongs to
  the device straggler backend (ROADMAP Queue 1 item 6).
* ``EventScheduler``: one ``latency.sample(rng, (W,))`` draw at
  construction, then one ``latency.sample(rng, (1,))`` draw per
  rescheduled source (the serve trace's arrival process).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.straggler import LatencyModel


# ---------------------------------------------------------------------------
# The protocol and the mask strategies
# ---------------------------------------------------------------------------


class CoordinationStrategy:
    """Base of every coordination regime. ``kind`` selects the trainer's
    execution mode; ``total_workers`` is the number of machines launched
    (N + b for backup workers)."""

    kind: str = ""
    name: str = ""
    total_workers: int


class MaskStrategy(CoordinationStrategy):
    """Synchronous regimes: arrival times -> (worker mask, step time)."""

    kind = "mask"

    def select(self, arrivals: np.ndarray) -> Tuple[np.ndarray, float]:
        """arrivals: [W] seconds -> (mask bool [W], iteration_time)."""
        raise NotImplementedError

    def effective_n(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FullSync(MaskStrategy):
    num_workers: int

    name = "full_sync"

    @property
    def total_workers(self) -> int:
        return self.num_workers

    def select(self, arrivals):
        mask = np.ones_like(arrivals, dtype=bool)
        return mask, float(arrivals.max())

    def effective_n(self) -> int:
        return self.num_workers


@dataclasses.dataclass(frozen=True)
class BackupWorkers(MaskStrategy):
    """Aggregate the first N of N+b arrivals (paper Alg. 3/4)."""

    num_workers: int          # N
    backups: int              # b

    name = "backup"

    @property
    def total_workers(self) -> int:
        return self.num_workers + self.backups

    def select(self, arrivals):
        n = self.num_workers
        order = np.argsort(arrivals, kind="stable")
        mask = np.zeros_like(arrivals, dtype=bool)
        mask[order[:n]] = True
        return mask, float(arrivals[order[n - 1]])

    def effective_n(self) -> int:
        return self.num_workers


@dataclasses.dataclass(frozen=True)
class Timeout(MaskStrategy):
    """Aggregate all gradients arriving within `deadline_s` of the first."""

    num_workers: int
    deadline_s: float

    name = "timeout"

    @property
    def total_workers(self) -> int:
        return self.num_workers

    def select(self, arrivals):
        t0 = arrivals.min()
        cutoff = t0 + self.deadline_s
        mask = arrivals <= cutoff
        return mask, float(min(arrivals.max(), cutoff))

    def effective_n(self) -> int:
        return self.num_workers     # varies per step; N is the upper bound


# ---------------------------------------------------------------------------
# The discrete-event queue
# ---------------------------------------------------------------------------


def encode_rng(rng: Optional[np.random.RandomState]) -> Optional[Dict]:
    """JSON-able snapshot of an MT19937 RandomState (checkpoint meta)."""
    if rng is None:
        return None
    key, pos, has_gauss, cached = rng.get_state()[1:]
    return {"key": [int(x) for x in key], "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def decode_rng(rng: np.random.RandomState, d: Dict) -> None:
    rng.set_state(("MT19937", np.array(d["key"], np.uint32), int(d["pos"]),
                   int(d["has_gauss"]), float(d["cached"])))


class EventScheduler:
    """Checkpointable discrete-event queue with a fixed RNG draw order."""

    def __init__(self, num_workers: int, latency: LatencyModel, seed: int):
        self.latency = latency
        self.rng = np.random.RandomState(seed)
        first = self.latency.sample(self.rng, (num_workers,))
        self.queue: List[Tuple[float, int]] = [
            (float(first[w]), w) for w in range(num_workers)]
        heapq.heapify(self.queue)
        # per-worker service-time multipliers applied AFTER sampling, so
        # the RNG draw order (the replay contract) is untouched
        self.slowdown: Dict[int, float] = {}

    def pop(self) -> Tuple[float, int]:
        return heapq.heappop(self.queue)

    def push(self, t: float, worker: int) -> None:
        """Reschedule `worker`'s next arrival after its current one at `t`."""
        dt = float(self.latency.sample(self.rng, (1,))[0])
        dt *= self.slowdown.get(worker, 1.0)
        heapq.heappush(self.queue, (t + dt, worker))

    def drop_worker(self, worker: int) -> None:
        """Failure injection: the worker's arrivals never come again."""
        self.queue = [e for e in self.queue if e[1] != worker]
        heapq.heapify(self.queue)

    def set_slowdown(self, worker: int, factor: float) -> None:
        """Transient slowdown spike (factor=1.0 restores health)."""
        if factor == 1.0:
            self.slowdown.pop(worker, None)
        else:
            self.slowdown[worker] = float(factor)

    def revive_worker(self, worker: int, t: float) -> None:
        """A restarted worker rejoins one fresh service time after ``t``."""
        dt = float(self.latency.sample(self.rng, (1,))[0])
        dt *= self.slowdown.get(worker, 1.0)
        heapq.heappush(self.queue, (float(t) + dt, worker))

    # -- checkpointable state -------------------------------------------------

    def state_dict(self) -> Dict:
        return {"queue": [[t, int(w)] for t, w in self.queue],
                "rng": encode_rng(self.rng),
                "slowdown": {str(w): f for w, f in self.slowdown.items()}}

    def load_state_dict(self, d: Dict) -> None:
        self.queue = [(float(t), int(w)) for t, w in d["queue"]]
        heapq.heapify(self.queue)
        decode_rng(self.rng, d["rng"])
        self.slowdown = {int(w): float(f)
                         for w, f in d.get("slowdown", {}).items()}
