"""Discrete-event arrival queue. Reference: ``src/repro/core/coordination.py``
(``encode_rng``, ``decode_rng`` and ``EventScheduler``, :387-464).

Pure numpy, copied so the serve trace replays bit for bit: one
``latency.sample(rng, (W,))`` draw at construction, then one
``latency.sample(rng, (1,))`` draw per rescheduled source. The
coordination strategies come with the training slice.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.straggler import LatencyModel


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
