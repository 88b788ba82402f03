"""Per-step worker masks and iteration times for the mask strategies.
Reference: ``src/repro/core/events.py`` (``StepEvent``, ``ChunkEvents``,
``StragglerSimulator`` with ``next_event`` / ``next_events``, and
``mean_iteration_time`` / ``estimate_time_to_converge``, :20-149).

Composes a latency model with a mask strategy: one ``StepEvent`` per
training step, deterministic in ``(seed, step)`` — the replay contract
that makes resume exact with no simulator state to persist. Masks,
iteration times and arrivals equal the reference's bit for bit, and the
chunked loop's ``next_events(k)`` equals k ``next_event()`` calls.
``estimate_time_to_converge`` composes the mean iteration time of each
(N, b) split with an iteration count per N: paper Fig. 6. Fault
injection's primitives act on the simulator: ``kill_worker`` (latency
+inf), ``revive_worker`` and ``set_slowdown`` (a latency multiplier
applied after sampling, so the RNG streams are untouched).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.coordination import BackupWorkers, MaskStrategy
from repro_torch.core.straggler import LatencyModel, PaperCalibrated


@dataclasses.dataclass
class StepEvent:
    step: int
    mask: np.ndarray          # [W] bool — workers whose gradients count
    iteration_time: float     # simulated seconds for this step
    arrivals: np.ndarray      # [W] raw latencies


@dataclasses.dataclass
class ChunkEvents:
    """K consecutive StepEvents stacked for one chunk of the fused loop."""

    start_step: int
    masks: np.ndarray         # [K, W] bool
    times: np.ndarray         # [K] f64 per-step iteration times
    arrivals: np.ndarray      # [K, W] raw latencies

    def __len__(self) -> int:
        return self.masks.shape[0]


class StragglerSimulator:
    """Yields one StepEvent per training step; deterministic in seed.
    ``dead`` workers never arrive (latency +inf); ``slowdown`` scales a
    worker's latencies."""

    def __init__(self, strategy: MaskStrategy,
                 latency: Optional[LatencyModel] = None,
                 seed: int = 0, start_step: int = 0):
        self.strategy = strategy
        self.latency = latency or PaperCalibrated()
        self.seed = seed
        self.dead = np.zeros(strategy.total_workers, dtype=bool)
        self.slowdown = np.ones(strategy.total_workers, dtype=np.float64)
        self._step = start_step

    def kill_worker(self, w: int) -> None:
        self.dead[w] = True

    def revive_worker(self, w: int) -> None:
        self.dead[w] = False

    def set_slowdown(self, w: int, factor: float) -> None:
        """Transient slowdown spike (factor=1.0 restores health)."""
        self.slowdown[w] = float(factor)

    @property
    def step(self) -> int:
        return self._step

    def reset_to_step(self, step: int) -> None:
        """Align the simulator with a restored trainer step."""
        self._step = int(step)

    @property
    def alive(self) -> int:
        return int((~self.dead).sum())

    def _raw_arrivals(self, step: int) -> np.ndarray:
        """Per-step latencies, deterministic in (seed, step)."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step)
                                    % (2 ** 31 - 1))
        return self.latency.sample(rng, (self.strategy.total_workers,))

    def next_event(self) -> StepEvent:
        arrivals = np.where(self.dead, np.inf,
                            self._raw_arrivals(self._step) * self.slowdown)
        mask, t = self.strategy.select(arrivals)
        mask = mask & ~self.dead
        ev = StepEvent(self._step, mask, t, arrivals)
        self._step += 1
        return ev

    def next_events(self, k: int) -> ChunkEvents:
        """The next k events stacked: k ``next_event()`` calls (a stateful
        strategy folds each row in before the next row's selection, as in
        the reference's ``select_batch`` fallback)."""
        start = self._step
        evs = [self.next_event() for _ in range(k)]
        return ChunkEvents(start, np.stack([e.mask for e in evs]),
                           np.array([e.iteration_time for e in evs],
                                    np.float64),
                           np.stack([e.arrivals for e in evs]))

def mean_iteration_time(strategy: MaskStrategy, latency: LatencyModel,
                        iters: int = 1000, seed: int = 0) -> float:
    """The mean simulated iteration time of ``strategy`` over ``iters``
    steps of a fresh simulator."""
    sim = StragglerSimulator(strategy, latency, seed)
    return float(np.mean([sim.next_event().iteration_time
                          for _ in range(iters)]))


def estimate_time_to_converge(n_values: np.ndarray,
                              iters_to_converge: np.ndarray,
                              total_machines: int, latency: LatencyModel,
                              sim_iters: int = 2000, seed: int = 0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Paper Fig. 6: for each N (with b = total - N), the estimated time
    to converge = iterations(N) x the mean iteration time of
    ``BackupWorkers(N, b)``. Returns (times, mean step times), each
    ``[len(n_values)]``."""
    times, step_times = [], []
    for n, it in zip(n_values, iters_to_converge):
        st = mean_iteration_time(
            BackupWorkers(int(n), total_machines - int(n)), latency,
            sim_iters, seed)
        step_times.append(st)
        times.append(st * it)
    return np.array(times), np.array(step_times)
