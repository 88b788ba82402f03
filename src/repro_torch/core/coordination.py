"""Coordination strategies, the discrete-event arrival queue and the event
engine. Reference: ``src/repro/core/coordination.py``
(``CoordinationStrategy``, ``MaskStrategy``, ``FullSync``,
``BackupWorkers``, ``Timeout``, ``DynamicBackup``, :84-360; ``Arrival``,
``ReadyUpdate``,
``encode_rng``, ``decode_rng``, ``EventScheduler``, ``SerialScheduler``,
:367-491; ``EventStrategy``, ``Async``, ``SoftSync``,
``staleness_schedule``, ``Staleness``, :493-753; ``PlanVerdict``,
``EventPlan``, ``plan_events``, :755-859; ``VersionedReads``,
``AsyncResult``, ``run_events``, ``make_grad_fn``, ``make_update_fn``,
:862-1055).

* **Mask strategies** (``kind == "mask"``) turn one iteration's worker
  arrival times into ``(mask over W workers, iteration wall time)``: the
  mask is data to the train step, and dropped workers still compute, as
  in the paper. ``FullSync`` waits for everyone, ``BackupWorkers(N, b)``
  takes the first N arrivals (Alg. 3/4), ``Timeout(d)`` everything within
  d of the first, ``DynamicBackup`` adapts N online (arXiv:2102.06280).
  ``select`` is the host rule (the chunked loop stacks a chunk's
  selections, row by row); ``select_device`` is the reference's
  ``select_jax`` for a whole chunk at once, on the trainer's device, for
  the device straggler backend (``BackupWorkers`` sorts stably, as
  ``jnp.argsort`` does, so ties and dead ``+inf`` rows pick the workers
  ``select`` picks). ``DynamicBackup`` is stateful and selects on the
  host only (``device_select_supported = False``).
* **Event strategies** (``kind == "event"``): the scheduler pops gradient
  arrivals one at a time and the strategy decides, per arrival, whether a
  parameter-server (PS) update applies. ``Async`` (paper Alg. 1/2) applies
  every arrival; ``SoftSync(c)`` averages every c arrivals; ``Staleness``
  is the paper's §2.1 rig, serial SGD applying the gradient of tau steps
  ago. ``EventScheduler``: one ``latency.sample(rng, (W,))`` draw at
  construction, then one ``latency.sample(rng, (1,))`` draw per
  rescheduled worker; ``SerialScheduler`` is the rig's clock.

The host half (schedulers, verdicts, ``plan_events``, the staleness
schedule and every RNG draw) is numpy and equals the reference bit for
bit. The device half works on dicts of tensors keyed like the model's
parameters, **in place**: the optimizer and the EMA update the live
parameters where they lie. The reference stores a worker's read copy as a
reference to the (immutable) parameter tree; here that reference would
move with every update, so a read copy is always a clone in a row of its
own (``VersionedReads``, and the trainer's stacked ``[W, ...]`` rows).

``on_arrival_scan`` is the device half of the chunked protocol. The
reference selects the branch with ``lax.cond(row["apply"], ...)``; here
``row["apply"]`` is the host's Python bool, which picks one of two
captured CUDA graphs (an arrival that applies, one that only buffers),
and the ring slots ``row["slot_w"]`` / ``row["slot_r"]`` are ``[1]``
int64 device tensors, copied into the graph's buffers per arrival.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ema as ema_lib
from repro_torch.core.straggler import LatencyModel, PaperCalibrated
from repro_torch.optim import optimizers as opt_lib

Named = Dict[str, torch.Tensor]


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
    """Synchronous regimes: arrival times -> (worker mask, step time).

    ``spmd_supported``: True (the default) when the strategy's masks are
    pure per-step data, so the spmd engine runs it unchanged
    (``registry.supports_spmd``); a plugin opts out by setting it False.
    """

    kind = "mask"
    spmd_supported = True

    def select(self, arrivals: np.ndarray) -> Tuple[np.ndarray, float]:
        """arrivals: [W] seconds -> (mask bool [W], iteration_time)."""
        raise NotImplementedError

    def select_device(self, arrivals: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[K, W] f32 seconds on a device -> (masks bool [K, W], times f32
        [K]) on that device, with no host sync."""
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

    def select_device(self, arrivals):
        return (torch.ones_like(arrivals, dtype=torch.bool),
                torch.amax(arrivals, dim=-1))

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

    def select_device(self, arrivals):
        n = self.num_workers
        order = torch.argsort(arrivals, dim=-1, stable=True)
        masks = torch.zeros_like(arrivals, dtype=torch.bool).scatter_(
            -1, order[:, :n], True)
        return masks, torch.gather(arrivals, -1, order[:, n - 1:n])[:, 0]

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

    def select_device(self, arrivals):
        cutoff = torch.amin(arrivals, dim=-1) + self.deadline_s
        return (arrivals <= cutoff[:, None],
                torch.minimum(torch.amax(arrivals, dim=-1), cutoff))

    def effective_n(self) -> int:
        return self.num_workers     # varies per step; N is the upper bound


@dataclasses.dataclass
class DynamicBackup(MaskStrategy):
    """Adaptive backup cutoff (Dynamic Backup Workers, arXiv:2102.06280).

    The backup-worker protocol with the cutoff n re-estimated online:
    after every step the sorted arrival row joins a window of the last
    ``window`` steps, and n becomes the argmax of ``n / E[t_(n)]``
    (gradients aggregated per simulated second), E[t_(n)] the window's
    mean n-th order statistic. Dead workers arrive at +inf, so every n
    beyond the live count has zero throughput. ``min_workers`` floors n.

    Stateful across steps: ``state_dict`` / ``load_state_dict`` travel in
    the checkpoint's metadata, and selection stays on the host where the
    window lives (``device_select_supported = False``). ``min_alive`` is
    the trainer's liveness floor. ``latency_source='measured'`` adapts
    from the trainer's fenced wall-clock rows (``observe_measured``)
    instead of the simulated arrivals ``select`` sees.
    """

    num_workers: int          # initial n (= paper's N)
    backups: int              # b — total_workers = N + b
    window: int = 32
    min_workers: int = 0      # floor for the adapted n (0 -> 1)
    latency_source: str = "sim"   # sim | measured

    name = "dynamic_backup"
    device_select_supported = False

    def __post_init__(self):
        if self.latency_source not in ("sim", "measured"):
            raise ValueError(
                f"latency_source must be 'sim' or 'measured' "
                f"(got {self.latency_source!r})")
        self.n = int(self.num_workers)
        self.history: List[np.ndarray] = []   # sorted arrival rows [W]
        self.measured = None
        if self.latency_source == "measured":
            from repro_torch.obs.latency import EmpiricalLatencyModel
            self.measured = EmpiricalLatencyModel(
                self.total_workers, window=max(self.window * 8, 64))

    @property
    def total_workers(self) -> int:
        return self.num_workers + self.backups

    @property
    def min_alive(self) -> int:
        return max(self.min_workers, 1)

    def select(self, arrivals):
        # clamp to the live count: right after a crash (before the window
        # has seen it) the adapted n may exceed the finite arrivals
        n = max(1, min(self.n, int(np.isfinite(arrivals).sum()) or 1))
        order = np.argsort(arrivals, kind="stable")
        mask = np.zeros_like(arrivals, dtype=bool)
        mask[order[:n]] = True
        t = float(arrivals[order[n - 1]])
        if self.latency_source == "sim":
            self._observe(arrivals)
        return mask, t

    # a chunk's rows are selected one by one (StragglerSimulator.
    # next_events): each folds into the window before the next's cutoff

    def effective_n(self) -> int:
        return self.n

    def _observe(self, arrivals: np.ndarray) -> None:
        self.history.append(np.sort(np.asarray(arrivals, np.float64)))
        if len(self.history) > self.window:
            self.history.pop(0)
        h = np.stack(self.history)                   # [H, W] sorted rows
        with np.errstate(invalid="ignore"):
            mean_t = h.mean(axis=0)                  # E[t_(n)], n = 1..W
        ns = np.arange(1, h.shape[1] + 1, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            throughput = np.where(np.isfinite(mean_t), ns / mean_t, 0.0)
        floor = max(self.min_workers, 1)
        throughput[:floor - 1] = -np.inf
        self.n = int(np.argmax(throughput)) + 1

    def observe_measured(self, times: np.ndarray) -> None:
        """Fold one measured per-worker step-time row (seconds; +inf for
        dead workers): into the adaptation window and the
        :class:`~repro_torch.obs.latency.EmpiricalLatencyModel`."""
        if self.latency_source != "measured":
            raise RuntimeError(
                "observe_measured is only valid with "
                "latency_source='measured'")
        times = np.asarray(times, np.float64)
        self.measured.record(times)
        self._observe(times)

    # -- checkpointable state (saved as manifest "strategy_state") ----------

    def state_dict(self) -> Dict:
        d = {"n": int(self.n),
             "history": [[float(x) for x in row] for row in self.history],
             "latency_source": self.latency_source}
        if self.measured is not None:
            d["measured"] = self.measured.state_dict()
        return d

    def load_state_dict(self, d: Dict) -> None:
        self.n = int(d["n"])
        self.history = [np.asarray(row, np.float64) for row in d["history"]]
        if self.measured is not None and d.get("measured") is not None:
            self.measured.load_state_dict(d["measured"])


# ---------------------------------------------------------------------------
# Event side: scheduler + strategies
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Arrival:
    """One gradient arrival popped from the event scheduler."""

    index: int          # arrival counter (0, 1, 2, ...)
    worker: int
    time: float         # simulated seconds (arrival index for serial rigs)
    staleness: int      # updates applied since this worker read its params
    version: int        # PS update count at arrival time


@dataclasses.dataclass
class ReadyUpdate:
    """on_arrival's verdict when a PS update should apply now."""

    grads: Named        # aggregated gradients to apply
    staleness: float    # staleness of this update (mean over contributors)
    selected: int       # gradients aggregated into this update


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


class SerialScheduler:
    """Degenerate clock for serial rigs (the §2.1 staleness experiment):
    one logical worker arriving at t = 0, 1, 2, ..."""

    def __init__(self):
        self.t = 0

    def pop(self) -> Tuple[float, int]:
        t = self.t
        self.t += 1
        return float(t), 0

    def push(self, t: float, worker: int) -> None:
        pass

    def drop_worker(self, worker: int) -> None:
        raise ValueError("serial rigs have a single logical worker; "
                         "failure injection does not apply")

    def state_dict(self) -> Dict:
        return {"t": int(self.t)}

    def load_state_dict(self, d: Dict) -> None:
        self.t = int(d["t"])


class EventStrategy(CoordinationStrategy):
    """Asynchronous regimes: a per-arrival apply-or-buffer policy.

    ``uses_clock``          False for serial rigs (SerialScheduler).
    ``stals_per_arrival``   AsyncResult.staleness records one entry per
                            arrival (async/softsync) or per update (rig).
    ``losses_per_arrival``  likewise for AsyncResult.losses.
    ``scan_supported``      True when the strategy implements the chunked
                            plan/scan protocol below.

    The chunked protocol splits ``on_arrival`` into a gradient-free host
    half and a device half:

    * ``init_plan_state(seed)`` / ``plan_arrival(plan_state, arrival)``
      run on the host while a chunk is planned; ``plan_arrival`` makes
      the same apply-or-buffer decision ``on_arrival`` would (same
      strategy-RNG draw order) and returns a :class:`PlanVerdict`.
    * ``init_scan_state(params)`` / ``on_arrival_scan(aux, grads, row)``
      run on the device per arrival. ``aux`` is the strategy's carry
      (``{name: tensor}``, updated in place); ``row`` holds ``apply`` (a
      host bool), ``slot_w`` and ``slot_r`` (``[1]`` int64 tensors).
      Returns the gradients to apply when ``row["apply"]``, else None.
    """

    kind = "event"
    uses_clock = True
    stals_per_arrival = True
    losses_per_arrival = False
    scan_supported = False

    def init_state(self, seed: int = 0) -> Any:
        """Fresh mutable per-run state (buffers, strategy-local RNG)."""
        return None

    def on_arrival(self, state: Any, grads: Named,
                   arrival: Arrival) -> Optional[ReadyUpdate]:
        """Decide what the arrival of ``grads`` does to the PS."""
        raise NotImplementedError

    def init_plan_state(self, seed: int = 0) -> Any:
        """Gradient-free twin of ``init_state`` for the chunk planner."""
        return None

    def plan_arrival(self, plan_state: Any, arrival: Arrival) -> "PlanVerdict":
        raise NotImplementedError

    def init_scan_state(self, params: Named) -> Named:
        """The device carry of the chunked path (default: none)."""
        return {}

    def on_arrival_scan(self, aux: Named, grads: Named,
                        row: Dict) -> Optional[Named]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Async(EventStrategy):
    """Paper Alg. 1/2: every arrival applies immediately (staleness ~ N)."""

    num_workers: int

    name = "async"
    scan_supported = True

    @property
    def total_workers(self) -> int:
        return self.num_workers

    def on_arrival(self, state, grads, arrival):
        return ReadyUpdate(grads, float(arrival.staleness), 1)

    def plan_arrival(self, plan_state, arrival):
        return PlanVerdict(True, float(arrival.staleness), 1)

    def on_arrival_scan(self, aux, grads, row):
        return grads if row["apply"] else None


@dataclasses.dataclass
class _SoftSyncState:
    pending: List[Named] = dataclasses.field(default_factory=list)
    pending_stals: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _SoftSyncPlan:
    """Host half of the softsync window: staleness tags only, no grads."""

    pending_stals: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class SoftSync(EventStrategy):
    """Zhang et al. (2015b): average every c arrivals, then apply. The
    window sums in the gradients' own dtype (the parameters', bf16 at full
    width), in arrival order, as the reference does."""

    num_workers: int
    c: int = 1

    name = "softsync"
    scan_supported = True

    @property
    def total_workers(self) -> int:
        return self.num_workers

    def init_state(self, seed: int = 0) -> _SoftSyncState:
        return _SoftSyncState()

    def on_arrival(self, state, grads, arrival):
        state.pending.append(grads)
        state.pending_stals.append(arrival.staleness)
        if len(state.pending) < self.c:
            return None
        gs = state.pending
        mean_g = {k: sum((g[k] for g in gs[1:]), gs[0][k]) / len(gs)
                  for k in gs[0]}
        stal = float(np.mean(state.pending_stals))
        n = len(gs)
        state.pending = []
        state.pending_stals = []
        return ReadyUpdate(mean_g, stal, n)

    def init_plan_state(self, seed: int = 0) -> _SoftSyncPlan:
        return _SoftSyncPlan()

    def plan_arrival(self, plan_state, arrival):
        plan_state.pending_stals.append(arrival.staleness)
        if len(plan_state.pending_stals) < self.c:
            return PlanVerdict(False)
        stal = float(np.mean(plan_state.pending_stals))
        n = len(plan_state.pending_stals)
        plan_state.pending_stals = []
        return PlanVerdict(True, stal, n)

    def init_scan_state(self, params):
        # the device window: a running gradient sum in the params' dtype
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def on_arrival_scan(self, aux, grads, row):
        if not row["apply"]:
            for k, g in grads.items():
                aux[k].add_(g)
            return None
        agg = {k: (aux[k] + g) / self.c for k, g in grads.items()}
        for a in aux.values():
            a.zero_()
        return agg


def staleness_schedule(step: int, target: int, ramp_steps: int) -> int:
    """Paper trick: slowly increase staleness over the first epochs."""
    if target <= 0 or ramp_steps <= 0:
        return target
    return int(min(target, np.ceil(target * (step + 1) / ramp_steps)))


@dataclasses.dataclass
class _StalenessState:
    rng: np.random.RandomState
    buffer: List[Tuple[int, Named]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _StalenessPlan:
    """Host half of the old-gradient FIFO: (version tag, ring slot) pairs.
    Slots are assigned round-robin (``writes % capacity``), safe because
    the FIFO never holds more than ``scan_capacity`` live entries."""

    rng: np.random.RandomState
    fifo: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    writes: int = 0


@dataclasses.dataclass(frozen=True)
class Staleness(EventStrategy):
    """§2.1 controlled rig: serial SGD applying the gradient computed
    ``tau`` steps ago (old-gradient buffer), tau ramped over
    ``ramp_steps`` with optional +-jitter. tau=0 is serial SGD."""

    tau: int
    ramp_steps: int = 0
    jitter: int = 0

    name = "staleness"
    uses_clock = False
    stals_per_arrival = False
    losses_per_arrival = True
    scan_supported = True

    @property
    def total_workers(self) -> int:
        return 1

    @property
    def scan_capacity(self) -> int:
        """Ring size: the FIFO holds at most tau + jitter entries after an
        append (apply pops once len exceeds tau)."""
        return max(1, self.tau + self.jitter + 1)

    def init_state(self, seed: int = 0) -> _StalenessState:
        return _StalenessState(rng=np.random.RandomState(seed))

    def _effective_tau(self, rng: np.random.RandomState,
                       arrival: Arrival) -> int:
        """The ramped + jittered tau of this arrival, shared by the
        per-arrival and the plan paths (same schedule, same draws)."""
        tau = staleness_schedule(arrival.index, self.tau, self.ramp_steps)
        if self.jitter > 0 and tau > 0:
            tau = max(0, tau + int(rng.randint(-self.jitter,
                                               self.jitter + 1)))
        return tau

    def on_arrival(self, state, grads, arrival):
        tau = self._effective_tau(state.rng, arrival)
        state.buffer.append((arrival.version, grads))
        # apply the oldest buffered gradient once it is tau steps old;
        # a growing tau pauses updates while the buffer fills
        if len(state.buffer) <= tau:
            return None
        computed_at, g = state.buffer.pop(0)
        return ReadyUpdate(g, float(arrival.version - computed_at), 1)

    def init_plan_state(self, seed: int = 0) -> _StalenessPlan:
        return _StalenessPlan(rng=np.random.RandomState(seed))

    def plan_arrival(self, plan_state, arrival):
        tau = self._effective_tau(plan_state.rng, arrival)
        slot = plan_state.writes % self.scan_capacity
        plan_state.writes += 1
        plan_state.fifo.append((arrival.version, slot))
        assert len(plan_state.fifo) <= self.scan_capacity
        if len(plan_state.fifo) <= tau:
            return PlanVerdict(False, slot_w=slot)
        tag, read_slot = plan_state.fifo.pop(0)
        return PlanVerdict(True, float(arrival.version - tag), 1,
                           slot_w=slot, slot_r=read_slot)

    def init_scan_state(self, params):
        c = self.scan_capacity
        return {k: torch.zeros((c,) + tuple(p.shape), dtype=p.dtype,
                               device=p.device)
                for k, p in params.items()}

    def on_arrival_scan(self, aux, grads, row):
        for k, g in grads.items():
            aux[k].index_copy_(0, row["slot_w"], g.unsqueeze(0))
        if not row["apply"]:
            return None
        return {k: r.index_select(0, row["slot_r"])[0]
                for k, r in aux.items()}


# ---------------------------------------------------------------------------
# The chunked event engine: host plan for the device loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanVerdict:
    """``plan_arrival``'s gradient-free twin of ``on_arrival``'s verdict."""

    apply: bool
    staleness: float = 0.0
    selected: int = 0
    slot_w: int = 0          # staleness ring slot written by this arrival
    slot_r: int = 0          # ring slot holding the gradient applied


@dataclasses.dataclass
class EventPlan:
    """One chunk of K arrivals, host-precomputed into flat arrays: which
    arrivals apply a PS update, each update's lr-schedule step, the ring
    slots and the staleness bookkeeping, all independent of the
    gradients' values."""

    worker: np.ndarray             # [K] arrival worker ids
    draw: np.ndarray               # [K] per-worker batch draw index
    time: np.ndarray               # [K] arrival clock (simulated s)
    apply: np.ndarray              # [K] bool: a PS update applies here
    step: np.ndarray               # [K] PS version at arrival (update step)
    arrival_staleness: np.ndarray  # [K] staleness of each arrival
    update_staleness: np.ndarray   # [K] staleness of the applied update
    selected: np.ndarray           # [K] gradients aggregated per update
    slot_w: np.ndarray             # [K] ring write slot (staleness rig)
    slot_r: np.ndarray             # [K] ring read slot (staleness rig)
    updates: int                   # number of True entries in `apply`

    def __len__(self) -> int:
        return len(self.worker)

    def rows(self, device) -> Named:
        """The per-arrival device indices as ``[K]`` int64 tensors, one
        copy each (through pinned memory on the card); ``apply`` stays on
        the host, where it picks each arrival's branch."""
        out = {}
        for name in ("worker", "slot_w", "slot_r"):
            t = torch.from_numpy(getattr(self, name).astype(np.int64))
            if torch.device(device).type == "cuda":
                t = t.pin_memory()
            out[name] = t.to(device, non_blocking=True)
        return out


def plan_events(strategy: EventStrategy, sched, plan_state: Any,
                read_version: np.ndarray, draws: np.ndarray, *,
                version0: int, arrival0: int, num_updates: int) -> EventPlan:
    """Pop arrivals from ``sched`` until ``num_updates`` PS updates are
    planned: ``run_events``' control flow without the gradient math (same
    pop/push RNG discipline, same bookkeeping). Mutates ``sched``,
    ``plan_state``, ``read_version`` and ``draws`` in place. The plan's
    last arrival applies its last update, so chunk boundaries land on PS
    update counts and softsync holds no pending gradients between
    chunks."""
    cols: Dict[str, list] = {k: [] for k in
                             ("worker", "draw", "time", "apply", "step",
                              "astal", "ustal", "sel", "sw", "sr")}
    version, arrival, updates = int(version0), int(arrival0), 0
    while updates < num_updates:
        t, wk = sched.pop()
        ar = Arrival(index=arrival, worker=wk, time=float(t),
                     staleness=int(version - read_version[wk]),
                     version=version)
        arrival += 1
        v = strategy.plan_arrival(plan_state, ar)
        cols["worker"].append(wk)
        cols["draw"].append(int(draws[wk]))
        draws[wk] += 1
        cols["time"].append(float(t))
        cols["apply"].append(bool(v.apply))
        cols["step"].append(version)
        cols["astal"].append(ar.staleness)
        cols["ustal"].append(float(v.staleness))
        cols["sel"].append(int(v.selected))
        cols["sw"].append(int(v.slot_w))
        cols["sr"].append(int(v.slot_r))
        if v.apply:
            version += 1
            updates += 1
        read_version[wk] = version
        sched.push(t, wk)
    return EventPlan(
        worker=np.asarray(cols["worker"], np.int32),
        draw=np.asarray(cols["draw"], np.int64),
        time=np.asarray(cols["time"], np.float64),
        apply=np.asarray(cols["apply"], bool),
        step=np.asarray(cols["step"], np.int32),
        arrival_staleness=np.asarray(cols["astal"], np.int64),
        update_staleness=np.asarray(cols["ustal"], np.float64),
        selected=np.asarray(cols["sel"], np.int64),
        slot_w=np.asarray(cols["sw"], np.int32),
        slot_r=np.asarray(cols["sr"], np.int32),
        updates=updates)


# ---------------------------------------------------------------------------
# The functional event engine
# ---------------------------------------------------------------------------


class VersionedReads:
    """Per-worker read-parameter copies, one per distinct PS version.

    Every worker whose read version is v reads the one copy of version v,
    and a copy is kept only while some worker holds its version (the
    reference's invariant). The reference keeps references to immutable
    trees; the port's parameters change in place, so ``write`` clones the
    parameters into a row of its own. A released row is reused, so at
    most ``num_workers`` rows ever exist."""

    def __init__(self, params0: Named, num_workers: int):
        self.version = np.zeros(num_workers, dtype=np.int64)
        # every row has params0's shapes, dtypes and device
        self._like = {k: (p.shape, p.dtype, p.device)
                      for k, p in params0.items()}
        self._free: List[Named] = []
        self._trees: Dict[int, Named] = {0: self._copy(params0)}
        self._readers: Dict[int, int] = {0: num_workers}

    def _copy(self, params: Mapping[str, torch.Tensor]) -> Named:
        row = self._free.pop() if self._free else {
            k: torch.empty(s, dtype=dt, device=dev)
            for k, (s, dt, dev) in self._like.items()}
        with torch.no_grad():
            for k, p in params.items():
                row[k].copy_(p)
        return row

    def read(self, worker: int) -> Named:
        return self._trees[int(self.version[worker])]

    def write(self, worker: int, params: Named, version: int) -> None:
        old, new = int(self.version[worker]), int(version)
        if old == new:          # params cannot change without an update
            return
        self._readers[old] -= 1
        if not self._readers[old]:
            self._free.append(self._trees.pop(old))
            del self._readers[old]
        self.version[worker] = new
        if new in self._readers:
            self._readers[new] += 1
        else:
            self._trees[new] = self._copy(params)
            self._readers[new] = 1

    def load(self, versions, tree_of: Callable[[int], Named]) -> None:
        """Set every worker's read version (``versions[w]``) and its copy,
        ``tree_of(w)`` for the first worker holding each version."""
        for v in list(self._trees):
            self._free.append(self._trees.pop(v))
        self._readers.clear()
        self.version[:] = np.asarray(versions, np.int64)
        for w, v in enumerate(self.version.tolist()):
            if v in self._readers:
                self._readers[v] += 1
            else:
                self._trees[v] = self._copy(tree_of(w))
                self._readers[v] = 1

    @property
    def distinct_versions(self) -> int:
        return len(self._trees)


@dataclasses.dataclass
class AsyncResult:
    params: Named
    ema: Named
    losses: np.ndarray            # loss at each PS update (or arrival)
    staleness: np.ndarray         # staleness of each applied gradient
    sim_time: np.ndarray          # wall-clock (simulated s) of each update
    updates: int


def run_events(strategy: EventStrategy, grad_fn: Callable,
               update_fn: Callable, params0: Named,
               batch_fn: Callable[[int, int], Dict], num_updates: int,
               latency: Optional[LatencyModel] = None, seed: int = 0,
               ema_decay: float = 0.0,
               init_opt_state: Optional[Callable] = None) -> AsyncResult:
    """Drive an event strategy to ``num_updates`` PS updates.

    grad_fn(params, batch) -> (loss, grads);
    update_fn(params, opt_state, grads, step) updates params and
      opt_state in place (``make_update_fn``); step drives the lr
      schedule;
    batch_fn(worker, draw_index) -> batch.

    ``params0`` is left as it is: the run's parameters are a clone of it.
    ``init_opt_state(params) -> opt_state`` defaults to
    ``update_fn.init_opt_state``; with neither, opt_state is None. Same
    scheduler draw order, heap discipline and read-after-update copy
    semantics as the reference, so the update/staleness sequence is its.
    """
    w = strategy.total_workers
    if strategy.uses_clock:
        sched = EventScheduler(w, latency or PaperCalibrated(), seed)
    else:
        sched = SerialScheduler()
    state = strategy.init_state(seed)
    with torch.no_grad():
        params = {k: p.detach().clone() for k, p in params0.items()}
    if init_opt_state is None:
        init_opt_state = getattr(update_fn, "init_opt_state", None)
    opt_state = init_opt_state(params) if init_opt_state else None
    ema_state = ema_lib.init(params.items()) if ema_decay > 0 else None

    reads = VersionedReads(params, w)
    draws = np.zeros(w, dtype=np.int64)

    losses, stals, times = [], [], []
    version = 0
    arrival_index = 0
    while version < num_updates:
        t, wk = sched.pop()
        batch = batch_fn(wk, int(draws[wk]))
        draws[wk] += 1
        loss, grads = grad_fn(reads.read(wk), batch)
        arrival = Arrival(index=arrival_index, worker=wk, time=t,
                          staleness=int(version - reads.version[wk]),
                          version=version)
        arrival_index += 1
        if strategy.stals_per_arrival:
            stals.append(arrival.staleness)
        if strategy.losses_per_arrival:
            losses.append(float(loss))
        ready = strategy.on_arrival(state, grads, arrival)
        if ready is not None:
            update_fn(params, opt_state, ready.grads, version)
            if ema_state is not None:
                ema_lib.update(ema_state, params.items(), ema_decay)
            if not strategy.stals_per_arrival:
                stals.append(int(ready.staleness))
            if not strategy.losses_per_arrival:
                losses.append(float(loss))
            times.append(t)
            version += 1
        # the worker reads the fresh params and starts its next mini-batch
        reads.write(wk, params, version)
        sched.push(t, wk)

    sim_time = (np.arange(len(losses), dtype=np.float64)
                if strategy.losses_per_arrival else np.array(times))
    return AsyncResult(params=params,
                       ema=ema_state if ema_state is not None else params,
                       losses=np.array(losses), staleness=np.array(stals),
                       sim_time=sim_time, updates=version)


# ---------------------------------------------------------------------------
# Trainer-side factories (shared by the trainer and the parity tests)
# ---------------------------------------------------------------------------


def make_grad_fn(model) -> Callable:
    """(params, batch) -> (loss, grads) for one worker's batch.

    ``params`` (a worker's read copy) is copied into ``model``'s own
    parameters first, unless it is them; the gradients are the model
    parameters' (in their dtype), the loss a detached 0-dim tensor. LM
    models (``per_token_loss``) take the valid-token mean plus the aux
    loss, classifiers (``per_example_loss``) the per-example mean."""
    if hasattr(model, "per_token_loss"):
        def loss_fn(batch):
            per_tok, aux = model.per_token_loss(batch)
            labels = torch.as_tensor(batch["labels"], device=per_tok.device)
            if per_tok.shape[1] != labels.shape[1]:   # vlm prefix positions
                pad = per_tok.shape[1] - labels.shape[1]
                labels = torch.cat([torch.full((labels.shape[0], pad), -1,
                                               dtype=labels.dtype,
                                               device=labels.device),
                                    labels], 1)
            valid = (labels >= 0).float()
            return (torch.sum(per_tok * valid)
                    / torch.clamp_min(torch.sum(valid), 1.0)) + aux
    else:
        def loss_fn(batch):
            return model.per_example_loss(batch).mean()

    def grad_fn(params: Mapping[str, torch.Tensor], batch):
        own = dict(model.named_parameters())
        with torch.no_grad():
            for k, p in own.items():
                if params[k] is not p:
                    p.copy_(params[k])
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, list(own.values()))
        return loss.detach(), dict(zip(own, grads))

    return grad_fn


def make_update_fn(optimizer: opt_lib.Optimizer,
                   clip_norm: float = 0.0) -> Callable:
    """(params, opt_state, grads, step) -> (params, opt_state, stats), the
    update applied to ``params`` and ``opt_state`` in place: global-norm
    clipping when ``clip_norm > 0``, then the optimizer. ``step`` is the
    PS version (an int, whose scalars are staged here) or the optimizer's
    staged scalars of that step. ``update_fn.init_opt_state`` is the
    optimizer's init."""

    @torch.no_grad()
    def update_fn(params: Named, opt_state, grads: Named, step):
        if isinstance(step, (int, np.integer)):
            device = next(iter(params.values())).device
            step = {k: v[0] for k, v in opt_lib.stage_scalars(
                optimizer, [int(step)], device).items()}
        stats = {}
        if clip_norm > 0:
            grads, stats["grad_norm"] = opt_lib.clip_by_global_norm(
                grads, clip_norm)
        optimizer.apply(params, grads, opt_state, step)
        return params, opt_state, stats

    update_fn.init_opt_state = optimizer.init
    return update_fn
