"""Seeded chaos engine: composable, deterministic fault schedules.
Reference: ``src/repro/core/faults.py`` (pure numpy; plans, draw order and
error texts equal the reference's).

* :class:`FaultEvent` — one planned fault, of a kind in ``FAULT_KINDS``:

    - ``crash``     the worker dies; its gradient never arrives again
                    (``+inf`` arrivals, so the mask drops it, and on the
                    spmd engine its row of the ``backup_reduce`` stack is
                    masked out) until the next rescale;
    - ``slowdown``  the worker's latencies are multiplied by ``factor``
                    for ``duration`` steps (``StragglerSimulator`` in mask
                    mode, ``EventScheduler`` service times in event mode);
    - ``restart``   a crashed worker rejoins with the current parameters;
    - ``ckpt_io``   the next checkpoint save fails ``fails`` times with
                    ``OSError`` before succeeding (``checkpoint.save``'s
                    retries);
    - ``preempt``   an optional grace checkpoint, then :class:`Preemption`
                    (``train.supervisor.run_supervised`` recovers).

* :class:`FaultPlan` — the ordered schedule, from a spec string
  (:func:`plan_from_spec`; ``:rN`` scopes a fault to a serving replica).
  Same spec and seed: the same plan and the same recovery log.

* :class:`FaultInjector` — the runtime: fired events (each at most once,
  also across restarts), the dead set, active slowdowns, armed checkpoint
  failures and the structured recovery log (``TrainResult.recovery_log``).

The trainer applies faults at chunk boundaries (it forces a boundary at
every pending fault step), so they land on the same step on every path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("crash", "slowdown", "restart", "ckpt_io", "preempt")

# recovery-log event types (schema in docs/api.md); every entry also
# carries "step" and the fields listed per type
RECOVERY_EVENTS = ("worker_crash", "worker_slowdown", "worker_restart",
                   "ckpt_io_fault", "ckpt_write_retry", "preempt",
                   "restore", "rescale", "give_up")


class Preemption(RuntimeError):
    """An injected (or real) preemption notice: the run must die now.

    ``grace_checkpointed`` records whether a grace-period checkpoint was
    committed before raising — the supervisor restores from it."""

    def __init__(self, step: int, grace_checkpointed: bool):
        super().__init__(f"preempted at step {step} "
                         f"(grace checkpoint: {grace_checkpointed})")
        self.step = int(step)
        self.grace_checkpointed = bool(grace_checkpointed)


class InjectedIOError(OSError):
    """The ckpt_io fault's write failure (distinguishable in tests)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One planned fault; fields beyond (kind, step) are kind-specific."""

    kind: str
    step: int
    worker: int = -1          # crash/slowdown/restart target
    factor: float = 4.0       # slowdown latency multiplier
    duration: int = 8         # slowdown steps until recovery
    fails: int = 2            # ckpt_io: failed write attempts injected
    grace: bool = True        # preempt: grace-period checkpoint first
    replica: int = -1         # serving-replica target (router scope, :rN)

    def __post_init__(self):
        if self.kind not in FAULT_KINDS + ("slow_end",):
            raise ValueError(_unknown_kind_message(self.kind))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An ordered fault schedule; deterministic in (spec, seed)."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            sorted(self.events, key=lambda e: (e.step, e.kind, e.worker, e.replica))))

    def __len__(self) -> int:
        return len(self.events)


_KIND_ALIASES = {"slow": "slowdown", "kill": "crash"}


def _unknown_kind_message(kind: str, item: Optional[str] = None) -> str:
    """Mirror ``registry.get_strategy``'s unknown-name message: name what
    was asked for, then the full list of valid kinds (plus aliases)."""
    where = f" in {item!r}" if item else ""
    aliases = ", ".join(f"{a}={k}" for a, k in sorted(_KIND_ALIASES.items()))
    return (f"unknown fault kind {kind!r}{where}; "
            f"valid kinds: {', '.join(FAULT_KINDS)} (aliases: {aliases})")


@dataclasses.dataclass(frozen=True)
class _SpecItem:
    kind: str
    step: Optional[int] = None
    worker: Optional[int] = None
    replica: Optional[int] = None
    factor: Optional[float] = None
    duration: Optional[int] = None
    count: int = 1


def _parse_item(item: str) -> _SpecItem:
    """One spec item -> :class:`_SpecItem`.

    Grammar (docs/robustness.md):
        kind '@' step [':w' worker] [':r' replica]
                      [':x' factor] [':d' duration]   explicit placement
        kind ['=' count]                              seeded-random placement

    ``:rN`` scopes the fault to serving replica N (the router surface,
    docs/serving.md); ``:xF``/``:dD`` override the slowdown factor and
    duration. ``:wN`` and ``:rN`` are mutually exclusive — a fault
    targets a training worker or a serving replica, never both.
    """
    if "@" in item:
        kind, rest = item.split("@", 1)
        parts = rest.split(":")
        fields: Dict[str, float] = {}
        for p in parts[1:]:
            try:
                value = (float(p[1:])
                         if p[:1] in ("w", "r", "x", "d") and p[1:]
                         else None)
            except ValueError:           # known key, non-numeric suffix
                value = None
            if value is None:
                raise ValueError(f"bad fault spec field {p!r} in {item!r} "
                                 f"(valid: wN worker, rN replica, "
                                 f"xF factor, dD duration)")
            if p[0] in fields:
                raise ValueError(f"duplicate fault spec field {p!r} "
                                 f"in {item!r}")
            fields[p[0]] = value
        if "w" in fields and "r" in fields:
            raise ValueError(f"fault {item!r} targets both a worker (:w) "
                             f"and a replica (:r) — pick one scope")
        return _SpecItem(
            _KIND_ALIASES.get(kind.strip(), kind.strip()),
            step=int(parts[0]),
            worker=None if "w" not in fields else int(fields["w"]),
            replica=None if "r" not in fields else int(fields["r"]),
            factor=fields.get("x"),
            duration=None if "d" not in fields else int(fields["d"]))
    kind, _, cnt = item.partition("=")
    return _SpecItem(_KIND_ALIASES.get(kind.strip(), kind.strip()),
                     count=int(cnt) if cnt else 1)


def plan_from_spec(spec: str, *, num_steps: int, num_workers: int,
                   seed: int = 0, num_replicas: int = 0) -> FaultPlan:
    """Parse a chaos spec into a deterministic :class:`FaultPlan`.

    Explicit items pin (step, worker/replica); count items draw
    steps/workers from a RandomState seeded with ``seed`` — the same
    (spec, seed, num_steps, num_workers) always yields the identical
    plan. ``num_replicas > 0`` switches the random-target scope to
    serving replicas (the router's surface): drawn targets land on
    ``replica`` instead of ``worker``, with the identical draw sequence.
    """
    rng = np.random.RandomState(seed)
    hi = max(num_steps - 1, 2)
    events: List[FaultEvent] = []
    for raw in spec.split(","):
        item = raw.strip()
        if not item:
            continue
        it = _parse_item(item)
        if it.kind not in FAULT_KINDS:
            raise ValueError(_unknown_kind_message(it.kind, item))
        for _ in range(it.count):
            s = it.step if it.step is not None else int(rng.randint(1, hi))
            if num_replicas:        # router scope: random targets = replicas
                r = (it.replica if it.replica is not None
                     else int(rng.randint(num_replicas)))
                w = -1 if it.worker is None else int(it.worker)
            else:                   # training scope: legacy draw order
                w = (it.worker if it.worker is not None
                     else int(rng.randint(num_workers)))
                if it.kind in ("ckpt_io", "preempt"):
                    w = -1
                r = -1 if it.replica is None else int(it.replica)
            default_dur = (max(2, min(8, num_steps // 8))
                           if it.kind == "slowdown" else 8)
            events.append(FaultEvent(
                it.kind, s, worker=w, replica=r,
                factor=4.0 if it.factor is None else float(it.factor),
                duration=default_dur if it.duration is None
                else int(it.duration)))
    return FaultPlan(tuple(events), seed)


class FaultInjector:
    """Runtime state of one chaos plan across a (possibly restarted) run.

    The Trainer pulls due events each step via :meth:`take_due` and asks
    :meth:`upcoming_steps` when sizing chunks so every fault lands on a
    dispatch boundary. The supervisor owns the injector across restarts:
    :meth:`resync` re-applies persistent effects (dead workers, active
    slowdowns) to a freshly rebuilt Trainer.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.log: List[Dict] = []
        self._pending: List[FaultEvent] = list(plan.events)
        self.dead: set = set()              # permanently-crashed workers
        self.slow_active: Dict[int, Tuple[float, int]] = {}  # w -> (f, end)
        self.ckpt_fails_armed = 0
        self._ckpt_io_step = 0              # step the arming happened at

    # -- schedule queries ----------------------------------------------------

    def upcoming_steps(self) -> List[int]:
        """Steps that must be chunk boundaries: every unfired fault plus
        the end of every active slowdown window."""
        steps = [e.step for e in self._pending]
        steps += [end for _, end in self.slow_active.values()]
        return steps

    def take_due(self, step: int) -> List[FaultEvent]:
        """Pop every event due at or before ``step`` (fire-at-most-once),
        appending synthesized ``slow_end`` events for expired windows."""
        due = [e for e in self._pending if e.step <= step]
        self._pending = [e for e in self._pending if e.step > step]
        for w, (factor, end) in sorted(self.slow_active.items()):
            if end <= step:
                due.append(FaultEvent("slow_end", end, worker=w,
                                      factor=factor))
        due.sort(key=lambda e: (e.step, e.kind, e.worker, e.replica))
        return due

    def defer(self, event: FaultEvent, to_step: int) -> None:
        """Push an event back (e.g. a preempt that cannot checkpoint at a
        mid-window arrival) — deterministic, so logs stay reproducible."""
        self._pending.append(dataclasses.replace(event, step=int(to_step)))
        self._pending.sort(key=lambda e: (e.step, e.kind, e.worker, e.replica))

    # -- effect bookkeeping (the Trainer calls these as it applies) ----------

    def record(self, event: str, **fields) -> None:
        entry = {"event": event, **fields}
        self.log.append(entry)

    def note_crash(self, step: int, worker: int) -> None:
        self.dead.add(int(worker))
        self.slow_active.pop(int(worker), None)
        self.record("worker_crash", step=int(step), worker=int(worker))

    def note_slowdown(self, step: int, worker: int, factor: float,
                      duration: int) -> int:
        end = int(step + max(duration, 1))
        self.slow_active[int(worker)] = (float(factor), end)
        self.record("worker_slowdown", step=int(step), worker=int(worker),
                    factor=float(factor), until=end)
        return end

    def note_slow_end(self, worker: int) -> None:
        self.slow_active.pop(int(worker), None)

    def note_restart(self, step: int, worker: int) -> None:
        self.dead.discard(int(worker))
        self.record("worker_restart", step=int(step), worker=int(worker))

    def arm_ckpt_failures(self, step: int, fails: int) -> None:
        self.ckpt_fails_armed += int(fails)
        self._ckpt_io_step = int(step)
        self.record("ckpt_io_fault", step=int(step), fails=int(fails))

    def ckpt_io_check(self) -> None:
        """``checkpoint.save``'s per-attempt hook: raise while armed."""
        if self.ckpt_fails_armed > 0:
            self.ckpt_fails_armed -= 1
            raise InjectedIOError(
                f"injected checkpoint write failure "
                f"(armed at step {self._ckpt_io_step})")

    def on_ckpt_retry(self, step: int):
        """A ``checkpoint.save(on_retry=...)`` callback bound to ``step``."""
        def cb(attempt: int, exc: BaseException) -> None:
            self.record("ckpt_write_retry", step=int(step),
                        attempt=int(attempt), error=type(exc).__name__)
        return cb

    # -- supervisor hooks -----------------------------------------------------

    def resync(self, trainer) -> None:
        """Re-apply persistent fault effects to a rebuilt Trainer (after a
        supervisor restore): permanent deaths and still-active slowdowns.
        Idempotent; emits no log entries."""
        for w in sorted(self.dead):
            trainer.fault_kill(w)
        for w, (factor, end) in sorted(self.slow_active.items()):
            if end > trainer.step:
                trainer.fault_slowdown(w, factor)
            else:
                self.slow_active.pop(w, None)


def build_injector(fault_cfg, *, num_steps: int,
                   num_workers: int) -> Optional[FaultInjector]:
    """FaultConfig -> FaultInjector (None when no chaos is configured)."""
    if fault_cfg is None or not fault_cfg.spec:
        return None
    plan = plan_from_spec(fault_cfg.spec, num_steps=num_steps,
                          num_workers=num_workers, seed=fault_cfg.seed)
    return FaultInjector(plan)
