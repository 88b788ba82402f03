"""Replica router: hedged backups, SLO admission, chaos-proof failover.
Reference: ``src/repro/serve/router.py`` (``ROUTER_FAULT_KINDS``,
``RouterConfig``, ``RouterCompleted``, ``RouterReport``,
``ReplicaRouter``), the same host logic over the port's
:class:`~repro_torch.serve.engine.StepSession` replicas, so its reports
match the reference's bit for bit.

The paper cuts the straggler tail by launching N + b workers and taking
the first N gradients; the router applies the same cutoff at request
granularity: when an in-flight request's age crosses a windowed latency
percentile it re-dispatches the request to a second replica, takes
whichever copy finishes first and cancels and frees the loser's slot and
pages. Greedy decode makes the copies token-identical, so hedging buys
latency and never changes the output.

Everything runs on one deterministic virtual clock owned by the router
(the sessions keep no time), so a same-seed run replays bit for bit even
under chaos:

* **Faults** come from ``core.faults``' grammar at replica scope
  (``kind@step:rN[:xF][:dD]``): ``crash`` downs a replica until an
  explicit ``restart``; ``preempt`` downs it for ``duration`` steps and
  revives it; ``slowdown`` stretches its step time by ``factor``. A downed
  replica's in-flight requests drain back to the router queue and
  re-dispatch in arrival order: no request is ever lost.
* **Timeouts** cancel an attempt everywhere and retry it after a seeded,
  jittered, capped exponential backoff; past the retry budget the
  request is rejected with a structured reason.
* **SLO admission** (``serve.slo``) gates fresh arrivals on a windowed p99
  estimate: shed or hold load while the SLO is violated, re-admit under
  hysteresis.

``completed`` plus ``rejected`` always partitions the trace
(``metrics["lost_requests"]`` is the invariant the chaos tests hold). The
tracer marks ``router/*`` instants and the registry mirrors the counters;
neither feeds the dynamics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import faults as faults_lib
from repro_torch.obs.quantiles import windowed_quantile
from repro_torch.obs.trace import as_tracer
from repro_torch.serve import trace as trace_lib
from repro_torch.serve.engine import ServeEngine, StepSession
from repro_torch.serve.health import HealthMonitor
from repro_torch.serve.slo import SLOConfig, SLOController

ROUTER_FAULT_KINDS = ("crash", "preempt", "slowdown", "restart")


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Router policy knobs (all times in virtual clock units)."""

    num_replicas: int
    step_time: float = 1.0         # decode-step duration per replica
    prefill_time: float = 1.0      # admission (prefill) duration
    # -- timeout + retry ------------------------------------------------------
    timeout: Optional[float] = None       # per-attempt deadline (None: off)
    max_retries: int = 2
    backoff: float = 1.0                  # base retry delay
    max_backoff: float = 8.0              # cap on the exponential
    jitter: float = 0.5                   # delay *= 1 + jitter*U[0,1)
    seed: int = 0                         # jitter RNG seed
    # -- hedged backup requests ----------------------------------------------
    hedge_after: Optional[float] = None   # floor age to hedge (None: off)
    hedge_quantile: float = 95.0          # windowed percentile trigger
    hedge_min_samples: int = 8            # below this, floor alone applies
    hedge_window: int = 64                # completed latencies kept
    # -- load + chaos ---------------------------------------------------------
    max_queue: Optional[int] = None       # waiting-room bound (None: inf)
    faults: Optional[str] = None          # replica-scope fault spec
    fault_horizon: int = 256
    fault_seed: int = 0

    def __post_init__(self):
        if self.num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if self.step_time <= 0:
            raise ValueError("step_time must be positive")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")


@dataclasses.dataclass
class RouterCompleted:
    rid: int
    arrival: float
    admitted: float        # dispatch time of the winning copy
    first_token: float
    finish: float
    prompt_len: int
    tokens: List[int]
    replica: int           # replica that produced the winning copy
    hedged: bool = False   # a backup copy was issued at some point
    retries: int = 0       # timeout retries consumed
    drains: int = 0        # failover requeues survived

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival


@dataclasses.dataclass
class RouterReport:
    completed: List[RouterCompleted]
    rejected: List[Dict[str, Any]]     # {"rid", "reason", "t"}
    metrics: Dict[str, float]
    events: List[Dict[str, Any]]       # router decisions (hedge/timeout/...)
    health: List[Dict[str, Any]]       # replica up/slow/down transitions

    def tokens_by_rid(self) -> Dict[int, List[int]]:
        return {c.rid: list(c.tokens) for c in self.completed}


class _Flight:
    """Router-side request state across dispatches."""

    __slots__ = ("req", "state", "primary", "hedge", "dispatch_t",
                 "deadline", "retries", "drains", "was_hedged")

    def __init__(self, req: trace_lib.Request):
        self.req = req
        self.state = "pending"     # pending|waiting|held|inflight|done|rejected
        self.primary = -1
        self.hedge = -1
        self.dispatch_t = -1.0
        self.deadline = float("inf")
        self.retries = 0
        self.drains = 0
        self.was_hedged = False


class ReplicaRouter:
    """Deterministic event-driven router over R StepSession replicas."""

    def __init__(self, engine: ServeEngine, cfg: RouterConfig,
                 slo: Optional[SLOConfig] = None, tracer=None, metrics=None):
        self.engine = engine
        self.cfg = cfg
        self.slo_cfg = slo
        # observability only: the tracer marks dispatch/hedge/timeout/
        # failover instants and the registry mirrors the counters. The
        # virtual-clock dynamics (and the returned metrics dict) never
        # read either, so replays stay bit-identical with or without.
        self.tracer = as_tracer(tracer)
        self.metrics = metrics
        self.fault_plan = None
        if cfg.faults:
            plan = faults_lib.plan_from_spec(
                cfg.faults, num_steps=cfg.fault_horizon,
                num_workers=cfg.num_replicas, seed=cfg.fault_seed,
                num_replicas=cfg.num_replicas)
            bad = sorted({e.kind for e in plan.events
                          if e.kind not in ROUTER_FAULT_KINDS})
            if bad:
                raise ValueError(
                    f"router wires only {ROUTER_FAULT_KINDS} of the fault "
                    f"taxonomy (ckpt_io has no serving surface); got {bad}")
            for e in plan.events:
                if not 0 <= e.replica < cfg.num_replicas:
                    raise ValueError(
                        f"fault {e.kind}@{e.step} targets replica "
                        f"{e.replica} but the router has "
                        f"{cfg.num_replicas} replicas")
            self.fault_plan = plan

    # -- hedging threshold ----------------------------------------------------

    def _hedge_threshold(self, lat_window: List[float]) -> Optional[float]:
        cfg = self.cfg
        if cfg.hedge_after is None:
            return None
        # cold window -> -inf -> max() returns the floor: identical to
        # the pre-extraction two-branch logic, bit for bit
        est = windowed_quantile(lat_window, cfg.hedge_quantile,
                                cfg.hedge_min_samples,
                                default=float("-inf"))
        return max(est, cfg.hedge_after)

    # -- the event loop -------------------------------------------------------

    def run(self, trace: Sequence[trace_lib.Request]) -> RouterReport:
        cfg = self.cfg
        eng = self.engine
        tracer = self.tracer
        for r in trace:
            eng.validate_request(r)
        sessions = [StepSession(eng, name=f"r{i}")
                    for i in range(cfg.num_replicas)]
        health = HealthMonitor(cfg.num_replicas)
        slo = SLOController(self.slo_cfg) if self.slo_cfg else None
        rng = np.random.RandomState(cfg.seed)

        arrivals = sorted(trace, key=lambda r: (r.arrival, r.rid))
        flights = {r.rid: _Flight(r) for r in arrivals}
        waiting: List[Tuple[float, float, int]] = []   # (ready, arrival, rid)
        held: List[int] = []                           # SLO "queue" pen
        next_tick: Dict[int, float] = {}               # replica -> t
        # requests that finished at prefill, completing when the clock
        # reaches ft: (ft, rid, replica, slot-state); the slot-state
        # identity check at fire time detects cancelled/re-dispatched
        # copies, so stale entries drain as no-ops
        pending_prefill: List[Tuple[float, int, int, Any]] = []
        completed: List[RouterCompleted] = []
        rejected: List[Dict[str, Any]] = []
        events: List[Dict[str, Any]] = []
        lat_window: List[float] = []
        counters = {"hedges": 0, "hedge_wins": 0, "timeouts": 0,
                    "retries": 0, "drained": 0}
        fault_events = list(self.fault_plan.events) if self.fault_plan else []
        arr_i = fault_i = 0
        rr_next = 0                                    # round-robin cursor
        t = 0.0
        done_count = 0
        total = len(arrivals)

        def reject(fl: _Flight, reason: str, now: float) -> None:
            nonlocal done_count
            fl.state = "rejected"
            rejected.append({"rid": fl.req.rid, "reason": reason,
                             "t": float(now)})
            events.append({"event": "reject", "rid": fl.req.rid,
                           "reason": reason, "t": float(now)})
            done_count += 1

        def observe(lat: float) -> None:
            lat_window.append(lat)
            if len(lat_window) > cfg.hedge_window:
                lat_window.pop(0)
            if slo is not None:
                slo.observe(lat)

        def pick_replica(req, exclude: int = -1) -> int:
            cands = [r for r in health.up_replicas()
                     if r != exclude and sessions[r].can_admit(req)]
            if not cands:
                return -1
            n = cfg.num_replicas
            return min(cands, key=lambda r: (sessions[r].n_active,
                                             (r - rr_next) % n))

        def untick(r: int) -> None:
            # a session emptied outside the tick loop (timeout, hedge
            # loser, prefill completion) must drop its pending tick, or a
            # later admission inherits a stale — possibly slowdown-
            # stretched — schedule
            if r >= 0 and not sessions[r].active:
                next_tick.pop(r, None)

        def complete(rid: int, winner: int, finish: float) -> None:
            nonlocal done_count
            fl = flights[rid]
            st = sessions[winner].release(rid)
            loser = fl.hedge if winner == fl.primary else fl.primary
            if loser >= 0 and rid in sessions[loser]._slot_of:
                sessions[loser].release(rid)       # cancel-and-free
            untick(winner)
            untick(loser)
            if winner == fl.hedge:
                counters["hedge_wins"] += 1
            fl.state = "done"
            done_count += 1
            completed.append(RouterCompleted(
                rid=rid, arrival=fl.req.arrival, admitted=st.admitted,
                first_token=st.first_token, finish=finish,
                prompt_len=fl.req.prompt_len, tokens=st.tokens,
                replica=winner, hedged=fl.was_hedged, retries=fl.retries,
                drains=fl.drains))
            observe(finish - fl.req.arrival)

        def admit_to(rid: int, r: int, now: float, *, hedge: bool) -> None:
            nonlocal rr_next
            fl = flights[rid]
            ft = now + cfg.prefill_time * health.factor(r, now)
            st = sessions[r].admit(fl.req, now, ft)
            rr_next = (r + 1) % cfg.num_replicas
            if hedge:
                fl.hedge = r
                fl.was_hedged = True
                counters["hedges"] += 1
                events.append({"event": "hedge", "rid": rid, "replica": r,
                               "t": float(now)})
                tracer.instant("router/hedge", rid=rid, replica=r,
                               vt=float(now))
            else:
                fl.primary, fl.state = r, "inflight"
                fl.dispatch_t = now
                fl.deadline = (now + cfg.timeout if cfg.timeout is not None
                               else float("inf"))
                tracer.instant("router/dispatch", rid=rid, replica=r,
                               vt=float(now))
            if sessions[r].done(st):               # finishes at prefill
                # completion is an *event at ft*, not a fact at admission:
                # the replica can still crash (or the copy be cancelled)
                # before the clock reaches ft, so schedule it instead of
                # completing in the past's future
                pending_prefill.append((ft, rid, r, st))
            else:
                base = next_tick.get(r)
                step = cfg.step_time * health.factor(r, now)
                if base is None:
                    next_tick[r] = ft + step
                else:                              # prefill defers the tick
                    next_tick[r] = base + cfg.prefill_time * \
                        health.factor(r, now)

        def drain(r: int, now: float, reason: str) -> None:
            for st in sessions[r].evict_all():
                rid = st.req.rid
                fl = flights[rid]
                if fl.state != "inflight":
                    continue
                other = fl.hedge if r == fl.primary else fl.primary
                if fl.hedge >= 0 and other >= 0 \
                        and rid in sessions[other]._slot_of:
                    # the surviving copy carries on as the new primary
                    fl.primary, fl.hedge = other, -1
                    continue
                fl.primary, fl.hedge = -1, -1
                fl.state = "waiting"
                fl.drains += 1
                counters["drained"] += 1
                waiting.append((now, fl.req.arrival, rid))
            next_tick.pop(r, None)
            events.append({"event": "drain", "replica": r, "t": float(now),
                           "reason": reason})
            tracer.instant("router/failover", replica=r, reason=reason,
                           vt=float(now))

        while done_count < total:
            # ---- phase A: drain everything due at time t --------------------
            changed = True
            while changed:
                changed = False
                health.expire(t)
                # faults
                while (fault_i < len(fault_events)
                       and fault_events[fault_i].step * cfg.step_time
                       <= t + 1e-12):
                    ev = fault_events[fault_i]
                    fault_i += 1
                    changed = True
                    r = ev.replica
                    if ev.kind == "crash" and health.is_up(r):
                        drain(r, t, "crash")
                        health.mark_down(r, t, reason="crash")
                    elif ev.kind == "preempt" and health.is_up(r):
                        drain(r, t, "preempt")
                        health.mark_down(
                            r, t, reason="preempt",
                            up_at=t + ev.duration * cfg.step_time)
                    elif ev.kind == "slowdown":
                        health.set_slowdown(
                            r, t, factor=ev.factor,
                            until=t + ev.duration * cfg.step_time)
                    elif ev.kind == "restart" and not health.is_up(r):
                        health.revive(r, t)
                # arrivals (the only path through the SLO gate)
                while arr_i < len(arrivals) \
                        and arrivals[arr_i].arrival <= t + 1e-12:
                    req = arrivals[arr_i]
                    arr_i += 1
                    changed = True
                    fl = flights[req.rid]
                    if cfg.max_queue is not None \
                            and len(waiting) >= cfg.max_queue:
                        reject(fl, "queue_overflow", t)
                        continue
                    verdict = slo.admit(t) if slo is not None else "admit"
                    if verdict == "shed":
                        reject(fl, "slo_shed", t)
                    elif verdict == "queue":
                        fl.state = "held"
                        held.append(req.rid)
                    else:
                        fl.state = "waiting"
                        waiting.append((req.arrival, req.arrival, req.rid))
                # SLO re-opened: release the hold pen
                if held and (slo is None or not slo.violating):
                    for rid in held:
                        flights[rid].state = "waiting"
                        waiting.append((t, flights[rid].req.arrival, rid))
                    held.clear()
                    changed = True
                elif held and not waiting and not next_tick:
                    # gate shut but the system is idle: nothing in flight
                    # means nothing can ever feed the estimator — probe
                    # with the oldest held request instead of deadlocking
                    rid = held.pop(0)
                    flights[rid].state = "waiting"
                    waiting.append((t, flights[rid].req.arrival, rid))
                    changed = True
                # prefill-only completions land when the clock reaches ft
                for entry in [p for p in pending_prefill
                              if p[0] <= t + 1e-12]:
                    pending_prefill.remove(entry)
                    _, rid, r, st = entry
                    slot = sessions[r]._slot_of.get(rid)
                    if slot is None or sessions[r].active.get(slot) is not st:
                        continue   # copy cancelled (drain/timeout/hedge win)
                    changed = True
                    complete(rid, r, t)
                # replica decode ticks — look up via .get(): complete()
                # above (and hedge-loser release inside it) may pop a
                # replica's entry while this sweep is mid-iteration
                for r in sorted(next_tick):
                    tick = next_tick.get(r)
                    if tick is None or tick > t + 1e-12:
                        continue
                    changed = True
                    for rid in sessions[r].tick():
                        complete(rid, r, t)
                    if sessions[r].active:
                        next_tick[r] = t + cfg.step_time * health.factor(r, t)
                    else:
                        next_tick.pop(r, None)
                # timeouts -> jittered capped exponential retry
                if cfg.timeout is not None:
                    for rid in sorted(flights):
                        fl = flights[rid]
                        if fl.state != "inflight" or fl.deadline > t + 1e-12:
                            continue
                        changed = True
                        for r in (fl.primary, fl.hedge):
                            if r >= 0 and rid in sessions[r]._slot_of:
                                sessions[r].release(rid)
                                untick(r)
                        counters["timeouts"] += 1
                        tracer.instant("router/timeout", rid=rid,
                                       vt=float(t))
                        if fl.retries >= cfg.max_retries:
                            reject(fl, "timeout", t)
                            continue
                        delay = min(cfg.backoff * 2.0 ** fl.retries,
                                    cfg.max_backoff) \
                            * (1.0 + cfg.jitter * float(rng.uniform()))
                        fl.retries += 1
                        counters["retries"] += 1
                        fl.primary, fl.hedge = -1, -1
                        fl.state = "waiting"
                        waiting.append((t + delay, fl.req.arrival, rid))
                        events.append({"event": "retry", "rid": rid,
                                       "t": float(t),
                                       "delay": float(delay)})
                # hedges: back up stragglers past the windowed percentile
                thresh = self._hedge_threshold(lat_window)
                if thresh is not None:
                    for rid in sorted(flights):
                        fl = flights[rid]
                        if (fl.state != "inflight" or fl.hedge >= 0
                                or t + 1e-12 < fl.dispatch_t + thresh):
                            continue
                        r = pick_replica(fl.req, exclude=fl.primary)
                        if r < 0:
                            continue
                        changed = True
                        admit_to(rid, r, t, hedge=True)
                # dispatch the waiting room in (arrival, rid) order
                ready = sorted([w for w in waiting if w[0] <= t + 1e-12],
                               key=lambda w: (w[1], w[2]))
                for entry in ready:
                    rid = entry[2]
                    fl = flights[rid]
                    if eng.pages_needed(fl.req) > eng.page_capacity:
                        waiting.remove(entry)
                        reject(fl, "pool_exhausted", t)
                        changed = True
                        continue
                    r = pick_replica(fl.req)
                    if r < 0:
                        continue
                    waiting.remove(entry)
                    changed = True
                    admit_to(rid, r, t, hedge=False)
            if done_count >= total:
                break
            # ---- phase B: advance to the next event -------------------------
            cands: List[float] = []
            if fault_i < len(fault_events):
                cands.append(fault_events[fault_i].step * cfg.step_time)
            if arr_i < len(arrivals):
                cands.append(arrivals[arr_i].arrival)
            cands.extend(w[0] for w in waiting if w[0] > t)
            cands.extend(next_tick.values())
            cands.extend(p[0] for p in pending_prefill)
            if cfg.timeout is not None:
                cands.extend(fl.deadline for fl in flights.values()
                             if fl.state == "inflight"
                             and fl.deadline > t)
            thresh = self._hedge_threshold(lat_window)
            if thresh is not None:
                cands.extend(fl.dispatch_t + thresh
                             for fl in flights.values()
                             if fl.state == "inflight" and fl.hedge < 0
                             and fl.dispatch_t + thresh > t)
            nr = health.next_restart()
            if nr != float("inf"):
                cands.append(nr)
            cands.extend(rep.slow_until for rep in health.replicas
                         if rep.state == "slow" and rep.slow_until > t)
            future = [c for c in cands if c > t + 1e-12]
            if not future:
                # nothing can ever run the rest: account for every request
                for _, _, rid in sorted(waiting, key=lambda w: (w[1], w[2])):
                    reject(flights[rid], "no_healthy_replica", t)
                waiting.clear()
                for rid in held:
                    reject(flights[rid], "no_healthy_replica", t)
                held.clear()
                for rid in sorted(flights):
                    if flights[rid].state == "pending":
                        reject(flights[rid], "no_healthy_replica", t)
                continue
            t = min(future)

        metrics = self._metrics(arrivals, completed, rejected, counters,
                                health, slo)
        if self.metrics is not None:
            reg = self.metrics
            reg.counter("router/completed").inc(len(completed))
            reg.counter("router/rejected").inc(len(rejected))
            for key in ("hedges", "hedge_wins", "timeouts", "retries",
                        "drained"):
                reg.counter(f"router/{key}").inc(counters[key])
            h = reg.histogram("router/latency")
            for c in completed:
                h.observe(c.latency)
        return RouterReport(completed=completed, rejected=rejected,
                            metrics=metrics, events=events,
                            health=list(health.log))

    # -- metrics --------------------------------------------------------------

    def _metrics(self, arrivals, completed, rejected, counters, health,
                 slo) -> Dict[str, float]:
        lats = np.array([c.latency for c in completed] or [0.0])
        ttfts = np.array([c.ttft for c in completed] or [0.0])
        t_end = max([c.finish for c in completed]
                    + [r["t"] for r in rejected] + [0.0])
        t_start = min((r.arrival for r in arrivals), default=0.0)
        duration = max(t_end - t_start, 1e-9)
        total = len(arrivals)
        m = {
            "total": total,
            "completed": len(completed),
            "rejected": len(rejected),
            "lost_requests": total - len(completed) - len(rejected),
            "duration": duration,
            "goodput": len(completed) / duration,
            "p50_latency": float(np.percentile(lats, 50)),
            "p99_latency": float(np.percentile(lats, 99)),
            "p99_ttft": float(np.percentile(ttfts, 99)),
            "hedges": counters["hedges"],
            "hedge_wins": counters["hedge_wins"],
            "timeouts": counters["timeouts"],
            "retries": counters["retries"],
            "drained": counters["drained"],
            "shed": sum(1 for r in rejected if r["reason"] == "slo_shed"),
        }
        m.update(health.counts())
        if slo is not None:
            m["slo_trips"] = slo.trips
            m["slo_reentered"] = int(slo.trips > 0 and not slo.violating)
        return m
