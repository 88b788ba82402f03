"""Replica health tracking for the router: up / slow / down, and when.
Reference: ``src/repro/serve/health.py`` (``HEALTH_STATES``,
``HealthMonitor``), copied unchanged: the router's health log must match
the reference's bit for bit.

The router consumes the chaos engine's fault grammar at replica scope
(``kind@step:rN``, ``core/faults.py``) and this module is where those
faults become routing state. A replica is ``"up"`` (dispatchable),
``"slow"`` (dispatchable, serving at ``factor`` x step time until the
slowdown window closes) or ``"down"`` (crashed or preempted: its in-flight
requests were drained back to the router queue; a ``restart`` fault, or a
preemption's built-in return, re-admits it). Every transition lands in a
structured, wall-clock-free event log, so a same-seed chaos replay gives a
bit-identical health history. Stdlib only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

HEALTH_STATES = ("up", "slow", "down")


@dataclasses.dataclass
class _Replica:
    state: str = "up"
    slow_factor: float = 1.0
    slow_until: float = -1.0       # router-clock time the slowdown ends
    up_at: float = -1.0            # scheduled restart time when down
    crashes: int = 0
    preempts: int = 0
    restarts: int = 0


class HealthMonitor:
    """Track R replicas' health and the transition log."""

    def __init__(self, num_replicas: int):
        if num_replicas < 1:
            raise ValueError("need at least one replica")
        self.replicas = [_Replica() for _ in range(num_replicas)]
        self.log: List[Dict[str, Any]] = []

    # -- transitions (driven by the router's fault loop) ----------------------

    def mark_down(self, r: int, now: float, *, reason: str,
                  up_at: float = -1.0) -> None:
        rep = self.replicas[r]
        rep.state = "down"
        rep.slow_factor, rep.slow_until = 1.0, -1.0
        rep.up_at = up_at
        if reason == "preempt":          # two distinct fault kinds: keep
            rep.preempts += 1            # the metrics distinguishable
        else:
            rep.crashes += 1
        self.log.append({"event": "down", "replica": r, "t": float(now),
                         "reason": reason})

    def revive(self, r: int, now: float) -> None:
        rep = self.replicas[r]
        rep.state = "up"
        rep.up_at = -1.0
        rep.restarts += 1
        self.log.append({"event": "up", "replica": r, "t": float(now)})

    def set_slowdown(self, r: int, now: float, *, factor: float,
                     until: float) -> None:
        rep = self.replicas[r]
        if rep.state == "down":
            return                  # a dead replica cannot also be slow
        rep.state = "slow"
        rep.slow_factor, rep.slow_until = float(factor), float(until)
        self.log.append({"event": "slow", "replica": r, "t": float(now),
                         "factor": float(factor), "until": float(until)})

    # -- queries --------------------------------------------------------------

    def expire(self, now: float) -> None:
        """Close elapsed slowdown windows; fire due scheduled restarts."""
        for r, rep in enumerate(self.replicas):
            if rep.state == "slow" and now >= rep.slow_until:
                rep.state = "up"
                rep.slow_factor, rep.slow_until = 1.0, -1.0
                self.log.append({"event": "recovered", "replica": r,
                                 "t": float(now)})
            elif rep.state == "down" and 0 <= rep.up_at <= now:
                self.revive(r, now)

    def is_up(self, r: int) -> bool:
        return self.replicas[r].state != "down"

    def factor(self, r: int, now: float) -> float:
        rep = self.replicas[r]
        if rep.state == "slow" and now < rep.slow_until:
            return rep.slow_factor
        return 1.0

    def up_replicas(self) -> List[int]:
        return [r for r, rep in enumerate(self.replicas)
                if rep.state != "down"]

    def next_restart(self) -> float:
        """Earliest scheduled revive among down replicas (inf if none)."""
        times = [rep.up_at for rep in self.replicas
                 if rep.state == "down" and rep.up_at >= 0]
        return min(times) if times else float("inf")

    def counts(self) -> Dict[str, int]:
        return {"crashes": sum(r.crashes for r in self.replicas),
                "preempts": sum(r.preempts for r in self.replicas),
                "restarts": sum(r.restarts for r in self.replicas)}
