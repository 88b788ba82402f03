"""SLO-driven admission control for the serve engine and the router.
Reference: ``src/repro/serve/slo.py`` (``SLO_MODES``, ``SLOConfig``,
``SLOController``), copied unchanged so every admit / shed decision and
the checkpointable state match the reference's.

A windowed p99-latency estimator feeding a shed / queue decision:
``observe(latency)`` pushes a completed request's latency into the window
(bounded, FIFO) and recomputes the estimate; ``admit(now)`` answers
``"admit"``, ``"shed"`` (drop with a structured rejection) or ``"queue"``
(hold until the controller re-opens). The controller is hysteretic: it
trips when the windowed p99 exceeds ``target_p99`` and re-admits once the
estimate falls under ``target_p99 * resume_margin``. All state round-trips
through ``state_dict`` / ``load_state_dict``. Numpy only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.obs.quantiles import windowed_quantile

SLO_MODES = ("off", "shed", "queue")


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Admission-control policy knobs (all times in router clock units)."""

    target_p99: float              # the SLO: windowed p99 latency ceiling
    mode: str = "shed"             # off | shed | queue
    window: int = 64               # latency observations kept
    min_samples: int = 8           # below this the controller stays open
    quantile: float = 99.0         # which order statistic to control on
    resume_margin: float = 0.8     # re-admit under target * margin
    probe_every: int = 4           # shed mode: admit every k-th arrival
                                   # as a probe so the estimator keeps
                                   # seeing fresh latencies (0: no probes)

    def __post_init__(self):
        if self.mode not in SLO_MODES:
            raise ValueError(f"slo mode must be one of {SLO_MODES} "
                             f"(got {self.mode!r})")
        if self.target_p99 <= 0:
            raise ValueError("target_p99 must be positive")
        if not 0 < self.resume_margin <= 1:
            raise ValueError("resume_margin must be in (0, 1]")


class SLOController:
    """Windowed-percentile admission gate with hysteresis."""

    def __init__(self, cfg: SLOConfig):
        self.cfg = cfg
        self.window: List[float] = []
        self.violating = False
        self.shed_count = 0
        self.queue_count = 0
        self.probes = 0
        self.trips = 0                 # open -> violating transitions
        self._since_probe = 0

    # -- estimate -------------------------------------------------------------

    def estimate(self) -> float:
        """Current windowed p-``quantile`` latency (0 until warm)."""
        return windowed_quantile(self.window, self.cfg.quantile,
                                 self.cfg.min_samples, 0.0)

    def observe(self, latency: float) -> None:
        self.window.append(float(latency))
        if len(self.window) > self.cfg.window:
            self.window.pop(0)
        est = self.estimate()
        if not self.violating:
            if est > self.cfg.target_p99:
                self.violating = True
                self.trips += 1
        elif est < self.cfg.target_p99 * self.cfg.resume_margin:
            self.violating = False

    # -- the gate -------------------------------------------------------------

    def admit(self, now: float) -> str:
        """Decision for one arrival: "admit" | "shed" | "queue"."""
        if self.cfg.mode == "off" or not self.violating:
            return "admit"
        if self.cfg.mode == "shed":
            # without probes a tripped shed gate would latch shut: shed
            # arrivals never complete, so the window would freeze above
            # target and nothing could ever re-open it
            self._since_probe += 1
            if self.cfg.probe_every \
                    and self._since_probe >= self.cfg.probe_every:
                self._since_probe = 0
                self.probes += 1
                return "admit"
            self.shed_count += 1
            return "shed"
        self.queue_count += 1
        return "queue"

    # -- checkpointable state -------------------------------------------------

    def state_dict(self) -> Dict:
        return {"window": [float(x) for x in self.window],
                "violating": bool(self.violating),
                "shed_count": int(self.shed_count),
                "queue_count": int(self.queue_count),
                "probes": int(self.probes),
                "trips": int(self.trips),
                "since_probe": int(self._since_probe)}

    def load_state_dict(self, d: Dict) -> None:
        self.window = [float(x) for x in d["window"]]
        self.violating = bool(d["violating"])
        self.shed_count = int(d["shed_count"])
        self.queue_count = int(d["queue_count"])
        self.probes = int(d["probes"])
        self.trips = int(d["trips"])
        self._since_probe = int(d["since_probe"])
