"""Measured straggler tails as a latency model.
Reference: ``src/repro/obs/latency.py``.

:class:`EmpiricalLatencyModel` keeps a per-worker window of measured step
times (one row per dispatch; dead workers at ``+inf`` are counted, not
stored). It feeds ``DynamicBackup``'s cutoff adaptation in
``latency_source='measured'`` mode (``core/coordination.py``) and
implements the simulator's ``LatencyModel`` protocol (``sample(rng,
(iters, workers))``) by bootstrap resampling, so a measured tail can stand
in for ``PaperCalibrated``. Duck-typed (``obs`` imports nothing from
``core``); its state round-trips through ``state_dict`` /
``load_state_dict`` inside ``DynamicBackup``'s checkpointed state. Pure
numpy, equal to the reference bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.quantiles import windowed_quantile


class EmpiricalLatencyModel:
    """Per-worker ring of measured step times (seconds).

    ``record(row)`` folds one measured per-worker row; non-finite
    entries (dead workers arrive at ``+inf``) are counted but not
    stored, so the empirical distribution only ever contains real
    measurements. ``sample`` bootstraps per worker — a worker that has
    its own samples resamples them; one that does not (or a column
    beyond ``num_workers``) draws from the pooled distribution; until
    anything is recorded at all, ``fallback_s`` is returned (warmup).
    """

    def __init__(self, num_workers: int, window: int = 256,
                 fallback_s: float = 1.0):
        if num_workers < 1:
            raise ValueError(f"num_workers must be >= 1 (got {num_workers})")
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
        self.num_workers = int(num_workers)
        self.window = int(window)
        self.fallback_s = float(fallback_s)
        self.samples: List[List[float]] = [[] for _ in range(num_workers)]
        self.rows = 0                 # rows recorded (incl. dropped infs)
        self.dropped = 0              # non-finite entries seen

    def __len__(self) -> int:
        return sum(len(s) for s in self.samples)

    @property
    def warm(self) -> bool:
        return len(self) > 0

    def record(self, row: Sequence[float]) -> None:
        """Fold one measured per-worker step-time row (seconds; +inf for
        workers that produced nothing this step)."""
        row = np.asarray(row, np.float64).reshape(-1)
        self.rows += 1
        for w in range(min(len(row), self.num_workers)):
            v = float(row[w])
            if not np.isfinite(v):
                self.dropped += 1
                continue
            s = self.samples[w]
            s.append(v)
            if len(s) > self.window:
                s.pop(0)

    # -- the LatencyModel protocol (core.straggler, duck-typed) -------------

    def sample(self, rng: np.random.RandomState,
               shape: Tuple[int, ...]) -> np.ndarray:
        """Bootstrap-resample measured times into an [iters, workers]
        (or any trailing-workers) seconds array."""
        out = np.empty(shape, np.float64)
        flat = out.reshape(-1, shape[-1]) if len(shape) > 1 else \
            out.reshape(1, -1)
        pooled = [v for s in self.samples for v in s]
        # legacy RandomState (the straggler sim's rng) or a Generator
        draw = getattr(rng, "integers", None) or rng.randint
        for w in range(flat.shape[1]):
            src = (self.samples[w]
                   if w < self.num_workers and self.samples[w] else pooled)
            if not src:
                flat[:, w] = self.fallback_s
                continue
            idx = draw(0, len(src), size=flat.shape[0])
            flat[:, w] = np.asarray(src, np.float64)[idx]
        return out

    # -- summaries ------------------------------------------------------------

    def quantile(self, q: float, worker: Optional[int] = None,
                 default: float = 0.0) -> float:
        """Windowed percentile — pooled, or one worker's own tail."""
        vals = (self.samples[worker] if worker is not None
                else [v for s in self.samples for v in s])
        return windowed_quantile(vals, q, min_samples=1, default=default)

    def mean_row(self) -> np.ndarray:
        """Per-worker mean step time (fallback where unmeasured)."""
        return np.array([float(np.mean(s)) if s else self.fallback_s
                         for s in self.samples])

    # -- checkpointable state (JSON-able) ------------------------------------

    def state_dict(self) -> Dict:
        return {"num_workers": self.num_workers, "window": self.window,
                "fallback_s": self.fallback_s, "rows": int(self.rows),
                "dropped": int(self.dropped),
                "samples": [[float(v) for v in s] for s in self.samples]}

    def load_state_dict(self, d: Dict) -> None:
        saved = [[float(v) for v in s] for s in d["samples"]]
        # a rescale may change the worker count: keep what maps over
        self.samples = [[] for _ in range(self.num_workers)]
        for w in range(min(len(saved), self.num_workers)):
            self.samples[w] = saved[w][-self.window:]
        self.rows = int(d.get("rows", 0))
        self.dropped = int(d.get("dropped", 0))
        self.fallback_s = float(d.get("fallback_s", self.fallback_s))
