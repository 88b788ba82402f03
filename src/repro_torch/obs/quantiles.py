"""Windowed-quantile estimation: the one estimator behind every tail.
Reference: ``src/repro/obs/quantiles.py``.

:func:`windowed_quantile` is a FIFO window's float64 ``np.percentile``
(linear interpolation), gated on a warmup count; :class:`WindowedQuantile`
is a bounded window of observations with its estimate and a checkpointable
state. Pure numpy, equal to the reference bit for bit; nothing in
``repro_torch`` below it is imported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def windowed_quantile(values: Sequence[float], quantile: float,
                      min_samples: int = 1,
                      default: float = 0.0) -> float:
    """Percentile of ``values`` — ``default`` until ``min_samples`` seen.

    The exact estimate both serving controllers computed inline:
    float64 ``np.percentile`` (linear interpolation) over the window,
    gated on a warmup count. Behavior-preserving by construction — the
    router replay tests pin this bit-for-bit.
    """
    if len(values) < min_samples:
        return default
    return float(np.percentile(np.asarray(values, np.float64), quantile))


class WindowedQuantile:
    """A bounded FIFO window of observations + its percentile estimate."""

    __slots__ = ("window", "quantile", "min_samples", "values")

    def __init__(self, window: int, quantile: float = 99.0,
                 min_samples: int = 1,
                 values: Optional[Sequence[float]] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1 (got {window})")
        self.window = int(window)
        self.quantile = float(quantile)
        self.min_samples = int(min_samples)
        self.values: List[float] = [float(x) for x in (values or [])]

    def __len__(self) -> int:
        return len(self.values)

    @property
    def warm(self) -> bool:
        return len(self.values) >= self.min_samples

    def observe(self, x: float) -> None:
        self.values.append(float(x))
        if len(self.values) > self.window:
            self.values.pop(0)

    def estimate(self, default: float = 0.0,
                 quantile: Optional[float] = None) -> float:
        return windowed_quantile(
            self.values, self.quantile if quantile is None else quantile,
            self.min_samples, default)

    # -- checkpointable state -------------------------------------------------

    def state_dict(self) -> Dict:
        return {"values": [float(x) for x in self.values]}

    def load_state_dict(self, d: Dict) -> None:
        self.values = [float(x) for x in d["values"]][-self.window:]
