"""Worker-latency model protocol. Reference: ``src/repro/core/straggler.py``.

Only ``LatencyModel`` is ported in this slice: the serve trace's arrival
process (``serve/trace.py``) subclasses it. The calibrated straggler
models come with the training slice.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class LatencyModel:
    """sample(rng, (iters, workers)) -> seconds array."""

    def sample(self, rng: np.random.RandomState, shape: Tuple[int, ...]) -> np.ndarray:
        raise NotImplementedError
