"""Paper Fig. 6: estimated time to converge for each (N, b) split of a
fixed 100-machine budget — the paper's headline trade-off, whose optimum
was N=96, b=4. Reference: ``benchmarks/bench_time_to_converge.py``.

time(N) = iters(N) x mean_iteration_time(BackupWorkers(N, 100-N)), with
iters(N) = a + c/N from the Fig. 5 fit handed in (``run(fit=...)``, from
``bench_iterations_vs_n.run`` in the same process; the reference reads it
from that bench's JSON) when its curvature allows extrapolating, else
interpolated from the paper's own Fig. 5 numbers, and iteration times
simulated from the calibrated latency model (``core.events``).
Validated claim: the optimum is interior — a few backups beat both b=0
(straggler-bound) and large b (gradient-variance-bound).

    python -m repro_torch.benchmarks.bench_time_to_converge   # paper fit
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core import events, straggler

TOTAL = 100


def paper_fit() -> Tuple[float, float]:
    # paper Fig. 5: ~137.5e3 @ 50, ~76.2e3 @ 100 => iters = a + c/N
    c = (137.5e3 - 76.2e3) / (1 / 50 - 1 / 100)
    a = 76.2e3 - c / 100
    return a, c


def iters_model(fit: Optional[Tuple[float, float]] = None
                ) -> Tuple[Callable[[int], float], str]:
    """iters(N) over N in [50, 100] and its source. Prefer the tiny-LM
    ``fit`` (a, c) when its curvature is strong enough to extrapolate
    (iters(50)/iters(100) >= 1.2); otherwise use the paper's own Fig. 5
    endpoints — composing OUR iteration-time simulation with THEIR
    iteration counts, which is exactly the estimate the paper performs for
    Fig. 6."""
    if fit is not None:
        a, c = fit
        i50, i100 = a + c / 50, a + c / 100
        if i100 > 0 and i50 / i100 >= 1.2:
            return (lambda n: a + c / n), "fitted(tiny-lm)"
    a, c = paper_fit()
    return (lambda n: a + c / n), "paper-fig5-interpolated"


def run(quick: bool = True, fit: Optional[Tuple[float, float]] = None
        ) -> List[Tuple[str, float, str]]:
    ns = list(range(50, TOTAL + 1, 5 if quick else 1))
    iters_fn, _ = iters_model(fit)
    sim_iters = 800 if quick else 4000
    t0 = time.time()
    times, _ = events.estimate_time_to_converge(
        np.array(ns), np.array([iters_fn(n) for n in ns]), TOTAL,
        straggler.PaperCalibrated(), sim_iters=sim_iters, seed=0)
    best = int(np.argmin(times))
    best_n = ns[best]
    return [
        ("time_to_converge.best_split", (time.time() - t0) * 1e6 / len(ns),
         f"N={best_n},b={TOTAL - best_n}"),
        # b=0: wait for everyone
        ("time_to_converge.speedup_vs_b0", 0.0,
         f"{times[-1] / times[best]:.2f}x"),
        ("time_to_converge.interior_optimum", 0.0,
         str(50 < best_n < TOTAL)),
    ]


if __name__ == "__main__":
    for row in run():
        print(",".join(str(x) for x in row))
