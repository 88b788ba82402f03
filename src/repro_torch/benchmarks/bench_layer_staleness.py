"""Paper Table 1 / Fig. 1: gradient staleness DEPENDS ON LAYER DEPTH.
Reference: ``benchmarks/bench_layer_staleness.py``
(``simulate_layer_staleness``, :26).

Parameters are read bottom-up during forward prop and gradients are sent
top-down during backprop, so a lower layer's read->update window is wider:
the paper measured mean staleness ~14.5 at the top layer vs ~39.0 at the
bottom (40 async workers).

Event simulation: each worker's iteration occupies [t0, t1]; layer l (of
L) is read at t0 + (l/L) * f * (t1-t0) and its gradient lands at
t1 - (l/L) * b * (t1-t0) (f, b = forward/backward time fractions). The
staleness of layer l's gradient = number of PS updates in its window.
Validated claim: staleness decreases monotonically with depth, bottom ~2x
top, mean ~ #workers — the paper's Table 1 shape. Host numpy, the
reference's draws and arithmetic: its rows' derived strings are equal.

    python -m repro_torch.benchmarks.bench_layer_staleness [--full]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np

from repro_torch.core.straggler import LogNormal


def simulate_layer_staleness(num_workers: int = 40, num_layers: int = 19,
                             iters: int = 400, fwd_frac: float = 0.33,
                             bwd_frac: float = 0.31, seed: int = 0):
    """Returns mean staleness per layer index (0 = bottom, L-1 = top)."""
    rng = np.random.RandomState(seed)
    lat = LogNormal(median=1.5, sigma=0.2)
    # worker w iteration k occupies [start[w,k], end[w,k]]
    durations = lat.sample(rng, (num_workers, iters))
    ends = np.cumsum(durations, axis=1)
    starts = ends - durations
    # global update timeline: one PS update at each gradient arrival (the
    # full gradient is applied when the last (bottom) layer grad lands)
    update_times = np.sort(ends.reshape(-1))

    frac = np.arange(num_layers) / max(num_layers - 1, 1)
    # layer l (0=bottom): read early in fwd, sent late in bwd
    # read offset fraction rises with height; send offset fraction falls
    stal = np.zeros(num_layers)
    for w in range(num_workers):
        for k in range(1, iters):                     # skip warmup iteration
            t0, t1 = starts[w, k], ends[w, k]
            dur = t1 - t0
            read_t = t0 + frac * fwd_frac * dur       # top read latest
            send_t = t1 - frac * bwd_frac * dur       # top sent earliest
            lo = np.searchsorted(update_times, read_t)
            hi = np.searchsorted(update_times, send_t)
            stal += hi - lo
    stal /= num_workers * (iters - 1)
    return stal            # index 0 = bottom layer, L-1 = top layer


def run(quick: bool = True) -> List[Tuple[str, float, str]]:
    iters = 200 if quick else 1000
    t0 = time.time()
    stal = simulate_layer_staleness(num_workers=40, num_layers=19,
                                    iters=iters)
    us = (time.time() - t0) * 1e6 / iters
    bottom, top = float(stal[0]), float(stal[-1])
    monotone = bool(np.all(np.diff(stal) <= 1e-9))
    return [
        ("layer_staleness.sim_iter", us, "workers=40,layers=19"),
        ("layer_staleness.bottom_layer", 0.0, f"{bottom:.1f}"),
        ("layer_staleness.top_layer", 0.0, f"{top:.1f}"),
        ("layer_staleness.bottom_over_top", 0.0,
         f"{bottom / max(top, 1e-9):.2f}x"),
        ("layer_staleness.monotone_in_depth", 0.0, str(monotone)),
    ]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the reference's full-length run")
    for row in run(not ap.parse_args().full):
        print(",".join(str(x) for x in row))
