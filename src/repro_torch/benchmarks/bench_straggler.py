"""Paper Figs. 3 & 4: straggler order statistics on N=100 workers.
Reference: ``benchmarks/bench_straggler.py``.

Fig. 3: CDF of time to collect the k-th gradient (k = 1, 50, 90, 97..100).
Fig. 4: mean/median time to collect k gradients.
Validated claims: flat middle (most mean times 1.4-1.8s), exponential tail
for the last few gradients, max observed latency <= 310s. Host numpy, the
same draws as the reference: its rows' derived strings are equal. The
reference's full CDF curves go to its JSON only; the port writes no file
and prints the rows.

    python -m repro_torch.benchmarks.bench_straggler [--full]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np

from repro_torch.core import straggler


def run(quick: bool = True) -> List[Tuple[str, float, str]]:
    iters = 2000 if quick else 20000
    t0 = time.time()
    rng = np.random.RandomState(0)
    lat = straggler.PaperCalibrated().sample(rng, (iters, 100))
    mean_k, _ = straggler.mean_median_time_to_k(lat)
    elapsed_us = (time.time() - t0) * 1e6 / iters

    frac_98_under_2s = float(straggler.cdf_of_time_to_k(lat, 98,
                                                        np.array([2.0]))[0])
    frac_100_under_2s = float(straggler.cdf_of_time_to_k(lat, 100,
                                                         np.array([2.0]))[0])
    return [
        ("straggler.sim_iter", elapsed_us, f"mean_k50={mean_k[49]:.2f}s"),
        ("straggler.k98_cdf2s", 0.0, f"{frac_98_under_2s:.2f}"),
        ("straggler.k100_cdf2s", 0.0, f"{frac_100_under_2s:.2f}"),
        ("straggler.mean_k100", 0.0, f"{mean_k[99]:.1f}s"),
    ]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the reference's full-length run")
    for row in run(not ap.parse_args().full):
        print(",".join(str(x) for x in row))
