"""Paper Table 2 / Fig. 7: small gamma0 converges FASTER to a WORSE optimum.
Reference: ``benchmarks/bench_lr_sweep.py``.

The paper's methodology point: report both time-to-epsilon and the final
metric, or early-phase speed misleads. Tiny-LM sweep over gamma0 with the
paper's exponential decay (``schedules.exponential_decay(g, 0.94, 50)``);
it records steps-to-epsilon for a loose epsilon (small lr wins) and the
best held-out loss reached (large lr wins). On the card unless ``--device
cpu``.

    python -m repro_torch.benchmarks.bench_lr_sweep [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.optim import schedules

EPS_LOOSE = 3.0
EVAL_EVERY = 10


def sweep_losses(gamma0: float, steps: int, device=None) -> np.ndarray:
    """The held-out losses of one gamma0's run, read every ``EVAL_EVERY``
    steps from the first."""
    _, params, grad_fn, batch_fn, eval_fn = common.tiny_lm_problem(
        batch=16, seed=0, device=device)
    sched = schedules.exponential_decay(gamma0, 0.94, steps_per_epoch=50)
    losses = []
    for s in range(steps):
        _, grads = grad_fn(params, batch_fn(0, s))
        lr = sched(s)
        with torch.no_grad():
            for k, p in params.items():
                p.sub_(lr * grads[k])
        if s % EVAL_EVERY == 0:
            losses.append(eval_fn(params))
    return np.array(losses)


def run(quick: bool = True, device=None, steps: Optional[int] = None
        ) -> List[Tuple[str, float, str]]:
    """The reference's rows; ``steps`` cuts each run short."""
    gammas = [0.05, 0.2, 0.8] if quick else [0.05, 0.1, 0.2, 0.4, 0.8, 1.6]
    steps = steps or (400 if quick else 1200)
    rows = []
    results = {}
    for g in gammas:
        t0 = time.time()
        losses = sweep_losses(g, steps, device)
        t_eps = common.time_to_threshold(
            np.arange(len(losses)) * float(EVAL_EVERY), losses, EPS_LOOSE)
        best = float(losses.min())
        results[g] = {"steps_to_loose_eps": t_eps, "best_loss": best}
        rows.append((f"lr_sweep.g{g}", (time.time() - t0) * 1e6 / steps,
                     f"best={best:.3f},t_eps={t_eps}"))

    gs = sorted(results)
    # paper-shape checks: the largest lr reaches the best optimum; the
    # smallest lr is not the best optimum
    best_gamma = min(results, key=lambda g_: results[g_]["best_loss"])
    rows.append(("lr_sweep.best_gamma", 0.0, str(best_gamma)))
    rows.append(("lr_sweep.small_lr_worse_optimum", 0.0,
                 str(results[gs[0]]["best_loss"]
                     > results[best_gamma]["best_loss"] + 1e-3)))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    ap.add_argument("--full", action="store_true",
                    help="the reference's full-length run")
    args = ap.parse_args()
    for row in run(not args.full, device=args.device):
        print(",".join(str(x) for x in row))
