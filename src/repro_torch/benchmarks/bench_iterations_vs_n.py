"""Paper Fig. 5: iterations to converge vs the number of aggregated
workers N. Reference: ``benchmarks/bench_iterations_vs_n.py``.

Sync-Opt with effective batch N*B needs fewer iterations as N grows (the
paper: 137.5e3 @ N=50 -> 76.2e3 @ N=100, near-halving). Reproduced on the
tiny LM: steps to reach a target held-out loss for N in a 4x range,
fitted to iters(N) ~ a + c/N, the fit ``bench_time_to_converge`` takes
for Fig. 6.

    python -m repro_torch.benchmarks.bench_iterations_vs_n [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.benchmarks import common

TARGET = 2.45          # close to the noise floor => variance-limited
EVAL_EVERY = 5


def steps_to_target(n_workers: int, target: float, max_steps: int,
                    batch_per_worker: int = 2, lr: float = 0.15,
                    seed: int = 0, device=None,
                    losses: Optional[List[float]] = None) -> int:
    """Noise-limited regime: tiny per-worker batches so the gradient
    variance (∝ 1/N) is what gates progress — the paper's Fig. 5 effect.
    Each step averages the N workers' losses and takes one SGD step on
    it; the held-out loss is read every ``EVAL_EVERY`` steps. ``losses``,
    when given, receives every step's training loss."""
    model, params, _, batch_fn, eval_fn = common.tiny_lm_problem(
        batch=batch_per_worker, workers=n_workers, seed=seed, seq=16,
        device=device)
    update = common.sgd_update_fn(lr)

    def sync_step(batches):
        per_worker = []
        for b in batches:
            lt, aux = model.per_token_loss(b)
            per_worker.append(lt.mean() + aux)
        loss = sum(per_worker) / len(per_worker)
        return loss.detach(), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    for step in range(max_steps):
        batches = [batch_fn(w, step) for w in range(n_workers)]
        loss, grads = sync_step(batches)
        params, _ = update(params, None, grads, step)
        if losses is not None:
            losses.append(float(loss))
        if step % EVAL_EVERY == 0 and eval_fn(params) <= target:
            return step
    return max_steps


def run(quick: bool = True, device=None
        ) -> Tuple[List[Tuple[str, float, str]], Tuple[float, float]]:
    """The rows and the fit (a, c) of iters(N) = a + c/N."""
    ns = [1, 2, 4, 8] if quick else [1, 2, 4, 8, 16]
    max_steps = 600 if quick else 1500
    rows = []
    iters = {}
    for n in ns:
        t0 = time.time()
        s = steps_to_target(n, TARGET, max_steps, device=device)
        iters[n] = s
        rows.append((f"iters_vs_n.N{n}", (time.time() - t0) * 1e6 / max(s, 1),
                     f"iters={s}"))
    # fit iters(N) = a + c/N  (paper's shape: diminishing returns in N)
    a_ns = np.array(list(iters))
    ys = np.array([iters[n] for n in a_ns], float)
    x = np.stack([np.ones_like(a_ns, float), 1.0 / a_ns], 1)
    coef, *_ = np.linalg.lstsq(x, ys, rcond=None)
    halving = iters[ns[0]] / max(iters[ns[-1]], 1)
    rows.append(("iters_vs_n.range_ratio", 0.0,
                 f"{halving:.2f}x fewer iters at {ns[-1] // ns[0]}x workers"))
    return rows, (float(coef[0]), float(coef[1]))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    ap.add_argument("--full", action="store_true",
                    help="the reference's full-length run (N up to 16)")
    args = ap.parse_args()
    rows, (a, c) = run(not args.full, device=args.device)
    for row in rows:
        print(",".join(str(x) for x in row))
    print(f"fit: iters(N) = {a:.6g} + {c:.6g}/N")
