"""Paper Figs. 8/9 (headline result): Sync-Opt with backup workers
converges FASTER (simulated wall time) and to a BETTER optimum than
Async-Opt at matched worker counts; plain Sync (b=0) is slowed by
stragglers. Reference: ``benchmarks/bench_sync_vs_async.py``.

Setup: tiny LM, N+b machines under the calibrated latency model. Every
variant routes through the single ``run_experiment(cfg, data_cfg=...)``
entry point — only ``AggregationConfig.strategy`` changes between
regimes:
  * sync_backup: first N of N+b aggregated (Alg. 3/4)
  * sync_full:   all N+b aggregated, iteration time = max arrival
  * async:       Alg. 1/2 discrete-event loop, staleness ~ N
  * softsync:    Zhang et al. (2015b) baseline, c arrivals per update
Same lr-per-datapoint rule as the paper (A.3) scaled to the tiny problem:
sync base x N, async base, softsync base x c.

The full-width preset (``run_full_width``, which ``chip_smoke.py`` drives)
runs the same four regimes on qwen3-0.6b at its published widths (bf16),
on the synthetic stream cut to a data vocabulary of ``FULL_DATA_VOCAB``
ids (the model keeps its 151,936-id head), with every step a replay of a
captured CUDA graph: backup 6 + 2 and full sync 8 on the spmd engine
(the ``backup_reduce`` kernel each step), async and softsync c = 2 with
W = 8 on the event graphs. Its target loss is halfway between the
uniform guess over the data vocabulary and the stream's entropy.

    python -m repro_torch.benchmarks.bench_sync_vs_async [--device cpu]
    python -m repro_torch.benchmarks.bench_sync_vs_async --full-width \\
        [--base 0.01 0.02 ...]      # on the card; several bases: a sweep
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.benchmarks import common
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      ExecutionConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.data.synthetic_lm import SyntheticLMConfig
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.train.loop import run_experiment

# same stream parameters as common.tiny_lm_problem's held-out eval batches
_NOISE = 0.2
EPS = 2.6                     # the tiny LM's target train loss
SOFTSYNC_C = 2

# the full-width preset
FULL_ARCH = "qwen3-0.6b"
FULL_DATA_VOCAB = 512         # the stream's ids; the one cut
FULL_SEQ = 256
FULL_PER_WORKER = 2           # sequences per worker per step
FULL_N, FULL_B = 6, 2
FULL_STEPS = 40               # sync steps; async 4x, softsync 2x updates
FULL_CHUNK = 8                # steps (updates) per chunk: graph replays
FULL_BASE_LR = 0.05           # the swept SGD base (PERF.md, Findings)


def _data_cfg(cfg: TrainConfig, vocab: Optional[int] = None
              ) -> SyntheticLMConfig:
    return SyntheticLMConfig(
        vocab_size=vocab or cfg.model.vocab_size, seq_len=cfg.shape.seq_len,
        global_batch=cfg.shape.global_batch,
        num_workers=cfg.aggregation.total_workers, seed=cfg.seed,
        noise=_NOISE)


def _variant_cfg(strategy: str, *, workers: int, backups: int = 0,
                 steps: int, lr: float, softsync_c: int = 1,
                 seed: int = 0) -> TrainConfig:
    total = workers + backups
    return TrainConfig(
        model=common.tiny_lm_config(),
        shape=ShapeConfig("bench", 32, 8 * total, "train"),
        aggregation=AggregationConfig(strategy=strategy, num_workers=workers,
                                      backup_workers=backups,
                                      softsync_c=softsync_c),
        optimizer=OptimizerConfig(name="sgd", learning_rate=lr,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.0),
        checkpoint=CheckpointConfig(every_steps=0),
        seed=seed, total_steps=steps, log_every=10)


def full_width_cfg(strategy: str, *, arch: str = FULL_ARCH, **kw
                   ) -> Tuple[TrainConfig, SyntheticLMConfig]:
    """``_variant_cfg`` at full width and its token stream: ``arch`` as
    published, seq ``FULL_SEQ``, ``FULL_PER_WORKER`` sequences per worker
    drawn from ``FULL_DATA_VOCAB`` ids, chunks of ``FULL_CHUNK`` (graph
    replays on the card), every step logged (a chunk's metrics are read
    once); the mask strategies on the spmd engine (one worker at a time,
    one reduce bucket), the event ones on sim."""
    cfg = _variant_cfg(strategy, **kw)
    mask = strategy in ("backup", "full_sync")
    cfg = dataclasses.replace(
        cfg, model=configs.get_config(arch),
        shape=ShapeConfig("full", FULL_SEQ, FULL_PER_WORKER
                          * cfg.aggregation.total_workers, "train"),
        execution=ExecutionConfig(backend="spmd" if mask else "sim",
                                  grad_batch=1, bucket_size=0),
        log_every=1, chunk_size=FULL_CHUNK)
    return cfg, _data_cfg(cfg, FULL_DATA_VOCAB)


def _regimes(n: int, b: int, steps: int, base: float
             ) -> List[Tuple[str, str, Dict]]:
    """(row name, strategy, ``_variant_cfg`` keywords) of the four
    regimes: lr base x N for sync, base for async, base x c for
    softsync; async runs enough updates to see as many gradients as
    ``steps`` sync steps of n + b workers would (half of them), softsync
    half as many updates of c = 2 arrivals."""
    async_steps = steps * (n + b) // 2
    return [
        ("sync_backup", "backup",
         dict(workers=n, backups=b, steps=steps, lr=base * n)),
        ("sync_full", "full_sync", dict(workers=n + b, steps=steps,
                                        lr=base * n)),
        ("async", "async", dict(workers=n + b, steps=async_steps, lr=base)),
        ("softsync", "softsync",
         dict(workers=n + b, steps=async_steps // 2, lr=base * SOFTSYNC_C,
              softsync_c=SOFTSYNC_C)),
    ]


def _trajectory(res) -> Tuple[np.ndarray, np.ndarray]:
    return (np.array([m["sim_time"] for m in res.metrics]),
            np.array([m["loss"] for m in res.metrics]))


def _rows(out: Dict[str, Dict], eps: float) -> List[Tuple[str, float, str]]:
    """The reference's rows from each regime's ``us`` (per step or
    update), ``final`` held-out loss, mean staleness and trajectory."""
    rows = []
    for name, o in out.items():
        derived = f"final={o['final']:.3f}"
        if name in ("async", "softsync"):
            derived += f",mean_staleness={o['res'].mean_staleness:.1f}"
        rows.append((f"sync_vs_async.{name}", o["us"], derived))
    t_sync = common.time_to_threshold(*_trajectory(out["sync_backup"]["res"]),
                                      eps)
    t_full = common.time_to_threshold(*_trajectory(out["sync_full"]["res"]),
                                      eps)
    better_final = out["sync_backup"]["final"] <= out["async"]["final"] + 1e-3
    faster_than_full = (t_sync or np.inf) <= (t_full or np.inf)
    rows.append(("sync_vs_async.backup_better_final_than_async", 0.0,
                 str(bool(better_final))))
    rows.append(("sync_vs_async.backup_faster_than_fullsync", 0.0,
                 str(bool(faster_than_full))))
    return rows


def run(quick: bool = True, steps: Optional[int] = None,
        device=None) -> List[Tuple[str, float, str]]:
    """The tiny-LM comparison (the reference's), on ``device``."""
    dev = resolve_device(device)
    n, b = (6, 2) if quick else (12, 4)
    steps = steps or (250 if quick else 800)
    # held-out eval on the same tiny-LM family (worker id 997 stream)
    _, _, _, _, eval_fn = common.tiny_lm_problem(batch=8, workers=n + b,
                                                 device=dev)
    out = {}
    for name, strategy, kw in _regimes(n, b, steps, 0.08):
        t0 = time.time()
        cfg = _variant_cfg(strategy, **kw)
        res = run_experiment(cfg, data_cfg=_data_cfg(cfg), device=dev)
        out[name] = dict(res=res, final=eval_fn(res.params),
                         us=(time.time() - t0) * 1e6 / max(res.steps, 1))
    return _rows(out, EPS)


# ---------------------------------------------------------------------------
# The full-width preset
# ---------------------------------------------------------------------------


def full_width_target() -> float:
    """Halfway between ln(V_data), the loss of a uniform guess over the
    data vocabulary, and the stream's entropy floor."""
    return 0.5 * (math.log(FULL_DATA_VOCAB)
                  + common.stream_entropy(FULL_DATA_VOCAB, _NOISE))


def unigram_target() -> float:
    """ln(V_data) + 0.5: within half a nat of a model that has learnt
    which ids occur but not what follows what (a second crossing, printed
    beside the target's)."""
    return math.log(FULL_DATA_VOCAB) + 0.5


def _to_target(res, target: float) -> Dict[str, Optional[float]]:
    """Steps (updates), sim_time and the card's host wall (summed
    ``step_times_s``, the first chunk's capture included) at the first
    smoothed crossing of ``target`` by the logged train loss."""
    losses = np.array([m["loss"] for m in res.metrics])
    steps = np.array([m["step"] for m in res.metrics])
    wall = np.cumsum(res.step_times_s)[steps - 1]
    return {axis: common.time_to_threshold(times, losses, target)
            for axis, times in (("steps", steps),
                                ("sim_time", _trajectory(res)[0]),
                                ("wall_s", wall))}


def _crossing(t: Dict[str, Optional[float]], unit: str) -> str:
    return (f"{unit}s {t['steps']}, sim_time {t['sim_time']}, card wall "
            f"{t['wall_s']} s")


def run_full_width(base: float = FULL_BASE_LR, *, steps: int = FULL_STEPS,
                   device=None, log=print
                   ) -> Tuple[Dict[str, Dict], List[Tuple[str, float, str]]]:
    """The four regimes at full width, one trainer at a time, each freed
    before the next. Returns the rows and, per regime: ``res`` (its
    ``params`` dropped), the ``final`` held-out loss, ``us`` per step or
    update, the crossings of the target and of the unigram level
    (``to_target``, ``to_unigram``: steps, sim_time, wall), the steady host
    wall per step or update (``steady_ms``: the chunks after the first)
    and the peak device memory (``peak``, on the card)."""
    dev = resolve_device(device)
    target, unigram = full_width_target(), unigram_target()
    regimes = _regimes(FULL_N, FULL_B, steps, base)
    # every regime draws 2 sequences a worker from 8 workers' streams
    eval_fn = common.heldout_eval(
        get_model(configs.get_config(FULL_ARCH), device=dev),
        full_width_cfg("backup", **regimes[0][2])[1])
    log(f"[full width] {FULL_ARCH}, data vocab {FULL_DATA_VOCAB}, noise "
        f"{_NOISE}: stream entropy "
        f"{common.stream_entropy(FULL_DATA_VOCAB, _NOISE):.6f}, ln V "
        f"{math.log(FULL_DATA_VOCAB):.6f}, target {target:.6f} (unigram "
        f"level {unigram:.6f}); SGD base lr {base}, {steps} sync steps")
    out = {}
    for name, strategy, kw in regimes:
        cfg, data_cfg = full_width_cfg(strategy, **kw)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        res = run_experiment(cfg, data_cfg=data_cfg, device=dev)
        us = (time.time() - t0) * 1e6 / max(res.steps, 1)
        final = eval_fn(res.params)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        res.params = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        steady = res.step_times_s[cfg.chunk_size:]
        o = out[name] = dict(
            res=res, final=final, us=us, peak=peak,
            to_target=_to_target(res, target),
            to_unigram=_to_target(res, unigram),
            steady_ms=1e3 * float(np.mean(steady)) if steady else None)
        losses = [m["loss"] for m in res.metrics]
        unit = "step" if strategy in ("backup", "full_sync") else "update"
        per = "not measured (one chunk)"
        if steady:
            per = f"{o['steady_ms']:.3f} ms/{unit}"
            if res.arrivals:
                per += (f" ({o['steady_ms'] * res.steps / res.arrivals:.3f} "
                        f"ms/arrival)")
        log(f"[full width {name}] {res.steps} {unit}s, {res.arrivals} "
            f"arrivals, lr {kw['lr']:.6g}: train loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (min {min(losses):.4f}); to the target: "
            f"{_crossing(o['to_target'], unit)}; to the unigram level: "
            f"{_crossing(o['to_unigram'], unit)}; final held-out {final:.6f}; "
            f"sim_time {res.sim_time:.6f}; host wall "
            f"{sum(res.step_times_s):.3f} s, steady {per}; mean staleness "
            f"{res.mean_staleness:.3f}, mean selected "
            f"{res.mean_selected:.3f}; peak device memory {peak} bytes")
        log(f"[full width {name}] train losses "
            f"{' '.join(f'{v:.4f}' for v in losses)}")
    return out, _rows(out, target)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    ap.add_argument("--full", action="store_true",
                    help="the reference's full-length tiny run (12 + 4)")
    ap.add_argument("--steps", type=int, default=None,
                    help="sync steps (async and softsync scale with it)")
    ap.add_argument("--full-width", action="store_true",
                    help=f"the full-width preset ({FULL_ARCH})")
    ap.add_argument("--base", type=float, nargs="+",
                    default=[FULL_BASE_LR],
                    help="full width: SGD base lr(s); several = a sweep")
    args = ap.parse_args()
    if args.full_width:
        for base in args.base:
            _, rows = run_full_width(base, steps=args.steps or FULL_STEPS,
                                     device=args.device)
            for row in rows:
                print(f"base={base}," + ",".join(str(x) for x in row))
    else:
        for row in run(not args.full, args.steps, device=args.device):
            print(",".join(str(x) for x in row))
