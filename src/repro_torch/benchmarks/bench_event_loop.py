"""Host/dispatch overhead of the EVENT training loop: per arrival vs
chunked. Reference: ``benchmarks/bench_event_loop.py`` (``CHUNK_SIZES``,
``STRATEGIES``, ``build_trainer``, ``measure_all``, ``main``, ``run``: its
rows, lines and payload).

Measures updates/s of the qwen3-0.6b smoke config for the async and
softsync regimes at chunk_size in {1, 8, 32}. chunk_size=1 is the
per-arrival path — per gradient arrival one gradient call, one update
call, a host heap pop/push and a metrics read; larger chunks plan a
block of arrivals on the host (``coordination.plan_events``) and run
them through the event graphs on the card (one replay an arrival: the
graph that applies the update or the one that buffers), a loop on the
CPU. Every timed interval ends with a ``torch.cuda.synchronize`` on the
card. Returns the payload; writes it only to ``--out PATH``.

    python -m repro_torch.benchmarks.bench_event_loop [--device cpu]
        [--quick]
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.benchmarks import common
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      OptimizerConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.straggler import Uniform
from repro_torch.models.common import resolve_device
from repro_torch.train.loop import Trainer

CHUNK_SIZES = (1, 8, 32)
STRATEGIES = ("async", "softsync")


def build_trainer(strategy: str, chunk_size: int, workers: int = 4,
                  device=None):
    # smoke model, small shape: per-arrival device compute is a few ms, so
    # the measurement isolates the event loop's host/dispatch overhead,
    # not model FLOPs
    cfg = TrainConfig(
        model=configs.get_smoke_config("qwen3-0.6b"),
        shape=ShapeConfig("bench", 8, 2 * workers, "train"),
        aggregation=AggregationConfig(strategy=strategy, num_workers=workers,
                                      softsync_c=2),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.02,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.999),
        checkpoint=CheckpointConfig(every_steps=0),
        # per-update logging, as in real training: the per-arrival path
        # reads the metrics each update; the chunked one a chunk's at once
        log_every=1,
        chunk_size=chunk_size)
    tr = Trainer(cfg, latency=Uniform(1.0, 2.0), device=device)
    tr.init_state()
    return tr


def measure_all(specs, updates: int, reps: int = 3, device=None):
    """Build and warm every config first, then the interleaved
    best-of-``reps`` timing (``common.best_of``)."""
    trainers = []
    for strategy, chunk_size in specs:
        tr = build_trainer(strategy, chunk_size, device=device)
        tr.run(max(chunk_size, 8))                 # capture + warm caches
        trainers.append(tr)
    best = common.best_of(trainers, lambda tr: tr.run(updates), reps,
                          device)
    return [{"strategy": s, "chunk_size": c, "updates": updates,
             "wall_s": w, "updates_per_s": updates / w}
            for (s, c), w in zip(specs, best)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer timed updates (CI)")
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    updates = 64 if args.quick else 192
    specs = [(s, c) for s in STRATEGIES for c in CHUNK_SIZES]
    results = measure_all(specs, updates, device=device)

    def rate(strategy, chunk):
        return next(r["updates_per_s"] for r in results
                    if r["strategy"] == strategy and r["chunk_size"] == chunk)

    def speedups(strategy):
        base = rate(strategy, 1)
        return {f"speedup_{c}_vs_1": rate(strategy, c) / base
                for c in CHUNK_SIZES if c > 1}

    per_strategy = {s: speedups(s) for s in STRATEGIES}
    payload = {
        "bench": "event_loop",
        "model": "qwen3-0.6b smoke",
        "updates": updates,
        "results": results,
        **{s: per_strategy[s] for s in STRATEGIES},
        # headline: chunked async vs the per-arrival loop
        "speedup_32_vs_1": per_strategy["async"]["speedup_32_vs_1"],
    }
    path = common.write_out(args.out, payload, device)

    for r in results:
        print(f"strategy={r['strategy']:<9} chunk_size={r['chunk_size']:>3} "
              f"{r['updates_per_s']:8.1f} updates/s")
    print(f"async speedup 32 vs 1: {payload['speedup_32_vs_1']:.2f}x"
          + (f" -> {path}" if path else ""))
    return payload


def run(quick: bool = True, device=None):
    """The harness contract: (name, us_per_call, derived)."""
    payload = main((["--quick"] if quick else [])
                   + (["--device", str(device)] if device else []))
    rows = [(f"event_loop.{r['strategy']}_chunk{r['chunk_size']}",
             1e6 / r["updates_per_s"], f"{r['updates_per_s']:.1f}up/s")
            for r in payload["results"]]
    rows.append(("event_loop.async_speedup_32_vs_1", 0.0,
                 f"{payload['speedup_32_vs_1']:.2f}x"))
    return rows


if __name__ == "__main__":
    main()
