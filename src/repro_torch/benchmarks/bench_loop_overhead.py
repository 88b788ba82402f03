"""Host/dispatch overhead of the training loop: per step vs fused chunks.
Reference: ``benchmarks/bench_loop_overhead.py`` (``CHUNK_SIZES``,
``build_trainer``, ``measure_all``, ``main``: its rows, lines and
payload).

Measures wall-clock steps/s of the qwen3-0.6b smoke config for
chunk_size in {1, 8, 32} on the ``sim`` backend. chunk_size=1 is the
per-step path — one step call, one batch+mask transfer and one metrics
read per step; larger chunks run K steps a call with one stacked
transfer and one read per chunk, each step a replay of the captured step
graph on the card (``core/step_graph``), a loop on the CPU. On
smoke-scale models the per-step host overhead dominates, so this ratio
tracks the overhead the chunked loop retires. Every timed interval ends
with a ``torch.cuda.synchronize`` on the card.

Also measures the device-resident ``device`` straggler backend at chunks
8 and 32 (``--host-only`` skips it). Returns the payload; writes it only
to ``--out PATH``.

    python -m repro_torch.benchmarks.bench_loop_overhead [--device cpu]
        [--quick] [--host-only]
"""
from __future__ import annotations

import argparse

from repro_torch import configs as configs_lib
from repro_torch.benchmarks import common
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      OptimizerConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.straggler import Uniform
from repro_torch.models.common import resolve_device
from repro_torch.train.loop import Trainer

CHUNK_SIZES = (1, 8, 32)


def build_trainer(chunk_size: int, backend: str = "host", device=None):
    # smoke model, small shape: per-step device compute is a few ms, so
    # the measurement isolates the loop's host/dispatch overhead rather
    # than model FLOPs
    cfg = TrainConfig(
        model=configs_lib.get_smoke_config("qwen3-0.6b"),
        shape=ShapeConfig("bench", 4, 6, "train"),
        aggregation=AggregationConfig(strategy="backup", num_workers=4,
                                      backup_workers=2),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.02,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.999),
        checkpoint=CheckpointConfig(every_steps=0),
        # per-step logging, as in real training: the per-step path pays a
        # metrics read every step (the chunked loop reads a chunk's in one
        # go)
        log_every=1,
        chunk_size=chunk_size, straggler_backend=backend)
    tr = Trainer(cfg, latency=Uniform(1.0, 2.0), device=device)
    tr.init_state()
    return tr


def measure_all(configs, steps: int, reps: int = 3, device=None):
    """Build and warm every config first, then the interleaved
    best-of-``reps`` timing (``common.best_of``)."""
    trainers = []
    for chunk_size, backend in configs:
        tr = build_trainer(chunk_size, backend, device=device)
        tr.run(max(chunk_size, 8))                 # capture + warm caches
        trainers.append(tr)
    best = common.best_of(trainers, lambda tr: tr.run(steps), reps, device)
    return [{"chunk_size": c, "backend": b, "steps": steps,
             "wall_s": w, "steps_per_s": steps / w}
            for (c, b), w in zip(configs, best)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer timed steps (CI)")
    ap.add_argument("--host-only", action="store_true",
                    help="skip the device-resident backend measurements")
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    steps = 64 if args.quick else 192
    # chunk_size=1 is the per-step loop; chunked rows are measured in both
    # modes: 'host' (bit-exact numpy straggler streams) and 'device' (batch
    # generation, arrival sampling and mask selection on the device). The
    # headline speedup compares the best chunked loop with the per-step
    # path.
    configs = [(c, "host") for c in CHUNK_SIZES]
    if not args.host_only:
        configs += [(c, "device") for c in CHUNK_SIZES if c > 1]
    results = measure_all(configs, steps, device=device)

    legacy = next(r for r in results
                  if r["chunk_size"] == 1 and r["backend"] == "host")

    def rate(chunk, backend=None):
        rates = [r["steps_per_s"] for r in results if r["chunk_size"] == chunk
                 and (backend is None or r["backend"] == backend)]
        return max(rates) if rates else None

    def speedup(chunk, backend=None):
        r = rate(chunk, backend)
        return r / legacy["steps_per_s"] if r else None

    payload = {
        "bench": "loop_overhead",
        "model": "qwen3-0.6b smoke",
        "steps": steps,
        "results": results,
        # headline: the best chunked configuration vs the per-step loop
        "speedup_8_vs_1": speedup(8),
        "speedup_32_vs_1": speedup(32),
        # per-backend canaries so a regression in one mode can't hide
        # behind the other being faster
        "speedup_32_host_vs_1": speedup(32, "host"),
        "speedup_32_device_vs_1": speedup(32, "device"),
    }
    path = common.write_out(args.out, payload, device)
    for r in results:
        print(f"chunk_size={r['chunk_size']:>3} backend={r['backend']:<6} "
              f"{r['steps_per_s']:8.1f} steps/s")
    print(f"speedup 32 vs 1: {payload['speedup_32_vs_1']:.2f}x"
          + (f"  -> {path}" if path else ""))
    return payload


def run(quick: bool = True, device=None):
    """The harness contract: (name, us_per_call, derived), the rows the
    reference's ``run.py`` would give this bench (it has no ``run``)."""
    payload = main((["--quick"] if quick else [])
                   + (["--device", str(device)] if device else []))
    rows = [(f"loop.{r['backend']}_chunk{r['chunk_size']}",
             1e6 / r["steps_per_s"], f"{r['steps_per_s']:.1f}steps/s")
            for r in payload["results"]]
    rows.append(("loop.speedup_32_vs_1", 0.0,
                 f"{payload['speedup_32_vs_1']:.2f}x"))
    return rows


if __name__ == "__main__":
    main()
