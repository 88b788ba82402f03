"""Recovery drill: MTTR and chaos overhead of the fault-tolerance layer.
Reference: ``benchmarks/bench_recovery.py`` (``SPEC``, ``_cfg``, ``main``,
``run``: its arms, lines and payload).

Runs the tiny LM clean and under a seeded chaos plan (crash + slowdown +
checkpoint-write failures + preemption) with the recovery supervisor, and
measures what the paper's robustness argument costs:

* **MTTR** — wall-clock seconds from the crash to the restored Trainer
  resuming (``run_supervised``'s ``recover_times``: the rebuild, the
  checkpoint walk-back and restore, the injector resync);
* **chaos overhead** — supervised-chaos wall time over the fault-free
  wall time (recomputed steps + recovery machinery);
* **loss delta** — final loss under chaos minus fault-free (recovery must
  not change what is learned).

Chunks of 4 steps: on the card each a replay of the step graph (a
restored trainer captures its own). Checkpoints go to a temporary
directory. Returns the payload; writes it only to ``--out PATH``.

    python -m repro_torch.benchmarks.bench_recovery [--device cpu] [--quick]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import tiny_lm_config
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      FaultConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.straggler import Uniform
from repro_torch.models.common import resolve_device
from repro_torch.train.loop import run_experiment
from repro_torch.train.supervisor import run_supervised

SPEC = "crash@5:w1,slow@3:w0,ckpt_io@7,preempt@10"


def _cfg(ckpt_dir: str, steps: int, spec: str = ""):
    return TrainConfig(
        model=tiny_lm_config(),
        shape=ShapeConfig("bench", 8, 12, "train"),
        aggregation=AggregationConfig(strategy="backup", num_workers=4,
                                      backup_workers=2),
        optimizer=OptimizerConfig(name="sgd", learning_rate=0.1,
                                  scale_lr_with_workers=False),
        checkpoint=CheckpointConfig(directory=ckpt_dir, every_steps=4),
        seed=0, total_steps=steps, chunk_size=4, log_every=4,
        faults=FaultConfig(spec=spec, seed=7))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="short run (CI canary settings)")
    ap.add_argument("--steps", type=int, default=None)
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    steps = args.steps or (16 if args.quick else 48)
    device = resolve_device(args.device)

    lat = Uniform(1.0, 2.0)
    with tempfile.TemporaryDirectory() as td:
        # warm the caches (and capture a graph) so neither arm pays a
        # first call
        run_experiment(_cfg(os.path.join(td, "w"), min(steps, 8)),
                       latency=lat, device=device)

        t0 = time.perf_counter()
        clean = run_experiment(_cfg(os.path.join(td, "clean"), steps),
                               latency=lat, device=device)
        common.sync(device)
        clean_s = time.perf_counter() - t0

        recover_times = []
        t0 = time.perf_counter()
        chaos = run_supervised(_cfg(os.path.join(td, "chaos"), steps, SPEC),
                               latency=lat, device=device,
                               recover_times=recover_times)
        common.sync(device)
        chaos_s = time.perf_counter() - t0

    loss_delta = chaos.metrics[-1]["loss"] - clean.metrics[-1]["loss"]
    mttr = (sum(recover_times) / len(recover_times)) if recover_times else 0.0
    events = [e["event"] for e in chaos.recovery_log]
    results = [{"arm": "clean", "steps": clean.steps, "wall_s": clean_s,
                "final_loss": clean.metrics[-1]["loss"]},
               {"arm": "chaos", "steps": chaos.steps, "wall_s": chaos_s,
                "final_loss": chaos.metrics[-1]["loss"],
                "restores": events.count("restore"),
                "recovery_events": len(chaos.recovery_log)}]
    payload = {
        "bench": "recovery",
        "model": "qwen3-0.6b smoke",
        "steps": steps,
        "fault_spec": SPEC,
        "results": results,
        "mttr_s": mttr,
        "chaos_overhead_x": chaos_s / clean_s,
        "loss_delta": loss_delta,
    }
    path = common.write_out(args.out, payload, device)

    for r in results:
        print(f"arm={r['arm']:<6} steps={r['steps']:>3} "
              f"wall {r['wall_s']:6.2f}s final_loss {r['final_loss']:.4f}")
    print(f"MTTR {mttr:.2f}s, chaos overhead "
          f"{payload['chaos_overhead_x']:.2f}x, loss delta "
          f"{loss_delta:+.4f}" + (f" -> {path}" if path else ""))
    return payload


def run(quick: bool = True, device=None):
    """The harness contract: (name, us_per_call, derived)."""
    payload = main((["--quick"] if quick else [])
                   + (["--device", str(device)] if device else []))
    return [
        ("recovery.mttr", payload["mttr_s"] * 1e6,
         f"{payload['mttr_s']:.2f}s"),
        ("recovery.chaos_overhead", 0.0,
         f"{payload['chaos_overhead_x']:.2f}x"),
        ("recovery.loss_delta", 0.0, f"{payload['loss_delta']:+.4f}"),
    ]


if __name__ == "__main__":
    main()
