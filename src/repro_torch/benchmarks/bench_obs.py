"""Telemetry bench: tracer overhead + perfmodel prediction vs measured.
Reference: ``benchmarks/bench_obs.py`` (``_build_trainer``,
``_fenced_step_s``, ``_null_hook_cost_s``, ``main``, ``run``: its numbers,
lines and payload).

* ``tracer_overhead_pct`` — the disabled-tracing path. Every
  instrumentation site in the chunked trainer costs one shared no-op
  context manager per hook when no tracer is passed; this measures that
  hook cost directly (a tight loop over ``obs.trace.NULL``) and expresses
  it against the measured per-chunk wall time. The hooks a chunk opens
  are counted, not assumed (the reference's ``HOOKS_PER_CHUNK = 5``): the
  ``train/*`` spans a traced run records per ``train/chunk``
  (``hooks_per_chunk`` in the payload).
* ``predicted_vs_measured_err`` — the analytic FLOP model
  (``analysis.perfmodel.cell_flops``) is calibrated on ONE shape (achieved
  FLOP/s = predicted train FLOPs / fenced measured step time), then
  predicts the step time of the remaining shapes; the reported number is
  the mean relative error of those predictions against fenced
  measurements (the trainer's ``dispatch_s``, a ``torch.cuda.synchronize``
  at each chunk edge on the card).

Also reports ``traced_overhead_pct`` — the cost of *enabled* tracing
(spans + chunk-edge fences) against the fence-only baseline. Returns the
payload; writes it only to ``--out PATH``.

    python -m repro_torch.benchmarks.bench_obs [--device cpu] [--quick]
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.analysis.perfmodel import cell_flops
from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import tiny_lm_config
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      OptimizerConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.straggler import Uniform
from repro_torch.models.common import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.obs.trace import NULL
from repro_torch.train.loop import Trainer

CHUNK = 8


def _build_trainer(seq: int, batch: int, tmpdir: str, tracer=None,
                   metrics=None, device=None):
    cfg = TrainConfig(
        model=tiny_lm_config(),
        shape=ShapeConfig("bench_obs", seq, batch, "train"),
        aggregation=AggregationConfig(strategy="full_sync", num_workers=4),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                  scale_lr_with_workers=False),
        checkpoint=CheckpointConfig(directory=tmpdir, every_steps=0),
        log_every=1000, chunk_size=CHUNK, straggler_backend="host")
    tr = Trainer(cfg, latency=Uniform(1.0, 2.0), device=device,
                 tracer=tracer, metrics=metrics)
    tr.init_state()
    return tr


def _fenced_step_s(tr, warmup_steps: int, steps: int) -> float:
    """Mean fenced device-dispatch seconds per step (data time excluded:
    the FLOP model predicts compute, not host staging)."""
    tr.run(warmup_steps)
    d0, s0 = tr._phase["dispatch_s"], tr.step
    tr.run(steps)
    return (tr._phase["dispatch_s"] - d0) / (tr.step - s0)


def _null_hook_cost_s() -> float:
    """Per-hook cost of the disabled path: one shared no-op span."""
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with NULL.span("train/chunk"):
            pass
    return (time.perf_counter() - t0) / n


def hooks_per_chunk(tracer: Tracer) -> float:
    """The ``train/*`` spans a traced chunked run opened, per
    ``train/chunk`` (checkpoint saves excluded)."""
    names = [e["name"] for e in tracer.events if e.get("ph") == "X"
             and e["name"].startswith("train/")
             and e["name"] != "train/ckpt_save"]
    return len(names) / max(names.count("train/chunk"), 1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    quick = args.quick or common.quick_mode()
    device = resolve_device(args.device)

    warmup, steps = (8, 24) if quick else (16, 64)
    # calibration shape first; the rest are predicted from its FLOP/s
    shapes = [(32, 16), (64, 16), (32, 32)]
    model_cfg = tiny_lm_config()

    cells = []
    for seq, batch in shapes:
        with tempfile.TemporaryDirectory() as tmp:
            tr = _build_trainer(seq, batch, tmp, metrics=MetricsRegistry(),
                                device=device)
            step_s = _fenced_step_s(tr, warmup, steps)
        flops = cell_flops(model_cfg,
                           ShapeConfig("bench_obs", seq, batch, "train"))
        cells.append({"seq_len": seq, "global_batch": batch,
                      "measured_step_s": step_s,
                      "train_flops": flops.train})
        print(f"[obs] shape seq={seq} batch={batch}: "
              f"{step_s * 1e3:.2f} ms/step "
              f"({flops.train / step_s / 1e9:.2f} GFLOP/s)")

    calib = cells[0]
    flops_per_s = calib["train_flops"] / calib["measured_step_s"]
    errs = []
    for c in cells:
        c["predicted_step_s"] = c["train_flops"] / flops_per_s
        c["rel_err"] = (abs(c["predicted_step_s"] - c["measured_step_s"])
                        / c["measured_step_s"])
        if c is not calib:
            errs.append(c["rel_err"])
    predicted_vs_measured_err = sum(errs) / len(errs)

    # enabled-path overhead: spans + export bookkeeping vs fence-only
    tracer = Tracer()
    with tempfile.TemporaryDirectory() as tmp:
        tr = _build_trainer(32, 16, tmp, tracer=tracer,
                            metrics=MetricsRegistry(), device=device)
        traced_step_s = _fenced_step_s(tr, warmup, steps)
    traced_overhead_pct = 100.0 * max(
        traced_step_s - calib["measured_step_s"], 0.0) \
        / calib["measured_step_s"]

    # disabled-path overhead: measured hook cost vs the measured chunk
    hooks = hooks_per_chunk(tracer)
    hook_s = _null_hook_cost_s()
    chunk_s = calib["measured_step_s"] * CHUNK
    tracer_overhead_pct = 100.0 * hooks * hook_s / chunk_s

    payload = {
        "tracer_overhead_pct": tracer_overhead_pct,
        "traced_overhead_pct": traced_overhead_pct,
        "predicted_vs_measured_err": predicted_vs_measured_err,
        "null_hook_cost_us": hook_s * 1e6,
        "hooks_per_chunk": hooks,
        "calibration_flops_per_s": flops_per_s,
        "cells": cells,
        "quick": quick,
    }
    path = common.write_out(args.out, payload, device)
    print(f"[obs] tracer_overhead {tracer_overhead_pct:.4f}% "
          f"({hooks:g} hooks a chunk) "
          f"traced_overhead {traced_overhead_pct:.1f}% "
          f"predicted_vs_measured_err {predicted_vs_measured_err:.3f}")
    if path:
        print(f"-> {path}")
    return payload


def run(quick: bool = True, device=None):
    """The harness contract: (name, us_per_call, derived)."""
    payload = main((["--quick"] if quick else [])
                   + (["--device", str(device)] if device else []))
    rows = [("obs.tracer_overhead", 0.0,
             f"{payload['tracer_overhead_pct']:.4f}%"),
            ("obs.traced_overhead", 0.0,
             f"{payload['traced_overhead_pct']:.1f}%"),
            ("obs.predicted_vs_measured_err", 0.0,
             f"{payload['predicted_vs_measured_err']:.3f}")]
    rows += [(f"obs.step_s{c['seq_len']}x{c['global_batch']}",
              c["measured_step_s"] * 1e6,
              f"rel_err={c['rel_err']:.3f}") for c in payload["cells"]]
    return rows


if __name__ == "__main__":
    main()
