"""Where the training step's time goes on the card: a torch.profiler window.

    python -m repro_torch.launch.profile_train [--arch rwkv6-1.6b] [--graph]

Builds a full-width training run (``train_config``, which
``chip_smoke.py`` drives too): qwen3-0.6b (28 layers, bf16, remat full;
backup 6 + 2 workers) or rwkv6-1.6b (24 layers, bf16, remat full, every
layer's wkv through the ``rwkv6_scan`` kernels; backup 3 + 1 workers, the
most whose [W, P] f32 gradient stack and optimizer state fit the card's
80 GB), each with 2 x 256 tokens per worker, rmsprop_momentum, EMA 0.999,
the spmd backend at mesh 1 x 1, one worker at a time, the
``backup_reduce`` kernel. It profiles two steady steps, printing what
``profile_serve`` prints for a serve phase (host wall per step,
unprofiled and profiled; device busy per step; the device's idle share;
kernel launches per step; kernels and ops ranked) and, for each of the
engine's three phases (``spmd/worker_grad`` once per worker,
``spmd/reduce``, ``spmd/update``), its host wall time and the device busy
time (the union of the kernel and copy intervals inside the phase's
device span). With ``--graph`` it then builds the same run at
``chunk_size`` 3 (the trainer's CUDA graph: one captured step replayed
per step) and profiles two steady chunks the same way, per step: host
wall, device busy, the idle share and the launches; the capture's time
and the peak device memory (allocated and reserved) are printed. A replay
records no ``record_function`` range, so the per-phase table comes from
the eager steps. Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc

import torch
from torch.autograd import DeviceType

from repro_torch import configs
from repro_torch.configs import (AggregationConfig, CheckpointConfig,
                                 ExecutionConfig, OptimizerConfig,
                                 ShapeConfig, TrainConfig)
from repro_torch.launch.profile_serve import _on_device, _profile, _union_us
from repro_torch.models.common import resolve_device
from repro_torch.train.loop import Trainer

STEPS = 2
CHUNK = 3            # steps per chunk in the graph mode
PHASES = ("spmd/worker_grad", "spmd/reduce", "spmd/update")
# arch -> backup (N, b). rwkv6-1.6b: P = 1,584,095,232, so the [W, P] f32
# stack is 6.34 GB per worker beside 12.67 GB of rmsprop_momentum state and
# 6.34 GB each of EMA and f32 aggregate: W = 4 needs ~65 GB, W = 8 ~91 GB.
WORKERS = {"qwen3-0.6b": (6, 2), "rwkv6-1.6b": (3, 1)}


def train_config(arch: str = "qwen3-0.6b", *, backend: str = "spmd",
                 use_kernel=None, steps: int = 3) -> TrainConfig:
    """A full-width training run (the ones ``chip_smoke.py`` drives):
    ``arch`` at its published widths, backup ``WORKERS[arch]`` workers with
    2 sequences of 256 tokens each, rmsprop_momentum lr 0.02 x N, EMA
    0.999, seed 0, ``steps`` steps, no checkpoint, one worker at a time and
    a single reduce bucket on the ``backend``."""
    n, b = WORKERS[arch]
    return TrainConfig(
        model=configs.get_config(arch),
        shape=ShapeConfig("full", 256, 2 * (n + b), "train"),
        aggregation=AggregationConfig(strategy="backup", num_workers=n,
                                      backup_workers=b),
        optimizer=OptimizerConfig(name="rmsprop_momentum",
                                  learning_rate=0.02,
                                  scale_lr_with_workers=True,
                                  ema_decay=0.999),
        checkpoint=CheckpointConfig(every_steps=0),
        execution=ExecutionConfig(backend=backend, use_kernel=use_kernel,
                                  grad_batch=1, bucket_size=0),
        seed=0, total_steps=steps, log_every=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(WORKERS), default="qwen3-0.6b")
    ap.add_argument("--graph", action="store_true",
                    help="then profile chunks of 3 steps through the CUDA "
                         "graph")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    cfg = train_config(args.arch)
    tr = Trainer(cfg, device=dev)
    tr.init_state()
    agg = cfg.aggregation
    print(f"[profile] {torch.cuda.get_device_name(0)} torch "
          f"{torch.__version__} | {cfg.model.name} {cfg.model.num_layers} "
          f"layers {cfg.model.dtype}, backup {agg.num_workers}+"
          f"{agg.backup_workers}, {cfg.shape.global_batch} x "
          f"{cfg.shape.seq_len} tokens/step, spmd mesh 1x1")
    prof = _profile("train step", lambda: tr.run(1), STEPS)
    events = prof.events()
    on_device = [(e.time_range.start, e.time_range.end) for e in events
                 if _on_device(e)]
    for name in PHASES:
        host = [e for e in events if e.name == name
                and e.device_type == DeviceType.CPU]
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == name and e.device_type == DeviceType.CUDA]
        busy = _union_us((max(s, a), min(t, b)) for a, b in spans
                         for s, t in on_device if s < b and t > a)
        wall = sum(e.time_range.end - e.time_range.start for e in host)
        print(f"    {name}: x{len(host) / STEPS:.0f} per step, host wall "
              f"{wall / 1e3 / STEPS:.1f} ms/step, device busy "
              f"{busy / 1e3 / STEPS:.1f} ms/step")
    print(f"[profile] peak device memory {torch.cuda.max_memory_allocated()} "
          f"bytes")
    if not args.graph:
        return
    del tr, prof, events
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(dataclasses.replace(cfg, chunk_size=CHUNK), device=dev)
    tr.init_state()
    _profile("train chunk graph, per step", lambda: tr.run(CHUNK), STEPS,
             per_call=CHUNK)
    g = tr.chunk_step.graph
    print(f"[profile] graph: {g.captures} capture in {g.capture_s:.3f} s "
          f"(the capture alone; the eager warmup step before it is a real "
          f"step), {g.replays} replays | peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes allocated, "
          f"{torch.cuda.max_memory_reserved()} reserved")


if __name__ == "__main__":
    main()
