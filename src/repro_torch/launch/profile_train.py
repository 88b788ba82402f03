"""Where the training step's time goes on the card: a torch.profiler window.

    python -m repro_torch.launch.profile_train [--arch rwkv6-1.6b] [--graph] \
        [--grad-batch 0|k] [--mesh-data D] [--mesh-model M]
    python -m repro_torch.launch.profile_train --strategy async|softsync \
        [--arch rwkv6-1.6b] [--graph]

Builds a full-width training run (``train_config``, which ``chip_smoke.py``
drives too): qwen3-0.6b (28 layers, bf16, remat full; backup 6 + 2 workers)
or rwkv6-1.6b (24 layers, bf16, remat full, every layer's wkv through the
``rwkv6_scan`` kernels; backup 3 + 1 workers, the most whose [W, P] f32
gradient stack and optimizer state fit the card's 80 GB), each with 2 x 256
tokens per worker, rmsprop_momentum, EMA 0.999, the spmd backend, one worker
at a time (``--grad-batch`` k: groups of k workers through
``torch.func.vmap``, 0 all of them), the ``backup_reduce`` kernel, at mesh 1
x 1 (``--mesh-data D --mesh-model M``: D x M ranks, one card each through
NCCL, or gloo when the ranks share cards, the workers over the D positions
of the ``'data'`` axis and each worker's gradient tensor-parallel over a
``'model'`` group of M; rank 0 is profiled and prints, the others run the
same steps). It profiles two steady steps, printing what ``profile_serve``
prints for a serve phase (host wall per step, unprofiled and profiled;
device busy per step; the device's idle share; kernel launches per step;
kernels and ops ranked) and, for each of the engine's three phases
(``spmd/worker_grad`` once per worker, ``spmd/reduce``, ``spmd/update``),
its host wall time and the device busy time (the union of the kernel and
copy intervals inside the range's device span); then the model group's
all-reduces per step (``tp.all_reduces``) and each NCCL kernel's count and
device time per step (at D = 1 all of them are the model group's). With
``--graph`` it then builds the same run at ``chunk_size`` 3 (the trainer's
CUDA graph: one captured step replayed per step) and profiles two steady
chunks the same way, per step: host wall, device busy, the idle share and
the launches; the capture's time and the peak device memory (allocated and
reserved) are printed. A replay records no ``record_function`` range, so the
per-phase table comes from the eager steps; ``tp.all_reduces`` counts the
graph's captured all-reduces once per replay, and the NCCL kernels are
listed per step again.

With ``--strategy async`` or ``softsync`` it profiles the event regime
instead (``event_config``, which ``chip_smoke.py`` drives too: the same
model, W = 8 workers for qwen3-0.6b and 4 for rwkv6-1.6b, 2 x 256 tokens
per arrival, softsync c = 4, the sim backend): two steady updates per
arrival (the per-arrival loop; the phases ``event/grad``, ``event/update``
and ``event/read_copy`` of each arrival), then with ``--graph`` two
chunks of 3 updates through the event graphs, per arrival. Needs a card.
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
from repro_torch.distributed import mesh, tp
from repro_torch.launch.profile_serve import _on_device, _profile, _union_us
from repro_torch.models.common import resolve_device
from repro_torch.train.loop import Trainer

STEPS = 2
CHUNK = 3            # steps per chunk in the graph mode
PHASES = ("spmd/worker_grad", "spmd/reduce", "spmd/update")
EVENT_PHASES = ("event/grad", "event/update", "event/read_copy")
# arch -> workers of the event runs: rwkv6-1.6b keeps W read copies (3.17
# GB each in bf16) beside 12.67 GB of optimizer state and 6.34 GB of EMA
EVENT_WORKERS = {"qwen3-0.6b": 8, "rwkv6-1.6b": 4, "whisper-tiny": 4}
SOFTSYNC_C = 4
# arch -> backup (N, b). rwkv6-1.6b: P = 1,584,095,232, so the [W, P] f32
# stack is 6.34 GB per worker beside 12.67 GB of rmsprop_momentum state and
# 6.34 GB each of EMA and f32 aggregate: W = 4 needs ~65 GB, W = 8 ~91 GB.
# qwen2-moe-a2.7b and deepseek-v2-lite-16b train on the card only cut in
# depth (at full depth their [W, P] f32 stacks alone take 57 and 63 GB a
# worker); internvl2-2b's W = 4 at full depth would need ~73 GB (a 7.6 GB
# stack row a worker beside the RMSProp state and the EMA), so it is cut
# too. W = 4 for each, as rwkv6-1.6b's. hymba-1.5b (P = 1,299,664,064)
# needs ~45 GB at W = 4 and full depth. whisper-tiny trains through event
# strategies only (its batches carry frames, which the synthetic pipeline
# does not make): its entry is event_config's base.
WORKERS = {"qwen3-0.6b": (6, 2), "rwkv6-1.6b": (3, 1),
           "qwen2-moe-a2.7b": (3, 1), "deepseek-v2-lite-16b": (3, 1),
           "internvl2-2b": (3, 1), "hymba-1.5b": (3, 1),
           "whisper-tiny": (3, 1)}


def train_config(arch: str = "qwen3-0.6b", *, backend: str = "spmd",
                 use_kernel=None, steps: int = 3, grad_batch: int = 1,
                 mesh_data: int = 1, mesh_model: int = 1) -> TrainConfig:
    """A full-width training run (the ones ``chip_smoke.py`` drives):
    ``arch`` at its published widths, backup ``WORKERS[arch]`` workers with
    2 sequences of 256 tokens each, rmsprop_momentum lr 0.02 x N, EMA
    0.999, seed 0, ``steps`` steps, no checkpoint, ``grad_batch`` workers'
    gradients at a time (1: one at a time), a single reduce bucket, on the
    ``backend`` over a ``mesh_data`` x ``mesh_model`` mesh of ranks."""
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
                                  grad_batch=grad_batch, bucket_size=0,
                                  mesh_data=mesh_data,
                                  mesh_model=mesh_model),
        seed=0, total_steps=steps, log_every=1)


def event_config(arch: str = "qwen3-0.6b", strategy: str = "async", *,
                 steps: int = 8, chunk: int = 1) -> TrainConfig:
    """A full-width event run (the ones ``chip_smoke.py`` drives):
    ``arch`` at its published widths, ``EVENT_WORKERS[arch]`` workers each
    drawing 2 sequences of 256 tokens per arrival, ``strategy`` async or
    softsync (c = ``SOFTSYNC_C``), rmsprop_momentum at lr 0.02 (not scaled
    by W: every arrival applies its own update), EMA 0.999, seed 0,
    ``steps`` PS updates, the sim backend, ``chunk`` updates per chunk."""
    w = EVENT_WORKERS[arch]
    cfg = train_config(arch, backend="sim", steps=steps)
    return dataclasses.replace(
        cfg, shape=ShapeConfig("full", 256, 2 * w, "train"),
        aggregation=AggregationConfig(
            strategy=strategy, num_workers=w,
            softsync_c=SOFTSYNC_C if strategy == "softsync" else 1),
        optimizer=dataclasses.replace(cfg.optimizer,
                                      scale_lr_with_workers=False),
        chunk_size=chunk)


def _phase_table(events, phases, per: int) -> None:
    """Host wall and device busy of each ``record_function`` range, per
    ``per`` (steps or arrivals)."""
    on_device = [(e.time_range.start, e.time_range.end) for e in events
                 if _on_device(e)]
    for name in phases:
        host = [e for e in events if e.name == name
                and e.device_type == DeviceType.CPU]
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == name and e.device_type == DeviceType.CUDA]
        busy = _union_us((max(s, a), min(t, b)) for a, b in spans
                         for s, t in on_device if s < b and t > a)
        wall = sum(e.time_range.end - e.time_range.start for e in host)
        print(f"    {name}: x{len(host) / per:.2f} per unit, host wall "
              f"{wall / 1e3 / per:.1f} ms/unit, device busy "
              f"{busy / 1e3 / per:.1f} ms/unit")


def _main_event(args, dev) -> None:
    cfg = event_config(args.arch, args.strategy, steps=1)
    per_update = SOFTSYNC_C if args.strategy == "softsync" else 1
    tr = Trainer(cfg, device=dev)
    tr.init_state()
    agg = cfg.aggregation
    print(f"[profile] {torch.cuda.get_device_name(0)} torch "
          f"{torch.__version__} | {cfg.model.name} {cfg.model.num_layers} "
          f"layers {cfg.model.dtype}, {agg.strategy} W={agg.num_workers}"
          f"{f' c={agg.softsync_c}' if agg.strategy == 'softsync' else ''}"
          f", {cfg.shape.seq_len * cfg.shape.global_batch // agg.num_workers}"
          f" tokens/arrival, {per_update} arrivals/update; figures per "
          f"arrival")
    prof = _profile(f"event {agg.strategy}, per arrival",
                    lambda: tr.run(1), STEPS, per_call=per_update)
    print("  phases per arrival (unit = arrival):")
    _phase_table(prof.events(), EVENT_PHASES, STEPS * per_update)
    print(f"[profile] peak device memory {torch.cuda.max_memory_allocated()} "
          f"bytes allocated, {torch.cuda.max_memory_reserved()} reserved")
    if not args.graph:
        return
    del tr, prof
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(dataclasses.replace(cfg, chunk_size=CHUNK), device=dev)
    tr.init_state()
    _profile(f"event {agg.strategy} graph, per arrival",
             lambda: tr.run(CHUNK), STEPS, per_call=CHUNK * per_update)
    g = tr._event_chunk.graphs
    print(f"[profile] event graphs: captures apply {g[True].captures} / "
          f"buffer {g[False].captures} in "
          f"{g[True].capture_s + g[False].capture_s:.3f} s, replays "
          f"{g[True].replays} / {g[False].replays} | peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes allocated, "
          f"{torch.cuda.max_memory_reserved()} reserved")


def _steps(name: str, fn, calls: int, per_call: int = 1):
    """``_profile`` on rank 0; the other ranks of the mesh run the same
    calls (3 warmups, ``calls`` timed, ``calls`` profiled), since every
    step is a collective."""
    if mesh.is_leader():
        return _profile(name, fn, calls, per_call=per_call)
    for _ in range(3 + 2 * calls):
        fn()
    torch.cuda.synchronize()
    return None


def _main_mask(args, dev) -> None:
    say = mesh.is_leader()
    cfg = train_config(args.arch, grad_batch=args.grad_batch,
                       mesh_data=args.mesh_data, mesh_model=args.mesh_model)
    tr = Trainer(cfg, device=dev)
    tr.init_state()
    agg = cfg.aggregation
    mesh_name = f"{args.mesh_data}x{args.mesh_model}"
    if say:
        print(f"[profile] {torch.cuda.get_device_name(dev)} torch "
              f"{torch.__version__} | {cfg.model.name} "
              f"{cfg.model.num_layers} layers {cfg.model.dtype}, backup "
              f"{agg.num_workers}+{agg.backup_workers}, "
              f"{cfg.shape.global_batch} x {cfg.shape.seq_len} tokens/step, "
              f"spmd mesh {mesh_name} ({mesh.backend() or 'one card'})"
              f", grad_batch {args.grad_batch}")
    before = tp.all_reduces
    prof = _steps("train step", lambda: tr.run(1), STEPS)
    # 3 warmups, the timed and the profiled calls
    per_step = (tp.all_reduces - before) / (3 + 2 * STEPS)
    if say:
        print("  phases per step (unit = step):")
        _phase_table(prof.events(), PHASES, STEPS)
        print(f"[profile] model-group all-reduces {per_step:.1f} per step "
              f"(tp.all_reduces)")
        _nccl_table(prof, STEPS)
        print(f"[profile] peak device memory "
              f"{torch.cuda.max_memory_allocated(dev)} bytes allocated, "
              f"{torch.cuda.max_memory_reserved(dev)} reserved")
    if not args.graph:
        return
    del tr, prof
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(dataclasses.replace(cfg, chunk_size=CHUNK), device=dev)
    tr.init_state()
    before = tp.all_reduces
    prof = _steps("train chunk graph, per step", lambda: tr.run(CHUNK),
                  STEPS, per_call=CHUNK)
    per_step = (tp.all_reduces - before) / ((3 + 2 * STEPS) * CHUNK)
    g = tr.chunk_step.graph
    if say:
        print(f"[profile] graph: {g.captures} capture in {g.capture_s:.3f} "
              f"s (the capture alone; the eager warmup step before it is a "
              f"real step), {g.replays} replays | model-group all-reduces "
              f"{per_step:.1f} per step (tp.all_reduces, replays included) "
              f"| peak device memory "
              f"{torch.cuda.max_memory_allocated(dev)} bytes allocated, "
              f"{torch.cuda.max_memory_reserved(dev)} reserved")
        _nccl_table(prof, STEPS * CHUNK)


def _nccl_table(prof, per: int) -> None:
    """Count and device time per ``per`` (steps) of each NCCL kernel: at
    mesh_data 1 all of them are the model group's all-reduces; at D > 1
    the data group's all-reduce of a bucket (f32) is among the f32 ones.
    (A ``tp/all_reduce`` range has no device span: NCCL launches on its
    own stream.)"""
    rows = [e for e in prof.key_averages()
            if _on_device(e) and "nccl" in e.key.lower()]
    for e in rows:
        print(f"    {e.key.split('(')[0]}: x{e.count / per:.1f} per step, "
              f"device {e.self_device_time_total / 1e3 / per:.3f} ms/step")
    total = sum(e.self_device_time_total for e in rows) / 1e3 / per
    print(f"[profile] NCCL kernels {sum(e.count for e in rows) / per:.1f} "
          f"per step, {total:.3f} ms/step device time")


def _rank_main(rank: int, device, args) -> None:
    _main_mask(args, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(WORKERS), default="qwen3-0.6b")
    ap.add_argument("--graph", action="store_true",
                    help="then profile chunks of 3 steps through the CUDA "
                         "graph")
    ap.add_argument("--strategy", choices=["backup", "async", "softsync"],
                    default="backup",
                    help="backup: the mask-mode run; async / softsync: the "
                         "event regime (event_config)")
    ap.add_argument("--grad-batch", type=int, default=1,
                    help="workers' gradients at a time (mask run): 1 one "
                         "at a time, k groups of k, 0 all")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="ranks on the 'data' axis (mask run)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks on the 'model' (tensor-parallel) axis "
                         "(mask run)")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.strategy != "backup":
        return _main_event(args, dev)
    if args.mesh_data * args.mesh_model > 1:
        return mesh.spawn(_rank_main, args.mesh_data, "cuda", args=(args,),
                          mesh_model=args.mesh_model)
    _main_mask(args, dev)


if __name__ == "__main__":
    main()
