"""Training launcher CLI of the port. Reference: ``src/repro/launch/train.py``.

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke \
        --steps 50 --strategy backup --workers 6 --backups 2 [--resume] \
        [--execution spmd] [--chunk-size 8] [--prefetch-depth 2] \
        [--device cpu]
    python -m repro_torch.launch.train --smoke --steps 50 \
        --strategy async --workers 6 [--chunk-size 8]
    python -m repro_torch.launch.train --smoke --steps 50 \
        --strategy softsync --workers 6 --softsync-c 2
    python -m repro_torch.launch.train --smoke --steps 50 \
        --execution spmd --mesh-data 2 [--mesh-model 2] [--grad-batch 2] \
        [--device cpu]
    python -m repro_torch.launch.train --smoke --steps 50 \
        --strategy backup --workers 6 --backups 2 \
        --faults 'crash@10:w2,slow@5:w0,preempt@30' --supervise
    python -m repro_torch.launch.train --smoke --steps 50 --chunk-size 8 \
        --straggler-backend device
    python -m repro_torch.launch.train --smoke --steps 50 \
        --strategy dynamic_backup [--dynamic-window 16] \
        [--latency-source measured]
    python -m repro_torch.launch.train --smoke --steps 50 --chunk-size 8 \
        --trace /tmp/train_trace.json --metrics /tmp/train_metrics.jsonl

The reference's flags, plus ``--device``: the run is on the card unless
``--device cpu`` is given (without a card it raises). Everything routes
through ``repro_torch.train.loop.run_experiment`` with the paper's lr rule,
EMA, atomic checkpoints and the reference's metric lines: mask strategies
(backup, full_sync, timeout) through the straggler simulator and the masked
step, event strategies (async, softsync; W = ``--workers`` machines, no
backups) through the discrete-event parameter server. On the card,
``--execution spmd`` aggregates through the ``backup_reduce`` kernel;
``--grad-batch`` batches the workers' gradients (the reference's default 0:
all local workers in one ``torch.func.vmap``; 1 one at a time; k groups of
k) and ``--mesh-data D --mesh-model M`` runs the workers over D x M ranks
(``distributed.mesh.spawn``: one process each, NCCL with a card each, else
gloo): the workers over the D positions of the ``'data'`` axis, each
worker's gradient tensor-parallel over the M ranks of a ``'model'`` group,
of which rank 0 prints the lines below and writes the checkpoints. Inside a
world that is already up (``torchrun``) the process joins it as its rank.
``--chunk-size K`` runs chunks of K steps (PS updates for the event
strategies; one captured CUDA graph replayed per step or arrival on the
card, a loop on the CPU), with ``--prefetch-depth`` chunks of batches built
ahead on a thread in mask mode, as in the reference.

``--straggler-backend device`` draws each chunk's batches, arrivals and
masks on the device. ``--faults`` attaches a seeded chaos plan
(``core.faults``; ``--fault-seed``) and ``--supervise`` runs it under the
recovery supervisor (``train.supervisor``, ``--max-restarts``), which
restores the last good checkpoint after a crash or preemption; the
recovery log is printed. ``dynamic_backup`` adapts its cutoff over
``--dynamic-window`` steps of simulated arrivals, or of the fenced wall
clock with ``--latency-source measured``. ``--trace PATH`` records the
host spans (``obs.Tracer``, a fence at each chunk edge) and exports them
as Chrome-trace JSON; ``--metrics PATH`` dumps the ``obs.MetricsRegistry``
as JSONL; in a world of ranks rank 0 records and writes them, as it writes
the checkpoints. The reference's cross-flag checks hold, with its
messages; ``--execution spmd`` with an event strategy is refused, as
there.

Refused by name: ``--platform`` (PyTorch picks the card by ``--device``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      ExecutionConfig, FaultConfig,
                                      OptimizerConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.straggler import PaperCalibrated
from repro_torch.distributed import mesh
from repro_torch.distributed.spmd_engine import validate_grad_batch
from repro_torch.models.common import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.loop import falls_back_to_sim, run_experiment
from repro_torch.train.supervisor import run_supervised

MASK_STRATEGIES = ("backup", "full_sync", "timeout", "dynamic_backup")
EVENT_STRATEGIES = ("async", "softsync")

# flag -> (argparse dest, why it is refused); refused when set
DEFERRED_FLAGS = {
    "--platform": ("platform", "none: PyTorch picks the card by --device"),
}


def _resolved_workers(args):
    """(backups, total launched) after defaults."""
    with_backups = args.strategy in ("backup", "dynamic_backup")
    backups = args.backups if args.backups is not None else (
        2 if with_backups else 0)
    total = args.workers + (backups if with_backups else 0)
    return backups, total


def build_config(args) -> TrainConfig:
    """args -> TrainConfig (the reference's mapping)."""
    model_cfg = (configs.get_smoke_config(args.arch) if args.smoke
                 else configs.get_config(args.arch))
    backups, total = _resolved_workers(args)
    deadline = args.deadline if args.deadline is not None else 2.0
    softsync_c = args.softsync_c if args.softsync_c is not None else 2
    return TrainConfig(
        model=model_cfg,
        shape=ShapeConfig("cli", args.seq, args.batch_per_worker * total,
                          "train"),
        aggregation=AggregationConfig(strategy=args.strategy,
                                      num_workers=args.workers,
                                      backup_workers=backups,
                                      deadline_s=deadline,
                                      softsync_c=softsync_c,
                                      dynamic_window=(args.dynamic_window
                                                      or 32),
                                      latency_source=args.latency_source),
        optimizer=OptimizerConfig(name=args.optimizer,
                                  learning_rate=args.lr,
                                  scale_lr_with_workers=True,
                                  ema_decay=0.999),
        checkpoint=CheckpointConfig(directory=args.ckpt,
                                    every_steps=args.ckpt_every),
        execution=ExecutionConfig(backend=args.execution,
                                  mesh_data=args.mesh_data or 1,
                                  mesh_model=args.mesh_model or 1,
                                  grad_batch=args.grad_batch or 0,
                                  bucket_size=args.bucket_size or 0),
        seed=args.seed, total_steps=args.steps, log_every=10,
        chunk_size=args.chunk_size,
        straggler_backend=args.straggler_backend,
        prefetch_depth=args.prefetch_depth,
        faults=FaultConfig(spec=args.faults or "", seed=args.fault_seed,
                           supervise=args.supervise,
                           max_restarts=args.max_restarts))


def _validate(ap: argparse.ArgumentParser, args) -> None:
    """Reject flags that are not ported and combinations that would
    silently do nothing (the reference's checks, with its messages)."""
    for flag, (dest, item) in DEFERRED_FLAGS.items():
        if getattr(args, dest) not in (None, False):
            ap.error(f"{flag} is not ported to repro_torch yet ({item})")
    if args.backups is not None and args.strategy not in ("backup",
                                                          "dynamic_backup"):
        ap.error(f"--backups only applies to --strategy backup or "
                 f"dynamic_backup (got --strategy {args.strategy})")
    if args.dynamic_window is not None and args.strategy != "dynamic_backup":
        ap.error(f"--dynamic-window only applies to --strategy "
                 f"dynamic_backup (got --strategy {args.strategy})")
    if args.strategy == "dynamic_backup" and args.straggler_backend != "host":
        ap.error("--strategy dynamic_backup selects on the host (stateful "
                 "adaptation): --straggler-backend must be host")
    if args.latency_source != "sim" and args.strategy != "dynamic_backup":
        ap.error(f"--latency-source measured only applies to --strategy "
                 f"dynamic_backup (got --strategy {args.strategy})")
    if args.faults and args.straggler_backend != "host":
        ap.error("--faults composes with host-planned arrivals only: "
                 "--straggler-backend must be host")
    if args.deadline is not None and args.strategy != "timeout":
        ap.error(f"--deadline only applies to --strategy timeout "
                 f"(got --strategy {args.strategy})")
    if args.softsync_c is not None and args.strategy != "softsync":
        ap.error(f"--softsync-c only applies to --strategy softsync "
                 f"(got --strategy {args.strategy})")
    if args.strategy in EVENT_STRATEGIES and args.straggler_backend != "host":
        ap.error(f"--straggler-backend device only applies to mask "
                 f"strategies (got --strategy {args.strategy})")
    for flag, value in (("--mesh-data", args.mesh_data),
                        ("--mesh-model", args.mesh_model),
                        ("--grad-batch", args.grad_batch),
                        ("--bucket-size", args.bucket_size)):
        if value is not None and args.execution != "spmd":
            ap.error(f"{flag} only applies to --execution spmd")
    if args.execution == "spmd":
        if args.strategy in EVENT_STRATEGIES:
            ap.error(f"--execution spmd only applies to mask strategies "
                     f"(got --strategy {args.strategy})")
        if args.straggler_backend != "host":
            ap.error("--execution spmd consumes host-planned masks: "
                     "--straggler-backend must be host")
        _, total = _resolved_workers(args)
        if total % (args.mesh_data or 1):
            ap.error(f"total workers ({total}) must be divisible by "
                     f"--mesh-data ({args.mesh_data})")
        if args.grad_batch is not None:
            try:
                validate_grad_batch(args.grad_batch,
                                    total // (args.mesh_data or 1))
            except ValueError as e:
                ap.error(f"--grad-batch: {e}")


def _run(args) -> None:
    """One run of the parsed flags; prints on rank 0 of a mesh's world
    (every process without one)."""
    cfg = build_config(args)
    resume = args.resume and ckpt_lib.latest_step(args.ckpt) is not None
    say = mesh.is_leader()
    # rank 0 records and writes the telemetry, as it writes the checkpoints
    tracer = Tracer() if args.trace and say else None
    metrics = MetricsRegistry() if args.metrics and say else None
    if resume and say:
        print(f"[train] resumed at step {ckpt_lib.latest_step(args.ckpt)}")
    if args.supervise:
        res = run_supervised(cfg, latency=PaperCalibrated(),
                             device=args.device, tracer=tracer,
                             metrics=metrics)
    else:
        res = run_experiment(cfg, latency=PaperCalibrated(),
                             device=args.device, resume=resume,
                             save_final=True, tracer=tracer, metrics=metrics)
    if not say:
        return
    for e in res.recovery_log:
        fields = " ".join(f"{k}={v}" for k, v in e.items() if k != "event")
        print(f"[train] recovery: {e['event']} {fields}")
    for m in res.metrics:
        print(f"[train] step {m['step']:5d} loss {m['loss']:.4f} "
              f"sim {m['sim_time']:8.1f}s selected {m['selected']} "
              f"staleness {m['staleness']:.1f}")
    print(f"[train] done: {res.steps} steps, sim_time {res.sim_time:.0f}s, "
          f"mean_selected {res.mean_selected:.2f}, "
          f"mean_staleness {res.mean_staleness:.2f}, "
          f"restarts {res.restarts}, checkpoint {args.ckpt}")
    if res.phase_times:
        breakdown = " ".join(f"{k} {v:.2f}s"
                             for k, v in sorted(res.phase_times.items()))
        print(f"[train] wall {res.wall_time_s:.2f}s ({breakdown})",
              flush=True)
    else:
        print(f"[train] wall {res.wall_time_s:.2f}s", flush=True)
    if tracer is not None:
        tracer.export(args.trace)
        print(f"[train] trace: {args.trace} ({len(tracer)} events, "
              f"{tracer.dropped} dropped)", flush=True)
    if metrics is not None:
        metrics.dump_jsonl(args.metrics)
        print(f"[train] metrics: {args.metrics} ({len(metrics)} series)",
              flush=True)


def _rank_main(rank: int, device, args) -> None:
    """A rank of ``--mesh-data D --mesh-model M`` (``mesh.spawn``): the run
    on its card."""
    _run(argparse.Namespace(**{**vars(args), "device": str(device)}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=configs.list_archs(),
                    default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda), which must "
                         "be present unless 'cpu' is given")
    ap.add_argument("--steps", type=int, default=50, help="training steps")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--strategy", default="backup",
                    choices=list(MASK_STRATEGIES) + list(EVENT_STRATEGIES))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--backups", type=int, default=None,
                    help="backup workers b (backup strategy only; default 2)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="aggregation deadline s (timeout strategy only; "
                         "default 2.0)")
    ap.add_argument("--softsync-c", type=int, default=None)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--optimizer", default="rmsprop_momentum")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-size", type=int, default=1,
                    help="steps per chunk: one CUDA graph replayed per step "
                         "on the card (1 = the eager per-step loop)")
    ap.add_argument("--straggler-backend", choices=["host", "device"],
                    default="host",
                    help="'device' draws each chunk's batches, arrivals and "
                         "masks on the device (chunk size > 1)")
    ap.add_argument("--execution", choices=["sim", "spmd"], default="sim",
                    help="'spmd' computes each worker's own gradient and "
                         "aggregates them with the backup_reduce kernel; "
                         "'sim' differentiates the mask-weighted loss")
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="ranks on the 'data' (worker) axis (spmd only; "
                         "total workers must divide evenly): one process "
                         "each, NCCL with a card each, else gloo")
    ap.add_argument("--mesh-model", type=int, default=None,
                    help="ranks on the 'model' (tensor-parallel) axis "
                         "(spmd only): each worker's gradient over M "
                         "ranks, each holding 1/M of the heads, FFN width "
                         "and vocabulary")
    ap.add_argument("--grad-batch", type=int, default=None,
                    help="per-rank worker-gradient batching (spmd only): "
                         "0 = all local workers in one torch.func.vmap "
                         "(the default), 1 = one worker at a time, k = "
                         "groups of k (must divide total workers / "
                         "mesh-data)")
    ap.add_argument("--bucket-size", type=int, default=None,
                    help="lanes of the flattened gradient per reduce bucket "
                         "(spmd only; 0 = one bucket)")
    ap.add_argument("--platform", choices=["cpu", "gpu", "tpu"], default=None)
    ap.add_argument("--prefetch-depth", type=int, default=1,
                    help="chunks of batches built ahead on a thread "
                         "(chunked loop; 1 = double buffering)")
    ap.add_argument("--dynamic-window", type=int, default=None,
                    help="steps the adaptive cutoff is estimated over "
                         "(dynamic_backup only; default 32)")
    ap.add_argument("--faults", default=None,
                    help="chaos plan spec, e.g. 'crash@10:w2,slow@5:w0,"
                         "ckpt_io@20,preempt@30', or 'crash=2,slow=3' for "
                         "seeded-random placement")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of random fault placement")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the recovery supervisor: a crash or "
                         "preemption restores the last good checkpoint "
                         "and continues")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="the supervisor's restart budget")
    ap.add_argument("--latency-source", choices=["sim", "measured"],
                    default="sim",
                    help="dynamic_backup's adaptation window: the "
                         "simulated arrivals, or the fenced wall clock a "
                         "step")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record host-side spans and export Chrome-trace "
                         "JSON here (load at ui.perfetto.dev); fences the "
                         "card at chunk edges")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the metrics registry as JSONL here (one "
                         "object per metric)")
    args = ap.parse_args(argv)
    _validate(ap, args)
    d, m = args.mesh_data or 1, args.mesh_model or 1
    # a strategy the spmd engine does not take runs 'sim' (with the
    # trainer's warning) and starts no world
    if d * m > 1 and falls_back_to_sim(build_config(args)):
        d = m = 1
    if d * m > 1 and not torch.distributed.is_initialized():
        if args.device is None:
            resolve_device(None)          # raises without a card
        if "RANK" not in os.environ:      # one new process per rank
            mesh.spawn(_rank_main, d, args.device or "cuda", args=(args,),
                       mesh_model=m)
            return
        mesh.join(d, args.device or "cuda", mesh_model=m)   # from torchrun
    _run(args)


if __name__ == "__main__":
    main()
