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

The reference's flags of later slices are refused by name, with the
ROADMAP item that ports them: ``--straggler-backend device``,
``dynamic_backup`` (with ``--dynamic-window`` / ``--latency-source``),
``--faults`` / ``--supervise`` (``--fault-seed``, ``--max-restarts``),
``--trace`` / ``--metrics`` and ``--platform``; so is ``--execution
spmd`` with an event strategy, which the reference refuses too.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      ExecutionConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.straggler import PaperCalibrated
from repro_torch.distributed import mesh
from repro_torch.distributed.spmd_engine import validate_grad_batch
from repro_torch.models.common import resolve_device
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.loop import run_experiment

MASK_STRATEGIES = ("backup", "full_sync", "timeout", "dynamic_backup")
EVENT_STRATEGIES = ("async", "softsync")
PORTED_STRATEGIES = ("backup", "full_sync", "timeout", "async", "softsync")

_Q = "ROADMAP Queue 1 item"
# flag -> (argparse dest, the ROADMAP item that ports it); refused when set
DEFERRED_FLAGS = {
    "--dynamic-window": ("dynamic_window", f"{_Q} 7, dynamic_backup"),
    "--faults": ("faults", f"{_Q} 7, fault tolerance"),
    "--fault-seed": ("fault_seed", f"{_Q} 7, fault tolerance"),
    "--supervise": ("supervise", f"{_Q} 7, fault tolerance"),
    "--max-restarts": ("max_restarts", f"{_Q} 7, fault tolerance"),
    "--trace": ("trace", f"{_Q} 7, telemetry"),
    "--metrics": ("metrics", f"{_Q} 7, telemetry"),
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
                                      softsync_c=softsync_c),
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
        prefetch_depth=args.prefetch_depth)


def _validate(ap: argparse.ArgumentParser, args) -> None:
    """Reject flags of later slices and combinations that would silently
    do nothing."""
    for flag, (dest, item) in DEFERRED_FLAGS.items():
        if getattr(args, dest) not in (None, False):
            ap.error(f"{flag} is not ported to repro_torch yet ({item})")
    if args.strategy not in PORTED_STRATEGIES:
        ap.error(f"--strategy {args.strategy} is not ported to repro_torch "
                 f"yet ({_Q} 7, dynamic_backup); ported: "
                 f"{', '.join(PORTED_STRATEGIES)}")
    if args.latency_source != "sim":
        ap.error(f"--latency-source {args.latency_source} is not ported to "
                 f"repro_torch yet ({_Q} 7, dynamic_backup)")
    if args.straggler_backend != "host":
        ap.error(f"--straggler-backend {args.straggler_backend} is not "
                 f"ported to repro_torch yet ({_Q} 6)")
    if args.strategy in EVENT_STRATEGIES and args.execution == "spmd":
        ap.error(f"--execution spmd only applies to mask strategies (got "
                 f"--strategy {args.strategy}); event strategies run on the "
                 f"sim backend ({_Q} 6)")
    if args.backups is not None and args.strategy != "backup":
        ap.error(f"--backups only applies to --strategy backup "
                 f"(got --strategy {args.strategy})")
    if args.deadline is not None and args.strategy != "timeout":
        ap.error(f"--deadline only applies to --strategy timeout "
                 f"(got --strategy {args.strategy})")
    if args.softsync_c is not None and args.strategy != "softsync":
        ap.error(f"--softsync-c only applies to --strategy softsync "
                 f"(got --strategy {args.strategy})")
    for flag, value in (("--mesh-data", args.mesh_data),
                        ("--mesh-model", args.mesh_model),
                        ("--grad-batch", args.grad_batch),
                        ("--bucket-size", args.bucket_size)):
        if value is not None and args.execution != "spmd":
            ap.error(f"{flag} only applies to --execution spmd")
    if args.execution == "spmd":
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
    if resume and say:
        print(f"[train] resumed at step {ckpt_lib.latest_step(args.ckpt)}")
    res = run_experiment(cfg, latency=PaperCalibrated(), device=args.device,
                         resume=resume, save_final=True)
    if not say:
        return
    for m in res.metrics:
        print(f"[train] step {m['step']:5d} loss {m['loss']:.4f} "
              f"sim {m['sim_time']:8.1f}s selected {m['selected']} "
              f"staleness {m['staleness']:.1f}")
    print(f"[train] done: {res.steps} steps, sim_time {res.sim_time:.0f}s, "
          f"mean_selected {res.mean_selected:.2f}, "
          f"mean_staleness {res.mean_staleness:.2f}, "
          f"restarts {res.restarts}, checkpoint {args.ckpt}")
    print(f"[train] wall {res.wall_time_s:.2f}s", flush=True)


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
                    default="host")
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
    ap.add_argument("--dynamic-window", type=int, default=None)
    ap.add_argument("--faults", default=None)
    ap.add_argument("--fault-seed", type=int, default=None)
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--latency-source", choices=["sim", "measured"],
                    default="sim")
    ap.add_argument("--trace", default=None, metavar="PATH")
    ap.add_argument("--metrics", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    _validate(ap, args)
    d, m = args.mesh_data or 1, args.mesh_model or 1
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
