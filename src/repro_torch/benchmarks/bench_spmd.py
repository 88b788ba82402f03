"""SPMD execution engine vs the single-device simulated backend.
Reference: ``benchmarks/bench_spmd.py`` (``WORKER_COUNTS``,
``CHUNK_SIZES``, ``MESH_MODELS``, ``build_trainer``,
``collective_bytes_per_step``, ``measure_all``, ``main``, ``run``: its
cells, keys and lines).

Measures wall-clock steps/s of the tiny-LM backup-worker rig for W in
{4, 8} workers, chunk_size in {1, 32} and mesh_model M in {1, 2}, on both
execution backends: ``sim`` (one device, workers as a loop index) and
``spmd`` (``distributed.spmd_engine``: each worker's own gradient, the
masked ``backup_reduce`` and one all-reduce a bucket over the ``'data'``
axis; at M = 2 the parameters, optimizer state and EMA sharded over the
``'model'`` axis and each gradient computed tensor-parallel).

The reference forces 16 host devices into one process. Here a mesh is a
``torch.distributed`` world of D x M ranks (``distributed.mesh``: NCCL
with a card a rank, gloo on the CPU), started from a ``forkserver`` that
imports torch once; ``W / D`` workers sit on each rank as a ``[W_local,
P]`` stack. D is ``--mesh-data`` (default W, the reference's
``mesh_data = workers``). A cell whose D x M exceeds the visible cards
raises, naming the count it needs; nothing is shrunk quietly, and the
keys of a cell run at D != W carry ``_d{D}``. A cell of one rank runs in
this process beside the sim cells; each world times its cells in turns,
rank 0 reporting. Chunks above 1 replay the step graph on the card.

Each spmd cell also reports the BYTES-MOVED axis: the collectives of one
step as ``launch.dryrun.plan_train`` records them on rank 0 of the
cell's mesh (in place of the reference's count parsed from the HLO; a
chunk replays the same step K times, so its per-step figure is the
step's). At ``bucket_size = 0`` the data axis carries one all-reduce of
``P_local + 2`` f32 lanes a step (the reduced gradient, the loss and aux
sums riding it); sim cells move nothing.

Returns the payload; writes it only to ``--out PATH`` (the JSON
``check_spmd_regression`` compares).

    python -m repro_torch.benchmarks.bench_spmd [--device cpu] [--quick]
        [--mesh-data D] [--workers 4 8] [--chunks 1 32] [--mesh-models 1 2]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import configs
from repro_torch.benchmarks import common
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      ExecutionConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig, replace)
from repro_torch.core.straggler import Uniform
from repro_torch.distributed import mesh
from repro_torch.kernels import counters
from repro_torch.launch import dryrun
from repro_torch.models.common import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.train.loop import Trainer

WORKER_COUNTS = (4, 8)
CHUNK_SIZES = (1, 32)
MESH_MODELS = (1, 2)
REPS = 5
_BACKUP_REDUCE = [m for m, _ in counters.COUNTERS].index("backup_reduce")

# (backend, workers, chunk_size, mesh_model, mesh_data)
Spec = Tuple[str, int, int, int, int]


def train_config(backend: str, workers: int, chunk_size: int,
                 mesh_model: int = 1, mesh_data: Optional[int] = None
                 ) -> TrainConfig:
    """The reference's rig: a 1-layer d32 model (dims divisible by
    ``mesh_model`` = 2 so the TP cells shard), backup W - 1 + 1, momentum,
    EMA; ``mesh_data`` defaults to ``workers``."""
    model = replace(configs.get_smoke_config("qwen3-0.6b"), num_layers=1,
                    d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                    d_ff=64, vocab_size=64, vocab_pad_multiple=16)
    return TrainConfig(
        model=model,
        shape=ShapeConfig("bench", 16, 2 * workers, "train"),
        aggregation=AggregationConfig(strategy="backup",
                                      num_workers=workers - 1,
                                      backup_workers=1),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.02,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.999),
        checkpoint=CheckpointConfig(every_steps=0),
        execution=ExecutionConfig(backend=backend,
                                  mesh_data=mesh_data or workers,
                                  mesh_model=mesh_model),
        log_every=1, chunk_size=chunk_size)


def build_trainer(backend: str, workers: int, chunk_size: int,
                  mesh_model: int = 1, tracer=None, metrics=None, *,
                  mesh_data: Optional[int] = None, device=None) -> Trainer:
    tr = Trainer(train_config(backend, workers, chunk_size, mesh_model,
                              mesh_data),
                 latency=Uniform(1.0, 2.0), device=device, tracer=tracer,
                 metrics=metrics)
    tr.init_state()
    return tr


def collective_bytes_per_step(cfg: TrainConfig) -> Dict[str, float]:
    """The bytes-moved axis of ``cfg``'s cell: the collectives of one step
    on rank 0 of its mesh (``dryrun.plan_train``, planned on ``meta`` in
    a world of torch's ``fake`` backend; call it outside any world). Sim
    cells are single-device and report zeros."""
    if cfg.execution.backend == "sim":
        return {"collective_bytes_per_step": 0.0,
                "collective_ops_per_step": 0.0}
    coll = dryrun.plan_train(cfg)["collectives"]
    return {"collective_bytes_per_step": float(coll["total_wire_bytes"]),
            "collective_ops_per_step": float(coll["num_ops"])}


def ranks_needed(workers: int, mesh_model: int, mesh_data: int,
                 device) -> int:
    """D x M, the ranks of a spmd cell; raises when D does not divide W,
    or when on the card D x M exceeds the visible cards."""
    if mesh_data < 1 or workers % mesh_data:
        raise ValueError(f"spmd cell w{workers} m{mesh_model}: mesh_data "
                         f"{mesh_data} must divide the {workers} workers")
    ranks = mesh_data * mesh_model
    if torch.device(device).type == "cuda":
        visible = torch.cuda.device_count()
        if ranks > visible:
            raise ValueError(
                f"spmd cell w{workers} m{mesh_model} at mesh_data "
                f"{mesh_data} needs {ranks} cards ({mesh_data} x "
                f"{mesh_model} ranks, one card each); {visible} visible "
                f"(--mesh-data sets D)")
    return ranks


def _time_cells(specs: Sequence[Spec], steps: int, reps: int, device,
                tracer=None, metrics=None) -> Tuple[List[float], List[int]]:
    """Build and warm every cell's trainer, then the interleaved
    best-of-``reps`` seconds of ``steps`` steps each. Also returns each
    cell's ``backup_reduce`` launches in this process, its warmup and
    every rep counted (0 off the card)."""
    trainers, launches = [], []

    def counted(i: int, n: int) -> None:
        before = counters.read()
        trainers[i].run(n)
        launches[i] += counters.since(before)[_BACKUP_REDUCE]

    for backend, w, c, m, d in specs:
        trainers.append(build_trainer(backend, w, c, m, tracer=tracer,
                                      metrics=metrics, mesh_data=d,
                                      device=device))
        launches.append(0)
        counted(len(trainers) - 1, max(c, 8))      # capture + warm caches
    best = common.best_of(range(len(trainers)),
                          lambda i: counted(i, steps), reps, device)
    return best, launches


def _world_cells(rank: int, device, specs, steps: int, reps: int,
                 out: str, trace: Optional[str], metrics_path: Optional[str]
                 ) -> None:
    """One rank of a D x M world: every cell of ``specs`` timed in turns;
    rank 0 writes the seconds and its launches (and its trace / registry)
    to ``out``."""
    tracer = Tracer() if trace else None
    metrics = MetricsRegistry() if metrics_path else None
    best, launches = _time_cells(specs, steps, reps, device, tracer, metrics)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"wall_s": best, "launches": launches}, f)
        if tracer is not None:
            tracer.export(trace)
        if metrics is not None:
            metrics.dump_jsonl(metrics_path)


def _suffixed(path: Optional[str], d: int, m: int) -> Optional[str]:
    if not path:
        return None
    root, ext = os.path.splitext(path)
    return f"{root}.d{d}m{m}{ext}"


def measure_all(specs: Sequence[Spec], steps: int, reps: int = REPS,
                tracer=None, metrics=None, device=None,
                trace_path: Optional[str] = None,
                metrics_path: Optional[str] = None) -> List[Dict]:
    """Every cell's best-of-``reps`` wall over ``steps`` steps, its
    ``backup_reduce`` launches (a world's rank 0's) and its bytes-moved
    axis. The sim cells and the spmd cells of one rank run
    here, in turns; each D x M world of spmd cells runs in a world of its
    own (its rank 0's trace and registry to ``trace_path`` /
    ``metrics_path`` with ``.d{D}m{M}`` before the extension). The bytes
    are planned here, before any world."""
    device = resolve_device(device)
    for backend, w, c, m, d in specs:
        if backend == "spmd":
            ranks_needed(w, m, d, device)
    coll = [collective_bytes_per_step(train_config(b, w, c, m, d))
            for b, w, c, m, d in specs]
    local = [i for i, s in enumerate(specs) if s[0] == "sim"
             or s[3] * s[4] == 1]
    worlds: Dict[Tuple[int, int], List[int]] = {}
    for i, s in enumerate(specs):
        if i not in local:
            worlds.setdefault((s[4], s[3]), []).append(i)
    wall, launches = [0.0] * len(specs), [0] * len(specs)
    for i, t, n in zip(local, *_time_cells([specs[i] for i in local], steps,
                                           reps, device, tracer, metrics)):
        wall[i], launches[i] = t, n
    if worlds:
        multiprocessing.set_forkserver_preload(
            ["torch", "repro_torch.distributed.mesh"])
    for (d, m), idx in worlds.items():
        with tempfile.TemporaryDirectory(prefix="bench_spmd_") as td:
            out = os.path.join(td, "best.json")
            mesh.spawn(_world_cells, d, device,
                       ([specs[i] for i in idx], steps, reps, out,
                        _suffixed(trace_path, d, m),
                        _suffixed(metrics_path, d, m)),
                       mesh_model=m, start_method="forkserver",
                       threads=1 if device.type == "cpu" else None)
            with open(out) as f:
                got = json.load(f)
            for i, t, n in zip(idx, got["wall_s"], got["launches"]):
                wall[i], launches[i] = t, n
    return [{"backend": b, "workers": w, "chunk_size": c, "mesh_model": m,
             "mesh_data": d, "steps": steps, "wall_s": t,
             "steps_per_s": steps / t, "backup_reduce_launches": n, **cb}
            for (b, w, c, m, d), t, n, cb in zip(specs, wall, launches,
                                                 coll)]


def cell_key(prefix: str, r: Dict) -> str:
    """``{prefix}w{W}_chunk{K}_m{M}``, with ``_d{D}`` when D != W."""
    d = "" if r["mesh_data"] == r["workers"] else f"_d{r['mesh_data']}"
    return (f"{prefix}w{r['workers']}_chunk{r['chunk_size']}"
            f"_m{r['mesh_model']}{d}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer timed steps (CI)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record host-side spans across every measured "
                         "trainer and export a Chrome trace here (adds "
                         "dispatch fences — numbers will be slower; a "
                         "world's rank 0 writes PATH with .d{D}m{M})")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the unified metrics registry as JSONL here")
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="refused: the reference's XLA flag recipe")
    ap.add_argument("--mesh-data", type=int, default=None, metavar="D",
                    help="ranks on the 'data' axis (default: W, the "
                         "reference's; W / D workers a rank)")
    ap.add_argument("--workers", type=int, nargs="+",
                    default=list(WORKER_COUNTS))
    ap.add_argument("--chunks", type=int, nargs="+",
                    default=list(CHUNK_SIZES))
    ap.add_argument("--mesh-models", type=int, nargs="+",
                    default=list(MESH_MODELS))
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    if args.platform:
        ap.error("--platform is not ported to repro_torch yet (none: "
                 "PyTorch picks the card by --device)")
    device = resolve_device(args.device)
    tracer = Tracer() if args.trace else None
    metrics = MetricsRegistry() if args.metrics else None

    steps = 32 if args.quick else 96
    specs: List[Spec] = [("sim", w, c, 1, w) for w in args.workers
                         for c in args.chunks]
    specs += [("spmd", w, c, m, args.mesh_data or w) for w in args.workers
              for c in args.chunks for m in args.mesh_models]
    results = measure_all(specs, steps, tracer=tracer, metrics=metrics,
                          device=device, trace_path=args.trace,
                          metrics_path=args.metrics)
    sim_rate = {(r["workers"], r["chunk_size"]): r["steps_per_s"]
                for r in results if r["backend"] == "sim"}
    spmd = [r for r in results if r["backend"] == "spmd"]
    # spmd/sim per cell: the engine's price at (W, K, M) on this host
    ratios = {cell_key("spmd_vs_sim_", r):
              r["steps_per_s"] / sim_rate[r["workers"], r["chunk_size"]]
              for r in spmd}
    bytes_moved = {cell_key("spmd_bytes_per_step_", r):
                   r["collective_bytes_per_step"] for r in spmd}
    payload = {
        "bench": "spmd",
        "model": "qwen3-0.6b tiny (1L, d32)",
        "max_ranks": max((r["mesh_data"] * r["mesh_model"] for r in spmd),
                         default=1),
        "mesh_models": list(args.mesh_models),
        "steps": steps,
        "results": results,
        **ratios,
        **bytes_moved,
    }
    for r in results:
        print(f"backend={r['backend']:<5} W={r['workers']} "
              f"chunk={r['chunk_size']:>3} m={r['mesh_model']} "
              f"d={r['mesh_data']} "
              f"{r['steps_per_s']:8.1f} steps/s "
              f"{r['collective_bytes_per_step'] / 1024:8.1f} KiB/step "
              f"({r['collective_ops_per_step']:.0f} colls)")
    for k, v in ratios.items():
        print(f"{k}: {v:.3f}")
    if tracer is not None:
        tracer.export(args.trace)
        print(f"[bench_spmd] trace: {args.trace} ({len(tracer)} events)")
    if metrics is not None:
        metrics.dump_jsonl(args.metrics)
        print(f"[bench_spmd] metrics: {args.metrics} "
              f"({len(metrics)} series)")
    path = common.write_out(args.out, payload, device)
    if path:
        print(f"-> {path}")
    return payload


def run(quick: bool = True, device=None, mesh_data: Optional[int] = None,
        mesh_models: Optional[Sequence[int]] = None):
    """The harness contract: (name, us_per_call, derived), from the
    in-process payload. Trace / metrics requests come from the
    ``REPRO_BENCH_TRACE`` / ``REPRO_BENCH_METRICS`` environment variables,
    as in the reference."""
    argv = ["--quick"] if quick else []
    if device:
        argv += ["--device", str(device)]
    if mesh_data:
        argv += ["--mesh-data", str(mesh_data)]
    if mesh_models:
        argv += ["--mesh-models", *map(str, mesh_models)]
    for var, flag in (("REPRO_BENCH_TRACE", "--trace"),
                      ("REPRO_BENCH_METRICS", "--metrics")):
        val = os.environ.get(var)
        if val:
            argv += [flag, val]
    payload = main(argv)
    rows = [(cell_key(f"spmd.{r['backend']}_", r),
             1e6 / r["steps_per_s"], f"{r['steps_per_s']:.1f}steps/s")
            for r in payload["results"]]
    rows += [(f"spmd.{k}", 0.0, f"{v:.3f}x")
             for k, v in payload.items() if k.startswith("spmd_vs_sim")]
    return rows


if __name__ == "__main__":
    main()
