"""The spmd engine's ``'data'`` axis as a ``torch.distributed`` world.
Reference: ``src/repro/launch/mesh.py`` (``make_host_mesh``) and
``src/repro/distributed/spmd_engine.py`` (``build_mesh``): the reference
lays the workers over a device mesh inside one process; here each
position on the ``'data'`` axis is one process (a rank), and the axis is
the world of ``mesh_data`` ranks.

* :func:`join` joins the world, or makes it: NCCL when every rank has a
  card of its own, gloo on the CPU (and for several ranks on one card,
  where NCCL refuses to run). Rank r works on ``cuda:{r % device_count}``.
  A world that ``torchrun`` started (``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` in the environment) is joined as it is.
* :func:`spawn` starts ``mesh_data`` ranks with ``torch.multiprocessing``
  (the ``spawn`` start method) and a ``file://`` rendezvous, runs
  ``fn(rank, device, *args)`` on each, and raises if any rank fails.
* :func:`data_group` is what the engine asks for: the world when it has
  ``mesh_data`` ranks, None at ``mesh_data = 1``; it raises, naming
  :func:`spawn`, when no such world exists.

The ``'model'`` axis (tensor parallelism) is not ported: ``spmd_engine.
check_mesh`` refuses ``mesh_model > 1`` (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

WORKER_AXIS = "data"
TIMEOUT_S = 600.0


def backend_for(device, mesh_data: int) -> str:
    """``nccl`` when the ranks run on cards and each has its own, else
    ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= mesh_data:
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:{rank % device_count}`` on the card,
    ``device`` itself otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def rank() -> int:
    """This process's position on the ``'data'`` axis (0 without a
    world)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_leader() -> bool:
    """Rank 0 (or no world): the process that prints and writes
    checkpoints."""
    return rank() == 0


def data_group(mesh_data: int):
    """The process group of the ``'data'`` axis: None at ``mesh_data = 1``,
    else the initialized world, which must have ``mesh_data`` ranks."""
    if mesh_data == 1:
        return None
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh_data={mesh_data}: the spmd engine's '{WORKER_AXIS}' axis "
            f"is a torch.distributed world of {mesh_data} ranks and none is "
            f"initialized in this process; start the ranks with "
            f"repro_torch.distributed.mesh.spawn (or torchrun, then "
            f"mesh.join)")
    size = dist.get_world_size()
    if size != mesh_data:
        raise ValueError(f"mesh_data={mesh_data} but the world has {size} "
                         f"ranks")
    return dist.group.WORLD


def backend() -> Optional[str]:
    """The world's backend (``nccl`` / ``gloo``), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def join(mesh_data: int, device, *, rank: Optional[int] = None,
         init_method: Optional[str] = None,
         timeout_s: float = TIMEOUT_S):
    """Join the world of ``mesh_data`` ranks as ``rank`` through
    ``init_method``; with neither given, the world ``torchrun`` describes
    in the environment. Sets this rank's card current. Returns the
    group."""
    if dist.is_initialized():
        return data_group(mesh_data)
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("mesh.join needs a rank and an init_method, "
                               "or the RANK / WORLD_SIZE environment that "
                               "torchrun sets")
        rank, init_method = int(os.environ["RANK"]), "env://"
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(device, mesh_data), init_method=init_method, rank=rank,
        world_size=mesh_data,
        timeout=datetime.timedelta(seconds=timeout_s))
    return data_group(mesh_data)


def _entry(rank: int, fn: Callable, mesh_data: int, device: str,
           init_file: str, args: Sequence, threads: Optional[int],
           timeout_s: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    join(mesh_data, device, rank=rank, init_method=f"file://{init_file}",
         timeout_s=timeout_s)
    try:
        fn(rank, rank_device(device, rank), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, mesh_data: int, device, args: Sequence = (), *,
          threads: Optional[int] = None,
          timeout_s: float = TIMEOUT_S) -> None:
    """Run ``fn(rank, device, *args)`` on ``mesh_data`` new processes that
    form the ``'data'`` world (``fn`` and ``args`` are pickled: ``fn``
    must be importable). ``threads``: torch threads per rank;
    ``timeout_s``: the collectives' timeout. Returns when every rank has
    finished; raises if one fails (the others are then terminated)."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as d:
        torch.multiprocessing.start_processes(
            _entry, args=(fn, mesh_data, str(device),
                          os.path.join(d, "rendezvous"), tuple(args),
                          threads, timeout_s),
            nprocs=mesh_data, join=True, start_method="spawn")
