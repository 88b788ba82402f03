"""The spmd engine's ``('data', 'model')`` mesh as a ``torch.distributed``
world.
Reference: ``src/repro/launch/mesh.py`` (``make_host_mesh``) and
``src/repro/distributed/spmd_engine.py`` (``build_mesh``): the reference
lays devices out on a ``(mesh_data, mesh_model)`` mesh inside one
process; here each position on the mesh is one process (a rank), and the
world has ``mesh_data * mesh_model`` ranks, laid out as
``make_host_mesh`` lays out devices, row-major: rank r sits at
``data_index = r // mesh_model``, ``model_index = r % mesh_model``.

* :func:`join` joins the world, or makes it: NCCL when every rank has a
  card of its own, gloo on the CPU (and for several ranks on one card,
  where NCCL refuses to run). Rank r works on ``cuda:{r % device_count}``.
  A world that ``torchrun`` started (``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` in the environment) is joined as it is.
* :func:`spawn` starts the ``mesh_data * mesh_model`` ranks with
  ``torch.multiprocessing`` (the ``spawn`` start method) and a
  ``file://`` rendezvous, runs ``fn(rank, device, *args)`` on each, and
  raises if any rank fails.
* :func:`data_group` is the ``'data'`` axis: the ``mesh_data`` ranks that
  share this rank's model index (the world at ``mesh_model = 1``, None at
  ``mesh_data = 1``). :func:`model_group` is the ``'model'`` axis: the
  ``mesh_model`` ranks that share its data index (None at ``mesh_model =
  1``). Both raise, naming :func:`spawn`, when no such world exists. The
  first call makes every group of the mesh with ``dist.new_group`` in one
  fixed order, on every rank (a rank that skipped one would hang the
  others).
* A shrunk ``'data'`` axis (the reference's elastic rescale on the mesh)
  is a ``mesh_data' x mesh_model`` sub-mesh of the world: the ranks at
  data index < ``mesh_data'`` keep their positions and the others idle.
  :func:`in_mesh` makes its groups on every rank and tells a rank whether
  it is on it; :func:`current_shape` is the mesh the world last joined.
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

WORKER_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT_S = 600.0

# the mesh this process's world was made for: (mesh_data, mesh_model) and
# its groups, made once per world (_mesh_groups)
_mesh: Dict = {}


def backend_for(device, ranks: int) -> str:
    """``nccl`` when the ``ranks`` ranks run on cards and each has its
    own, else ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= ranks:
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
    """This process's rank in the world (0 without a world)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_model() -> int:
    return _mesh.get("shape", (1, 1))[1] if dist.is_initialized() else 1


def data_index() -> int:
    """This rank's position on the ``'data'`` axis (0 without a world)."""
    return rank() // _mesh_model()


def model_index() -> int:
    """This rank's position on the ``'model'`` axis (0 without a
    world)."""
    return rank() % _mesh_model()


def is_leader() -> bool:
    """Rank 0, at mesh position (0, 0), or no world: the process that
    prints and writes checkpoints."""
    return rank() == 0


def _mesh_groups(mesh_data: int, mesh_model: int) -> Dict:
    """The groups of the ``mesh_data x mesh_model`` mesh, made on the first
    call for it. The first call in a world fixes the world's mesh, whose
    size must be the world's; later calls may ask for a sub-mesh with
    fewer data positions (the first ``mesh_data`` of them, the freed ranks
    idle: ``Trainer.rescale``). New groups are made through
    ``dist.new_group`` on every rank in one order, the ranks outside a
    group included; a group that spans the world is the world itself, and
    a sub-mesh reuses the world's ``'model'`` groups."""
    ranks = mesh_data * mesh_model
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh {mesh_data} x {mesh_model}: the spmd engine's "
            f"('{WORKER_AXIS}', '{MODEL_AXIS}') mesh is a torch.distributed "
            f"world of {ranks} ranks and none is initialized in this "
            f"process; start the ranks with repro_torch.distributed.mesh."
            f"spawn (or torchrun, then mesh.join)")
    world = dist.group.WORLD
    size = dist.get_world_size()
    shape = (mesh_data, mesh_model)
    if _mesh.get("world") is not world:
        if size != ranks:
            raise ValueError(f"mesh {mesh_data} x {mesh_model} needs "
                             f"{ranks} ranks but the world has {size}")
        _mesh.clear()
        _mesh.update(world=world, shape=shape, meshes={})
    full_d, full_m = _mesh["shape"]
    if mesh_model != full_m or not 1 <= mesh_data <= full_d:
        raise ValueError(f"this world's mesh is {_mesh['shape']}, not "
                         f"{shape} (a sub-mesh keeps the 'model' axis and "
                         f"at most the world's data positions)")
    if shape in _mesh["meshes"]:
        return _mesh["meshes"][shape]

    def axis(members):
        return [world if len(m) == size else dist.new_group(m)
                for m in members]

    r = dist.get_rank()
    d, m = r // mesh_model, r % mesh_model
    data = axis([[dd * mesh_model + mm for dd in range(mesh_data)]
                 for mm in range(mesh_model)]) if mesh_data > 1 else None
    full = _mesh["meshes"].get((full_d, full_m))
    if full is not None:            # a sub-mesh: the world's model groups
        model = full["model_groups"]
    else:
        model = axis([[dd * mesh_model + mm for mm in range(mesh_model)]
                      for dd in range(mesh_data)]) if mesh_model > 1 \
            else None
    inside = d < mesh_data
    groups = dict(data=data[m] if data and inside else None,
                  model=model[d] if model and inside else None,
                  model_groups=model, inside=inside)
    _mesh["meshes"][shape] = groups
    return groups


def current_shape() -> Optional[Tuple[int, int]]:
    """The ``(mesh_data, mesh_model)`` (sub-)mesh this process's world
    last joined through :func:`in_mesh` (None before, and without a
    world): after a rescale that shrank the ``'data'`` axis, the shrunk
    one, which a trainer rebuilt for it (a restart) joins again."""
    if dist.is_initialized() and _mesh.get("world") is dist.group.WORLD:
        return _mesh.get("current")
    return None


def in_mesh(mesh_data: int, mesh_model: int = 1) -> bool:
    """Makes the ``mesh_data x mesh_model`` (sub-)mesh's groups, on every
    rank of the world, records it as the world's current mesh
    (:func:`current_shape`) and tells whether this rank is on it (False: a
    rank freed by a shrunk ``'data'`` axis, which idles). True without a
    world."""
    if not dist.is_initialized():
        return True
    inside = _mesh_groups(mesh_data, mesh_model)["inside"]
    _mesh["current"] = (mesh_data, mesh_model)
    return inside


def data_group(mesh_data: int, mesh_model: int = 1):
    """The process group of this rank's ``'data'`` axis: None at
    ``mesh_data = 1``, the world at ``mesh_model = 1``, else the
    ``mesh_data`` ranks sharing this rank's model index. The world must
    have ``mesh_data * mesh_model`` ranks."""
    if mesh_data == 1 and mesh_model == 1:
        return None
    return _mesh_groups(mesh_data, mesh_model)["data"]


def model_group(mesh_data: int, mesh_model: int):
    """The process group of this rank's ``'model'`` axis: None at
    ``mesh_model = 1``, else the ``mesh_model`` ranks sharing this rank's
    data index."""
    if mesh_model == 1:
        return None
    return _mesh_groups(mesh_data, mesh_model)["model"]


def backend() -> Optional[str]:
    """The world's backend (``nccl`` / ``gloo``), None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def join(mesh_data: int, device, *, mesh_model: int = 1,
         rank: Optional[int] = None, init_method: Optional[str] = None,
         timeout_s: float = TIMEOUT_S):
    """Join the world of ``mesh_data * mesh_model`` ranks as ``rank``
    through ``init_method``; with neither given, the world ``torchrun``
    describes in the environment. Sets this rank's card current and makes
    the mesh's groups. Returns the ``'data'`` group."""
    if dist.is_initialized():
        return data_group(mesh_data, mesh_model)
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError("mesh.join needs a rank and an init_method, "
                               "or the RANK / WORLD_SIZE environment that "
                               "torchrun sets")
        rank, init_method = int(os.environ["RANK"]), "env://"
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ranks = mesh_data * mesh_model
    dist.init_process_group(
        backend_for(device, ranks), init_method=init_method, rank=rank,
        world_size=ranks, timeout=datetime.timedelta(seconds=timeout_s))
    return data_group(mesh_data, mesh_model)


def _entry(rank: int, fn: Callable, mesh_data: int, mesh_model: int,
           device: str, init_file: str, args: Sequence,
           threads: Optional[int], timeout_s: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    join(mesh_data, device, mesh_model=mesh_model, rank=rank,
         init_method=f"file://{init_file}", timeout_s=timeout_s)
    try:
        fn(rank, rank_device(device, rank), *args)
    finally:
        _mesh.clear()
        dist.destroy_process_group()


def spawn(fn: Callable, mesh_data: int, device, args: Sequence = (), *,
          mesh_model: int = 1, threads: Optional[int] = None,
          timeout_s: float = TIMEOUT_S) -> None:
    """Run ``fn(rank, device, *args)`` on ``mesh_data * mesh_model`` new
    processes that form the mesh's world (``fn`` and ``args`` are
    pickled: ``fn`` must be importable). ``threads``: torch threads per
    rank; ``timeout_s``: the collectives' timeout. Returns when every rank
    has finished; raises if one fails (the others are then
    terminated)."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as d:
        torch.multiprocessing.start_processes(
            _entry, args=(fn, mesh_data, mesh_model, str(device),
                          os.path.join(d, "rendezvous"), tuple(args),
                          threads, timeout_s),
            nprocs=mesh_data * mesh_model, join=True, start_method="spawn")
