"""Dry run: plan every (arch x shape x mesh) cell of the port's own engine,
allocating nothing. Reference: ``src/repro/launch/dryrun.py`` (``run_cell``,
:346; ``train_policy``, :224; the records ``benchmarks/roofline.py``
reads).

The reference lowers and compiles each cell for 512 fake host devices and
reads XLA's memory analysis and the collectives of the optimized HLO. The
port has no compiler to ask: it runs the cell's eager step itself, on
``meta`` tensors, under :class:`MemoryTracker` (a dispatch mode that adds up
the bytes of every storage the step creates, rounded as the CUDA caching
allocator rounds them, and subtracts them when the storage dies):

* ``train``: the spmd engine's state as the trainer builds it (the model,
  the optimizer state, the EMA), then one step of
  ``distributed.spmd_engine.build_spmd_step`` (the ``[W_local, P_local]``
  f32 gradient stack it allocates at its first step, the workers'
  gradients in groups of ``grad_batch``, the masked reduce, the update);
* ``prefill``: the model, then ``train/serve_step.build_prefill``'s call;
* ``decode``: the model and its contiguous cache (``init_cache``), then one
  ``decode_step``.

Per cell one JSON record under the reference's field names where the
meaning carries over: ``memory.argument_bytes`` (what stays resident on a
card: parameters, gradient stack, optimizer state, EMA, cache; broken down
under ``memory.resident``), ``memory.temp_bytes`` (the eager step's peak
above that), ``collectives.per_kind`` (the all-reduces and all-gathers the
step issues, each in payload ``bytes`` and ``wire_bytes``: the ``'data'``
axis' bucket all-reduce of ``(P_local + 2) x 4`` bytes at ``bucket_size``
0, the tensor-parallel hooks' as the port issues them; none on one card),
``fits`` against ``CARD_MEMORY_BYTES``, ``status`` (``ok``, ``skipped``,
``refused`` with the ``reason``, ``error``). The eager step is what is
planned: a CUDA graph's private pool (``chunk_size > 1``) keeps more.

Kernels on ``meta`` tensors: the step takes the card's branches, with the
kernel launches replaced by twins that allocate what the wrappers allocate
and launch nothing (``_as_on_card``): the ``backup_reduce`` reduce writes
into the engine's output, the wkv6 forward and backward allocate their
outputs, chunk states and scratch. The card is never touched; the launch
counts are left as they were.

Meshes (``launch/mesh.py``): the card meshes ``D x M`` over 1, 2, 4 and 8
cards, and the reference's production meshes (16 x 16, 2 x 16 x 16 with the
``'pod'`` axis folded into ``'data'``). A card of a ``D x M`` mesh is rank 0
of a world of ``D * M`` ranks made in-process on torch's ``fake`` backend,
whose collectives are recorded and not run. At ``M > 1`` a cell is planned
only where ``distributed.sharding.tp_plan`` shards a group; otherwise it is
refused with the plan's reason. Serving cells run on one card a replica
(``global_batch / D`` rows each; the contiguous-cache path has no tensor
parallelism). Train cells run W = D workers, all aggregated (the
reference's ``num_workers = dp``), rmsprop_momentum, EMA 0.9999, the
config's remat, ``grad_batch`` 0 and one reduce bucket. The reference's
auto policies (FSDP, sequence parallelism, microbatches, ZeRO-1/2, a host
EMA, expert parallelism) have no counterpart in the port's engine: their
flags are refused by name and ``policy`` records what the port does.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh cards|single|multi|all|DxM]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Iterator, List, Optional
from unittest import mock

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import configs
from repro_torch.configs.base import (SHAPES_BY_NAME, AggregationConfig,
                                      CheckpointConfig, ExecutionConfig,
                                      OptimizerConfig, TrainConfig, replace)
from repro_torch.core import ema as ema_lib
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed import sharding, spmd_engine, tp
from repro_torch.kernels import bucketed_reduce, counters, rwkv6_scan
from repro_torch.launch.mesh import (MeshLayout, card_meshes,
                                    make_host_mesh, mesh_by_name)
from repro_torch.models import get_model, registry, rwkv6
from repro_torch.optim import make_optimizer, schedules
from repro_torch.train import serve_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch")
# one card's memory, the limit ``fits`` is held to: the
# ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
# 80GB HBM3 (700.00 W; ``mem_get_info`` leaves 84,465,090,560 bytes free
# to a fresh process: the CUDA context's share)
CARD_MEMORY_BYTES = 85_017_493_504
# the CUDA caching allocator hands out blocks in multiples of this
_BLOCK = 512
_META = torch.device("meta")
# the reference's policy overrides, refused by name: (flag, dest, why)
REFUSED_FLAGS = (
    ("--fsdp", "fsdp", "the port's engine has no FSDP: parameters are "
                       "replicated over the 'data' axis"),
    ("--sp", "sp", "the port's TP path has no sequence parallelism (a "
                   "later engine feature, ROADMAP)"),
    ("--microbatch", "microbatch", "the port's engine takes no "
                                   "microbatches: a worker's batch is one "
                                   "pass"),
    ("--no-zero2", "no_zero2", "the port's engine has no ZeRO-2 (nor "
                               "ZeRO-1): gradients are all-reduced and the "
                               "optimizer state is replicated"),
    ("--moe-mode ep", "moe_mode", "the port's MoE has no expert "
                                  "parallelism: experts stay whole on every "
                                  "rank"),
)


# ---------------------------------------------------------------------------
# The memory tracker
# ---------------------------------------------------------------------------


class MemoryTracker(TorchDispatchMode):
    """Bytes of the live storages created under it: ``live`` now and
    ``peak`` since the last :meth:`reset_peak`. Each storage counts once
    (views share it), rounded up to the allocator's 512-byte blocks, from
    the op that creates it until it is freed."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def reset_peak(self) -> None:
        self.peak = self.live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tree_map_only(torch.Tensor, self.track, out)
        return out


def tensor_bytes(tree: Any) -> int:
    """Bytes of the distinct storages in ``tree`` (tensors, nested dicts /
    lists), rounded as the tracker rounds them."""
    seen: Dict[int, int] = {}

    def visit(x):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[id(st)] = -(-st.nbytes() // _BLOCK) * _BLOCK
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(tree)
    return sum(seen.values())


# ---------------------------------------------------------------------------
# The card's branches on meta tensors
# ---------------------------------------------------------------------------


def _backup_reduce_twin(grads, mask, n_aggregate, *, out=None):
    """``backup_reduce``'s allocations: ``out`` (the engine passes its
    own), else a [P] f32."""
    if out is None:
        out = torch.empty(grads.shape[1], dtype=torch.float32,
                          device=grads.device)
    return out


def _wkv6_forward_twin(r, k, v, w, u, *, save_states: bool = True):
    """``rwkv6_scan.wkv6_forward``'s allocations."""
    b, s, h, d = r.shape
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=r.device)
    final = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    states = torch.empty((b, h, -(-s // rwkv6_scan.CHUNK), d, d),
                         dtype=torch.float32, device=r.device) \
        if save_states else None
    return out, final, states


def _wkv6_backward_parts_twin(r, k, v, w, u, states, dout, dfinal=None):
    """``rwkv6_scan.wkv6_backward_parts``'s allocations: the four
    gradients, ``du_part`` and the pass-1 scratch (freed on return)."""
    b, s, h, d = r.shape
    nc = -(-s // rwkv6_scan.CHUNK)
    grads = [torch.empty((b, s, h, d), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    du_part = torch.empty((b, h, nc, d), dtype=torch.float32,
                          device=r.device)
    scratch = [torch.empty((b, h, nc, d, d), dtype=torch.float32,
                           device=r.device), dout.float().contiguous()]
    if dfinal is not None:
        scratch.append(dfinal.float().contiguous())
    del scratch
    return (*grads, du_part)


class Collectives:
    """The collectives a planned step issues, recorded instead of run: per
    kind (``all-reduce``, ``all-gather``) and per mesh axis (``data``: the
    bucket all-reduce over the ``'data'`` group; ``model``: the tensor
    parallelism's over the ``'model'`` group), each a count and payload
    bytes (an all-reduce in place: its wire payload is its tensor)."""

    def __init__(self, layout: Optional[MeshLayout] = None):
        self.layout = layout or make_host_mesh(1, 1)
        self.per_kind: Dict[str, Dict[str, float]] = {}
        self.per_axis: Dict[str, Dict[str, float]] = {}

    def add(self, kind: str, t: torch.Tensor, group) -> None:
        d, m = self.layout.data, self.layout.model
        axis = "model" if m > 1 and group is mesh_lib.model_group(d, m) \
            else "data"
        n = float(t.numel() * t.element_size())
        for table, key in ((self.per_kind, kind), (self.per_axis, axis)):
            e = table.setdefault(key, {"count": 0.0, "bytes": 0.0,
                                       "wire_bytes": 0.0})
            e["count"] += 1
            e["bytes"] += n
            e["wire_bytes"] += n

    def summary(self) -> Dict[str, Any]:
        """The reference's ``parse_collectives`` fields, and ``per_axis``."""
        return {"per_kind": self.per_kind, "per_axis": self.per_axis,
                "total_bytes": sum(d["bytes"]
                                   for d in self.per_kind.values()),
                "total_wire_bytes": sum(d["wire_bytes"]
                                        for d in self.per_kind.values()),
                "num_ops": sum(d["count"] for d in self.per_kind.values())}


@contextlib.contextmanager
def _as_on_card(collectives: Collectives) -> Iterator[None]:
    """The step's card branches on meta tensors (kernel launches replaced
    by their allocations), its collectives recorded into ``collectives``
    and not run, the kernels' launch counts restored afterwards."""
    wkv_chunked = rwkv6.wkv_chunked

    def wkv_on_card(r, k, v, w, u, state=None, chunk=rwkv6_scan.CHUNK, *,
                    use_kernel=True):
        if use_kernel and state is None and chunk == rwkv6_scan.CHUNK:
            return rwkv6_scan.wkv6(r, k, v, w, u)
        return wkv_chunked(r, k, v, w, u, state, chunk,
                           use_kernel=use_kernel)

    def all_reduce(t, op=None, group=None, async_op=False):
        collectives.add("all-reduce", t, group)

    def all_gather(out, x, group=None, async_op=False):
        collectives.add("all-gather", out, group)

    before = counters.read()
    try:
        with mock.patch.object(spmd_engine, "resolve_use_kernel",
                               lambda *a: True), \
                mock.patch.object(bucketed_reduce, "backup_reduce",
                                  _backup_reduce_twin), \
                mock.patch.object(rwkv6, "wkv_chunked", wkv_on_card), \
                mock.patch.object(rwkv6_scan, "wkv6_forward",
                                  _wkv6_forward_twin), \
                mock.patch.object(rwkv6_scan, "wkv6_backward_parts",
                                  _wkv6_backward_parts_twin), \
                mock.patch.object(dist, "all_reduce", all_reduce), \
                mock.patch.object(tp, "_all_gather_single", all_gather):
            yield
    finally:
        counters.write(before)


@contextlib.contextmanager
def _world(layout: MeshLayout) -> Iterator[None]:
    """Rank 0 of a world of the layout's ranks on torch's ``fake`` backend
    (no world for one card)."""
    if layout.devices == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("the dry run plans a mesh in a world of its own; "
                           "this process already belongs to one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=layout.devices)
    try:
        yield
    finally:
        mesh_lib._mesh.clear()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Planning one step
# ---------------------------------------------------------------------------


def _batch(cfg, rows: int, seq: int, device, *, labels: bool) -> Dict:
    """The step's batch for ``cfg``'s family (the reference's
    ``input_specs`` / ``prefill_input_specs``): int32 ids, a vlm's bf16
    prefix embeddings, an encoder-decoder's bf16 frames."""
    batch: Dict[str, torch.Tensor] = {}
    text = seq - cfg.num_prefix_embeds if cfg.family == "vlm" else seq
    batch["tokens"] = torch.zeros((rows, text), dtype=torch.int32,
                                  device=device)
    if labels:
        batch["labels"] = torch.zeros((rows, text), dtype=torch.int32,
                                      device=device)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.zeros(
            (rows, cfg.num_prefix_embeds, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    elif cfg.family == "audio":
        batch["encoder_frames"] = torch.zeros(
            (rows, cfg.encoder_seq_len, cfg.d_model), dtype=torch.bfloat16,
            device=device)
    return batch


def _memory(mem: MemoryTracker, parts: Dict[str, int]) -> Dict[str, Any]:
    argument = sum(parts.values())
    return {"argument_bytes": argument,
            "temp_bytes": mem.peak - argument,
            "peak_bytes": mem.peak,
            "output_bytes": None, "alias_bytes": None, "code_bytes": None,
            "resident": parts}


def plan_train(cfg: TrainConfig, layout: Optional[MeshLayout] = None
               ) -> Dict[str, Any]:
    """One eager spmd step of ``cfg`` on the first card of ``layout``
    (``cfg``'s ``mesh_data x mesh_model``; default 1 x 1): ``memory`` and
    ``collectives`` as this module's records hold them."""
    ex = cfg.execution
    layout = layout or make_host_mesh(ex.mesh_data, ex.mesh_model)
    if (layout.data, layout.model) != (ex.mesh_data, ex.mesh_model):
        raise ValueError(f"mesh {layout.name} is not the config's "
                         f"{ex.mesh_data} x {ex.mesh_model}")
    agg = cfg.aggregation
    w = agg.total_workers
    spmd_engine.validate_layout(w, cfg.shape.global_batch, ex.mesh_data)
    coll = Collectives(layout)
    with _world(layout), _as_on_card(coll), MemoryTracker() as mem:
        model = get_model(cfg.model, device=_META,
                          generator=torch.Generator())
        opt = make_optimizer(cfg.optimizer, schedules.from_config(
            cfg.optimizer, agg.num_workers))
        step = spmd_engine.build_spmd_step(
            model, opt, num_workers=w, n_aggregate=agg.num_workers,
            ema_decay=cfg.optimizer.ema_decay,
            clip_norm=cfg.optimizer.clip_global_norm,
            grad_batch=ex.grad_batch, bucket_size=ex.bucket_size,
            mesh_data=ex.mesh_data, mesh_model=ex.mesh_model,
            model_cfg=cfg.model)
        params = dict(model.named_parameters())
        opt_state = opt.init(params)
        ema = ema_lib.init(params.items()) \
            if cfg.optimizer.ema_decay > 0 else None
        built = mem.live
        rows = cfg.shape.global_batch // ex.mesh_data
        batch = _batch(cfg.model, rows, cfg.shape.seq_len, _META,
                       labels=True)
        mask = torch.ones(w, dtype=torch.bool, device=_META)
        scalars = {k: torch.zeros((), dtype=torch.float32, device=_META)
                   for k in opt.scalars(0)}
        mem.reset_peak()
        metrics = step(opt_state, ema, scalars, batch, mask)
        del metrics, batch, mask, scalars
        gc.collect()
        stack = mem.live - built
        parts = {"params": tensor_bytes(params),
                 "opt_state": tensor_bytes(opt_state),
                 "ema": tensor_bytes(ema or {}),
                 "grad_stack": stack}
        parts["other"] = built - (parts["params"] + parts["opt_state"]
                                  + parts["ema"])
        out = {"memory": _memory(mem, parts),
               "params_local": sum(p.numel() for p in params.values())}
        del model, step, params, opt_state, ema
    out["collectives"] = coll.summary()
    return out


def plan_serve(cfg, kind: str, rows: int, seq: int, *,
               cache_dtype=None) -> Dict[str, Any]:
    """One ``prefill`` of ``rows`` x ``seq`` tokens, or one ``decode`` step
    of ``rows`` requests against a contiguous cache of ``seq`` positions,
    on one card."""
    coll = Collectives()
    with _as_on_card(coll), MemoryTracker() as mem, torch.no_grad():
        model = get_model(cfg, device=_META, generator=torch.Generator())
        params = tensor_bytes(dict(model.named_parameters()))
        if kind == "prefill":
            batch = _batch(cfg, rows, seq, _META, labels=False)
            parts = {"params": params}
            mem.reset_peak()
            out = serve_step.build_prefill(model)(batch)
            del batch
        else:
            cache = model.init_cache(rows, seq, cache_dtype)
            parts = {"params": params, "cache": tensor_bytes(cache)}
            token = torch.zeros((rows, 1), dtype=torch.int32, device=_META)
            mem.reset_peak()
            out = serve_step.build_decode_step(model)(token, cache)
            del token, cache
        del out
        gc.collect()
        record = {"memory": _memory(mem, parts)}
        del model
    record["collectives"] = coll.summary()
    return record


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def tp_refusal(cfg, model_size: int) -> Optional[str]:
    """Why ``tp_plan`` shards nothing of ``cfg`` over ``model_size`` ranks
    (None when it shards a group, or at one rank)."""
    if model_size <= 1 or sharding.tp_plan(cfg, model_size).any:
        return None
    if cfg.family not in ("dense", "moe", "vlm"):
        return (f"tp_plan shards nothing at mesh_model={model_size}: the "
                f"{cfg.family} family carries no tensor-parallel hooks")
    why = []
    if cfg.use_bias:
        why.append("biased layers")
    if cfg.attention_kind != "gqa":
        why.append(f"{cfg.attention_kind} attention stays whole")
    else:
        why.append(f"heads {cfg.num_heads} / kv heads {cfg.num_kv_heads}")
    why.append(f"d_ff {cfg.d_ff}, padded vocab {cfg.padded_vocab}")
    return (f"tp_plan shards nothing at mesh_model={model_size} ("
            + "; ".join(why) + f" do not all divide by {model_size})")


def model_config(arch: str, *, remat: Optional[str] = None):
    cfg = configs.get_config(arch)
    return replace(cfg, remat=remat) if remat else cfg


def cell_train_config(cfg, shape, layout: MeshLayout) -> TrainConfig:
    """The port's engine on a train cell: W = D workers, all aggregated,
    rmsprop_momentum (lr 0.045 x N), EMA 0.9999, ``grad_batch`` 0 (the
    reference's vmap over the local workers), one reduce bucket, over the
    layout's ``D x M``."""
    w = layout.data
    return TrainConfig(
        model=cfg, shape=shape,
        aggregation=AggregationConfig(strategy="full_sync", num_workers=w,
                                      backup_workers=0),
        optimizer=OptimizerConfig(name="rmsprop_momentum",
                                  learning_rate=0.045,
                                  scale_lr_with_workers=True,
                                  ema_decay=0.9999),
        checkpoint=CheckpointConfig(every_steps=0),
        execution=ExecutionConfig(backend="spmd", grad_batch=0,
                                  bucket_size=0, mesh_data=layout.data,
                                  mesh_model=layout.model),
        seed=0, total_steps=1)


def train_policy(cfg: TrainConfig) -> Dict[str, Any]:
    """What the port's engine does on this cell, under the reference's
    policy names: no FSDP, no sequence parallelism, one microbatch, the
    EMA on the card, replicated optimizer state and all-reduced
    gradients; the workers, ``grad_batch``, remat and the TP groups."""
    ex = cfg.execution
    plan = sharding.tp_plan(cfg.model, ex.mesh_model)
    return {"fsdp": False, "sp": False, "microbatches": 1,
            "ema_device": cfg.optimizer.ema_decay > 0, "zero1": False,
            "zero2": False, "moe_mode": "tp" if cfg.model.moe.enabled
            else None, "workers": cfg.aggregation.total_workers,
            "n_aggregate": cfg.aggregation.num_workers,
            "grad_batch": ex.grad_batch, "bucket_size": ex.bucket_size,
            "remat": cfg.model.remat, "optimizer": cfg.optimizer.name,
            "tp": {"attn": plan.attn, "ffn": plan.ffn, "vocab": plan.vocab}}


def run_cell(arch: str, shape_name: str, mesh: str = "1x1", *,
             remat: Optional[str] = None, cache_int8: bool = False,
             tag: str = "", out_dir: Optional[str] = OUT_DIR
             ) -> Dict[str, Any]:
    """Plan one cell and (with ``out_dir``) save its record."""
    layout = mesh_by_name(mesh)
    cell_id = f"{arch}__{shape_name}__{layout.name}" + (f"__{tag}" if tag
                                                       else "")
    shape = SHAPES_BY_NAME[shape_name]
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": layout.name, "tag": tag,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "devices": layout.devices,
        "mesh_data": layout.data, "mesh_model": layout.model,
        "cost": {"flops": None, "bytes_accessed": None}}
    if configs.cell_is_skipped(arch, shape_name):
        result["status"] = "skipped"
        result["reason"] = ("pure full-attention arch; long_500k requires "
                            "sub-quadratic attention (DESIGN.md)")
        _save(out_dir, cell_id, result)
        return result
    cfg = model_config(arch, remat=remat)
    result["params"] = registry.param_count(cfg)
    result["active_params"] = registry.param_count(cfg, active_only=True)
    reason = tp_refusal(cfg, layout.model)
    if reason is None and shape.kind != "train":
        if layout.model > 1:
            reason = ("the contiguous-cache serve path runs a replica on "
                      "one card (no tensor parallelism; the paged engine's "
                      "ServeEngine(mesh_model=M) is not planned here)")
        elif shape.global_batch % layout.data:
            reason = (f"global_batch {shape.global_batch} does not split "
                      f"over {layout.data} replicas (the reference shards "
                      f"the cache's sequence; the port has no such cache)")
    if reason is not None:
        result["status"] = "refused"
        result["reason"] = reason
        _save(out_dir, cell_id, result)
        return result
    t0 = time.time()
    try:
        if shape.kind == "train":
            tcfg = cell_train_config(cfg, shape, layout)
            result["policy"] = train_policy(tcfg)
            result.update(plan_train(tcfg, layout))
        else:
            rows = shape.global_batch // layout.data
            result["policy"] = {"replica_rows": rows,
                                "cache_int8": cache_int8,
                                "path": "contiguous cache (train/"
                                        "serve_step)"}
            result.update(plan_serve(
                cfg, shape.kind, rows, shape.seq_len,
                cache_dtype=torch.int8 if cache_int8 else None))
        result["capacity_bytes"] = CARD_MEMORY_BYTES
        result["fits"] = result["memory"]["peak_bytes"] <= CARD_MEMORY_BYTES
        result["status"] = "ok"
        print(f"[dryrun] {cell_id}: OK ({time.time() - t0:.1f} s) "
              f"resident {result['memory']['argument_bytes'] / 1e9:.2f} GB "
              f"peak {result['memory']['peak_bytes'] / 1e9:.2f} GB "
              f"fits={result['fits']} coll="
              f"{result['collectives']['total_bytes']:.3e}B")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {cell_id}: FAIL {type(e).__name__}: {e}")
    result["plan_s"] = time.time() - t0
    gc.collect()
    _save(out_dir, cell_id, result)
    return result


def _save(out_dir: Optional[str], cell_id: str,
          result: Dict[str, Any]) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(result, f, indent=2, default=float)


def meshes_for(name: str) -> List[MeshLayout]:
    if name == "cards":
        return list(card_meshes())
    if name == "all":
        return list(card_meshes()) + [mesh_by_name("single"),
                                      mesh_by_name("multi")]
    return [mesh_by_name(name)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=configs.list_archs())
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--mesh", default="cards",
                    help="cards (every D x M of 1, 2, 4, 8 cards), single, "
                         "multi, all, or one DxM")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", choices=["none", "full", "dots"])
    ap.add_argument("--cache-int8", action="store_true",
                    help="decode shapes: int8-quantized KV cache")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    # refused by name below
    ap.add_argument("--fsdp", choices=["on", "off"])
    ap.add_argument("--sp", choices=["on", "off"])
    ap.add_argument("--microbatch", type=int)
    ap.add_argument("--no-zero2", action="store_true")
    ap.add_argument("--moe-mode", choices=["tp", "ep"])
    args = ap.parse_args(argv)
    for flag, dest, why in REFUSED_FLAGS:
        value = getattr(args, dest)
        if value and (dest != "moe_mode" or value == "ep"):
            ap.error(f"{flag} is not ported: {why}")
    if args.all:
        cells = [(a, s) for a in configs.list_archs()
                 for s in SHAPES_BY_NAME]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape required unless --all")
    failures = 0
    for arch, shape in cells:
        for layout in meshes_for(args.mesh):
            cid = f"{arch}__{shape}__{layout.name}" + (
                f"__{args.tag}" if args.tag else "")
            path = os.path.join(args.out, cid + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped",
                                                      "refused"):
                        continue
            r = run_cell(arch, shape, layout.name, remat=args.remat,
                         cache_int8=args.cache_int8, tag=args.tag,
                         out_dir=args.out)
            failures += r["status"] == "error"
    print(f"[dryrun] done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
