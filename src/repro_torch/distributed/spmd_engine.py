"""The spmd execution engine: each worker's own gradient, then the masked
reduce, over a ``('data', 'model')`` mesh of ranks.
Reference: ``src/repro/distributed/spmd_engine.py`` (``validate_layout``,
``validate_grad_batch``, ``flatten_stacked`` / ``unflatten_vector``,
``make_worker_loss``, ``resolve_tp``, ``build_spmd_step``,
``build_spmd_chunk_step``, ``_traced``; :109-476. The reference's
``make_train_step`` and ``make_chunk_step`` (:478-516) wrap those in
``jax.jit`` with shardings; the trainer installs ``build_spmd_step`` and
``build_spmd_chunk_step`` directly, and the chunk step's CUDA graph is
the port's counterpart of the jitted K-step scan).

The W workers lie contiguously over the ``'data'`` axis: with
``mesh_data`` positions on it (``distributed.mesh``: one process per
mesh position) the ranks at data index d own workers ``[d * W_local, (d
+ 1) * W_local)``, ``W_local = W / mesh_data``, and only their rows of
the worker-contiguous batch. At mesh 1 x 1 one card holds all W and no
collective is issued.

Tensor parallelism over the ``'model'`` axis: with ``mesh_model > 1`` and
a plan (``resolve_tp``: ``sharding.tp_plan`` of ``model_cfg``) the model
becomes each rank's slice (``models.convert.shard_model``: 1/M of the
attention heads, of the FFN hidden width and of the tied vocabulary rows;
the config's head counts and width divided), and each worker's gradient
runs under the ``distributed.tp`` context, whose hooks all-reduce over
the model group (``mesh.model_group``) at the contracted dimensions. The
``[W_local, P]`` stack is then the rank's ``[W_local, P_local]``: the
masked reduce, the all-reduce over the ``'data'`` group, the optimizer
and the EMA all act on the rank's slices. The loss and aux sums are the
same on every rank of a model group (the cross entropy ends in
all-reduces). ``clip_by_global_norm`` sums the squares of the sharded
leaves over the model group and counts the replicated ones once. When no
group can shard (rwkv6, a model override, an indivisible config) the
engine warns and carries the axis replicated: every rank of a model group
computes the same gradients, with no model-axis collective.

Per step, on every rank:

1. the local workers' gradients, in groups of ``grad_batch`` (the
   reference's ``vmap`` / ``lax.map``): ``0`` one group of all
   ``W_local``, ``k`` groups of k one after another, ``1`` one worker at a
   time through ``torch.autograd.grad``. A group of k > 1 is one
   ``torch.func.vmap(torch.func.grad_and_value(...))`` over the worker loss
   (``functional_call`` of the model with its detached parameters), so
   every op of the k workers runs as one batched op. A worker's gradient is
   that of its own mini-batch mean; the group's ``[k, ...]`` gradients are
   written as f32 into rows of one preallocated ``[W_local, P]`` stack
   (``flatten_into``; allocated once, reused; one group's gradients exist
   at a time);
2. ``reduce_then_psum`` masked-reduces the stack with the rank's slice of
   the ``[W]`` mask (``backup_reduce``) and, over ranks, all-reduces each
   bucket, the loss and aux sums riding the last;
3. ``unflatten_vector`` casts the ``[P]`` result back to each parameter's
   dtype (bf16 at full width);
4. the ``loss`` metric over the selected workers of every rank,
   ``clip_by_global_norm`` when ``clip_norm > 0``, the optimizer and the
   EMA, in place, replicated: every rank applies the same aggregate.

The three phases are ``torch.profiler`` ranges (``spmd/worker_grad`` per
group, ``spmd/reduce``, ``spmd/update``), which
``launch/profile_train.py`` reads. They mark the eager step only: a graph
replay runs no Python and records no range.

``build_spmd_chunk_step`` runs K such steps over stacked inputs. On the
card one CUDA graph captures the whole step (the groups' gradients, the
``[W_local, P]`` stack, ``reduce_then_psum`` with the ``backup_reduce``
kernel and the NCCL all-reduce, unflatten, clip, the optimizer and the
EMA, with the model group's all-reduces under TP); each step of a chunk
copies its batch, mask and scalar rows into the graph's buffers and
replays it (``core.step_graph``). The eager step before the capture has
used every communicator, as NCCL needs before a capture.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.core import ema as ema_lib
from repro_torch.core import step_graph
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed import sharding, tp
from repro_torch.kernels.bucketed_reduce import reduce_then_psum
from repro_torch.models import convert
from repro_torch.optim import optimizers as opt_lib

WORKER_AXIS = mesh_lib.WORKER_AXIS
MODEL_AXIS = mesh_lib.MODEL_AXIS


# ---------------------------------------------------------------------------
# Layout validation
# ---------------------------------------------------------------------------


def check_mesh(mesh_data: int, mesh_model: int) -> None:
    """Both mesh axes must be at least 1."""
    if mesh_data < 1 or mesh_model < 1:
        raise ValueError(f"mesh axes must be >= 1 (got {mesh_data} x "
                         f"{mesh_model})")


def resolve_tp(model_cfg, mesh_model: int) -> sharding.TPPlan:
    """The TP plan for a ``'model'`` axis of ``mesh_model`` ranks and a
    model config. Warns when ``mesh_model > 1`` but no parameter group can
    shard (indivisible config, biased layers, a family without the hooks,
    or a model override without a config): the axis is then carried
    replicated."""
    plan = sharding.tp_plan(model_cfg, mesh_model)
    if mesh_model > 1 and not plan.any:
        warnings.warn(
            f"mesh_model={mesh_model} but no parameter group is shardable "
            f"for this model (see sharding.tp_plan: divisibility, biases, "
            f"family); the '{MODEL_AXIS}' axis will be carried (replicated)",
            stacklevel=2)
    return plan


def tp_global_norm(grads: Dict[str, torch.Tensor],
                   dims: Dict[str, Optional[int]], group) -> torch.Tensor:
    """The global norm of a TP rank's gradient slices: the squares of the
    sharded leaves summed over the model ``group``, those of the
    replicated leaves (the same on every rank) counted once."""
    zero = torch.zeros((), device=next(iter(grads.values())).device)

    def sq(split: bool) -> torch.Tensor:
        return sum((torch.sum(torch.square(g.float()))
                    for k, g in grads.items()
                    if (dims.get(k) is not None) == split), zero)

    return torch.sqrt(tp.psum_fwd(sq(True), group) + sq(False))


def validate_layout(num_workers: int, global_batch: int,
                    mesh_data: int) -> int:
    """Checks W/B divisibility over the data axis; returns W_local."""
    if mesh_data < 1:
        raise ValueError(f"mesh_data must be >= 1 (got {mesh_data})")
    if num_workers % mesh_data:
        raise ValueError(
            f"spmd engine maps workers onto the '{WORKER_AXIS}' axis: "
            f"total_workers ({num_workers}) must be divisible by "
            f"mesh_data ({mesh_data})")
    if global_batch % num_workers:
        raise ValueError(
            f"global_batch ({global_batch}) must be divisible by "
            f"total_workers ({num_workers})")
    return num_workers // mesh_data


def validate_grad_batch(grad_batch: int, w_local: int) -> int:
    """Resolve ``ExecutionConfig.grad_batch`` against the local worker
    count; returns the effective batch size (0 = all local workers)."""
    if grad_batch < 0:
        raise ValueError(
            f"grad_batch: expected a non-negative worker-batch size, got "
            f"{grad_batch} (0 = all local workers at once, 1 = one worker "
            f"at a time, k = groups of k workers)")
    if grad_batch and w_local % grad_batch:
        divisors = [d for d in range(1, w_local + 1) if w_local % d == 0]
        raise ValueError(
            f"grad_batch: {grad_batch} does not divide the per-shard "
            f"worker count W_local={w_local} (total_workers / mesh_data); "
            f"valid values here: 0 (vmap all) or one of {divisors}")
    return grad_batch or w_local


def resolve_use_kernel(use_kernel: Optional[bool], interpret: Optional[bool],
                       device: torch.device) -> bool:
    """``None``: the CUDA kernel on the card, the plain twin on the CPU.
    ``True`` on the CPU and ``interpret=True`` (Pallas-only) raise."""
    if interpret:
        raise ValueError("interpret=True is Pallas interpret mode, which the "
                         "CUDA port has no counterpart of; leave it None")
    if use_kernel is None:
        return device.type == "cuda"
    if use_kernel and device.type != "cuda":
        raise ValueError(f"use_kernel=True needs the card: the backup_reduce "
                         f"kernel does not run on {device}")
    return bool(use_kernel)


# ---------------------------------------------------------------------------
# The [W, P] stack: flatten / unflatten
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Where each named tensor lives in a flat [P] vector."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]          # len(names) + 1, offsets[-1] == P

    @property
    def total(self) -> int:
        return self.offsets[-1]


def flat_spec(named: Dict[str, torch.Tensor]) -> FlatSpec:
    shapes = tuple(tuple(t.shape) for t in named.values())
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    return FlatSpec(tuple(named), shapes,
                    tuple(t.dtype for t in named.values()),
                    tuple(int(o) for o in np.cumsum([0] + sizes)))


def flatten_into(rows: torch.Tensor, tensors: Sequence[torch.Tensor],
                 spec: FlatSpec) -> None:
    """Write ``tensors`` (in ``spec`` order) into the f32 ``rows``: a [P]
    row from one worker's tensors, or [k, P] rows from the ``[k, ...]``
    tensors of k workers."""
    lead = tuple(rows.shape[:-1])
    for i, t in enumerate(tensors):
        rows[..., spec.offsets[i]:spec.offsets[i + 1]].copy_(
            t.reshape(lead + (-1,)))


def flatten_stacked(stacked: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, FlatSpec]:
    """``{name: [W, ...]}`` -> ([W, P] f32, spec of the per-worker shapes)."""
    spec = flat_spec({k: v[0] for k, v in stacked.items()})
    first = next(iter(stacked.values()))
    flat = torch.empty((first.shape[0], spec.total), dtype=torch.float32,
                       device=first.device)
    for w in range(first.shape[0]):
        flatten_into(flat[w], [v[w] for v in stacked.values()], spec)
    return flat, spec


def unflatten_vector(vec: torch.Tensor, spec: FlatSpec
                     ) -> Dict[str, torch.Tensor]:
    """[P] f32 -> ``{name: tensor}`` with the spec's shapes and dtypes."""
    return {name: vec[spec.offsets[i]:spec.offsets[i + 1]]
            .reshape(spec.shapes[i]).to(spec.dtypes[i])
            for i, name in enumerate(spec.names)}


# ---------------------------------------------------------------------------
# Per-worker loss (paper semantics: each worker's own mini-batch mean)
# ---------------------------------------------------------------------------


def per_example_loss(model, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-example mean token loss [B], aux): invalid labels (< 0) carry
    no weight, and neither do a vlm prefix's positions (the per-token loss
    is ``[B, P + S]`` against ``[B, S]`` labels: the labels are padded with
    -1 ahead, as in both reference loss functions)."""
    per_tok, aux = model.per_token_loss(batch)
    labels = torch.as_tensor(batch["labels"], device=per_tok.device)
    if per_tok.shape[1] != labels.shape[1]:           # vlm prefix positions
        pad = torch.full((labels.shape[0], per_tok.shape[1] - labels.shape[1]),
                         -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    valid = (labels >= 0).float()
    per_ex = (torch.sum(per_tok * valid, dim=-1)
              / torch.clamp_min(torch.sum(valid, dim=-1), 1.0))
    return per_ex, aux


def make_worker_loss(model) -> Callable:
    """loss(worker_batch) -> (scalar, mean_loss, aux): the gradient of the
    scalar is the worker's own gradient, its aux loss included."""

    def loss_fn(batch):
        per_ex, aux = per_example_loss(model, batch)
        mean_loss = torch.mean(per_ex)
        return mean_loss + aux, mean_loss, aux

    return loss_fn


class _WorkerLoss(nn.Module):
    """The worker loss as a module's ``forward``, so that
    ``torch.func.functional_call`` can swap the model's parameters (keys
    ``model.<name>``)."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.loss = make_worker_loss(model)

    def forward(self, batch):
        total, mean_loss, aux = self.loss(batch)
        return total, (mean_loss, aux)


def make_batched_grads(model) -> Callable:
    """grads(params, group) -> ({"model.<name>": [k, ...]}, (total [k],
    (mean_loss [k], aux [k]))): each of the k workers' own gradient, one
    ``torch.func.vmap`` over ``grad_and_value`` of the worker loss.
    ``params`` ({"model.<name>": tensor}, detached) is shared; ``group``'s
    leaves are ``[k, rows, ...]``."""
    holder = _WorkerLoss(model)

    def loss(params, batch):
        return torch.func.functional_call(holder, params, (batch,))

    return torch.func.vmap(
        torch.func.grad_and_value(loss, has_aux=True), in_dims=(None, 0))


# ---------------------------------------------------------------------------
# The engine step
# ---------------------------------------------------------------------------


def build_spmd_step(model, optimizer: opt_lib.Optimizer, *,
                    num_workers: int, n_aggregate: int,
                    ema_decay: float = 0.0, clip_norm: float = 0.0,
                    use_kernel: Optional[bool] = None,
                    interpret: Optional[bool] = None,
                    grad_batch: int = 0, bucket_size: int = 0,
                    mesh_data: int = 1, mesh_model: int = 1,
                    model_cfg=None, tracer=None) -> Callable:
    """Twin of ``train_step.build_train_step`` — same signature:

        step(opt_state, ema, scalars, batch, mask) -> metrics

    ``model`` holds the parameters; the step updates them, ``opt_state``
    and ``ema`` in place. ``batch`` holds this rank's rows of the
    worker-contiguous global batch (all of it at ``mesh_data = 1``),
    ``mask`` the host-planned [W] selection of every worker, both on the
    model's device. With ``mesh_data * mesh_model > 1`` this process must
    be a rank of a world of that size (``distributed.mesh.spawn``). With
    ``mesh_model > 1`` and a plan for ``model_cfg`` (the config ``model``
    was built from; None for a model without one) ``model`` is made this
    rank's slice in place (``convert.shard_model``) before anything else:
    build the optimizer state and EMA after this call. A live ``tracer``
    brackets each call with the ``spmd/*`` spans (``_traced``). On an MoE
    config the experts, router and shared experts stay whole on every rank
    of the model group (``sharding.tp_plan``): the MoE FFN runs on the
    replicated residual stream, so their gradients come out whole and the
    same on every rank, as the norm scales' do."""
    check_mesh(mesh_data, mesh_model)
    if num_workers % mesh_data:
        raise ValueError(
            f"total_workers ({num_workers}) must be divisible by the "
            f"'{WORKER_AXIS}' axis size ({mesh_data})")
    group = mesh_lib.data_group(mesh_data, mesh_model)
    mgroup = mesh_lib.model_group(mesh_data, mesh_model)
    w_local = num_workers // mesh_data
    first = mesh_lib.data_index() * w_local
    gb = validate_grad_batch(grad_batch, w_local)
    kernel = resolve_use_kernel(use_kernel, interpret, model.device)
    plan = resolve_tp(model_cfg, mesh_model)
    tp_ctx = None
    if plan.any:
        index = mesh_lib.model_index()
        convert.shard_model(model, plan, index)
        tp_ctx = tp.TPContext(mgroup, index, plan.attn, plan.ffn, plan.vocab)
    worker_loss = make_worker_loss(model)
    batched = make_batched_grads(model) if gb > 1 else None
    spec = flat_spec(dict(model.named_parameters()))
    stack: List[torch.Tensor] = []        # the [W_local, P] stack, made once

    def group_grads(flat, params, shards, g0):
        """Gradients of workers [g0, g0 + gb) into rows of ``flat``;
        returns their (mean_loss, aux), each [gb]."""
        if batched is None:
            shard = {k: v[g0] for k, v in shards.items()}
            total, mean_loss, aux = worker_loss(shard)
            grads = torch.autograd.grad(total, list(params.values()))
            with torch.no_grad():
                flatten_into(flat[g0], grads, spec)
            return mean_loss.detach()[None], aux.detach()[None]
        detached = {f"model.{k}": v.detach() for k, v in params.items()}
        grads, (_, (mean_loss, aux)) = batched(
            detached, {k: v[g0:g0 + gb] for k, v in shards.items()})
        with torch.no_grad():
            flatten_into(flat[g0:g0 + gb], grads.values(), spec)
        return mean_loss, aux

    def step_fn(opt_state, ema_state, scalars, batch, mask):
        # looked up per call: init_state / restore may replace the tensors
        params = dict(model.named_parameters())
        if not stack:
            stack.append(torch.empty((w_local, spec.total),
                                     dtype=torch.float32,
                                     device=model.device))
        flat = stack[0]
        shards = {k: v.reshape((w_local, v.shape[0] // w_local)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
        losses, auxes = [], []
        for g0 in range(0, w_local, gb):
            with record_function("spmd/worker_grad"), \
                    tp.tensor_parallel(tp_ctx):
                mean_loss, aux = group_grads(flat, params, shards, g0)
            losses.append(mean_loss)
            auxes.append(aux)
        with torch.no_grad(), record_function("spmd/reduce"):
            mf = mask.float()
            local = mask[first:first + w_local]
            tail = torch.stack([torch.sum(torch.cat(losses) * mf[
                first:first + w_local]), torch.sum(torch.cat(auxes))])
            red, tail = reduce_then_psum(flat, local, n_aggregate,
                                         bucket=bucket_size, tail=tail,
                                         use_kernel=kernel, group=group)
            agg = unflatten_vector(red, spec)
            del red
        with torch.no_grad(), record_function("spmd/update"):
            frac = torch.sum(mf) / n_aggregate
            metrics = {"loss": (tail[0] / n_aggregate)
                       / torch.clamp_min(frac, 1e-6),
                       "aux_loss": tail[1] / num_workers}
            if clip_norm > 0:
                agg, gnorm = opt_lib.clip_by_global_norm(
                    agg, clip_norm, norm=tp_global_norm(
                        agg, model.tp_dims, mgroup) if tp_ctx else None)
                metrics["grad_norm"] = gnorm
            optimizer.apply(params, agg, opt_state, scalars)
            del agg
            if ema_decay > 0:
                ema_lib.update(ema_state, params.items(), ema_decay)
        return metrics

    return _traced(step_fn, tracer, model.device)


def _traced(fn: Callable, tracer, device) -> Callable:
    """``fn`` (a step or a chunk) with its call under ``spmd/dispatch`` and
    then a ``torch.cuda.synchronize`` under ``spmd/collective_wait``
    (reference: ``spmd_engine._traced``). Only with a live tracer: the
    fence serializes the host against the card, so an untraced run keeps
    the bare ``fn``. A chunk's ``graph`` attribute is kept."""
    if tracer is None or not tracer.enabled:
        return fn
    device = torch.device(device)

    def call(*args):
        with tracer.span("spmd/dispatch"):
            out = fn(*args)
        with tracer.span("spmd/collective_wait"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return out

    call.graph = getattr(fn, "graph", None)
    return call


def build_spmd_chunk_step(model, optimizer: opt_lib.Optimizer, *,
                          tracer=None, **step_kwargs) -> Callable:
    """Twin of the host-mask ``train_step.build_chunk_step``: K engine
    steps per call,

        chunk(opt_state, ema, scalars {name: [K]}, batches {name: [K, B,
              ...]}, masks [K, W]) -> metrics {name: [K]}

    The body is the unmodified ``build_spmd_step`` step, so chunking
    changes only how the steps are dispatched. A live ``tracer`` brackets
    the chunk, never a step inside the captured graph."""
    return _traced(step_graph.chunk_step(
        build_spmd_step(model, optimizer, **step_kwargs), model), tracer,
        model.device)

