"""Manual tensor parallelism: the Megatron f/g collectives and the plan.
Reference: ``src/repro/distributed/tp.py`` (``psum_fwd``, ``psum_bwd``,
``TPContext``, ``tensor_parallel``, ``col_in``, ``row_out``,
``shared_param``, ``vocab_active``, ``sharded_embed``,
``sharded_cross_entropy``).

The spmd engine (``distributed.spmd_engine``) runs each worker's gradient
on a group of ``mesh_model`` ranks (``distributed.mesh.model_group``),
each holding its slice of the attention heads, the FFN hidden width and
the vocabulary rows (``distributed.sharding``). Every cross-rank sum is
written here, as one of two autograd operations over the model group:

* ``psum_fwd`` — all-reduce on the forward pass, identity on the backward
  pass. After a row-parallel matmul (``wo``, ``w_down``, the
  vocab-sharded embedding lookup, the cross-entropy partial sums), where
  each rank holds a partial sum and the gradient of the summed result is
  replicated.
* ``psum_bwd`` — identity on the forward pass, all-reduce on the backward
  pass. On a replicated activation entering a column-parallel matmul
  (``wq/wk/wv``, ``w_up/w_gate``, the LM head), whose forward value is
  replicated but whose gradient each rank only holds its part of.

Together they keep the gradient of every replicated activation whole on
every rank: gradients of sharded leaves come out exact and local, those of
replicated leaves (norm scales) exact and replicated, with no correction
afterwards. A bare ``dist.all_reduce`` in their place would be wrong under
autograd: it records no backward, so the gradient of a ``psum_fwd`` site
would be lost, and summing it again at a ``psum_bwd`` site is what the
backward must do, not the forward.

Both are ``torch.autograd.Function``s with ``setup_context`` and a
``vmap`` staticmethod, so they run under ``torch.func.vmap(grad(...))``
(the engine's batched worker gradients, ``spmd_engine.
make_batched_grads``): the all-reduce is elementwise, so the vmapped
worker dimension passes through it as one more dimension of the tensor.

Model code opts in through hooks that are identity unless a
:class:`TPContext` is current (the engine enters it around each worker's
forward and backward):

    ``col_in(x, group)``   -> psum_bwd when ``group`` is sharded
    ``row_out(x, group)``  -> psum_fwd when ``group`` is sharded
    ``shared_param(t, group)`` -> psum_bwd on a replicated parameter
    ``sharded_embed`` / ``sharded_cross_entropy``  (the vocab group)

Groups are ``'attn'``, ``'ffn'`` and ``'vocab'``. The context is a module
global, not thread-local as in the reference: on the card autograd runs
the backward (and ``common.Remat``'s recompute, which calls the hooks
again) on its own thread, which must see the same plan. A process is one
rank, and only the engine enters the context.

Serving's tensor-parallel decode (``serve.paged_model.build_tp_paged_fns``)
runs the same hooks forward only, and reassembles the vocab-sharded
logits with :func:`all_gather_last` (the reference's in-graph
``all_gather(..., tiled=True)``), counted in ``all_gathers``.

Each all-reduce issued here counts one in ``all_reduces`` (also inside a
CUDA-graph capture, whose count ``kernels.counters`` adds again on every
replay; ``launch/profile_train.py`` prints it per step) and runs inside a
``tp/all_reduce`` profiler range (host side only: NCCL launches on its own
stream). The collectives run in the tensor's dtype: gloo and NCCL both sum
bf16 (gloo on CUDA tensors too, through host memory).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

all_reduces = 0            # model-group all-reduces issued (kernels.counters)
all_gathers = 0            # vocab all-gathers issued (kernels.counters)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    global all_reduces
    out = x.clone(memory_format=torch.contiguous_format)
    with record_function("tp/all_reduce"):
        dist.all_reduce(out, op=op, group=group)
    all_reduces += 1
    return out


# one all-gather into a single tensor: ``all_gather_into_tensor``, named
# ``all_gather_single`` by the torch releases that deprecate the old name
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [..., n] of every rank of ``group``, concatenated in rank order
    along the last dimension ([..., size * n]), forward only: one
    all-gather into a single tensor (which concatenates along the first
    dimension), then the rank axis moved last."""
    global all_gathers
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with record_function("tp/all_gather"):
        _all_gather_single(out, x, group=group)
    all_gathers += 1
    out = out.view((size,) + tuple(x.shape))
    return out.movedim(0, -2).reshape(*x.shape[:-1], size * x.shape[-1])


class _Reduce(torch.autograd.Function):
    """``apply(x, group, op)``: the all-reduce of ``x`` over ``group``;
    its backward passes the gradient through (``psum_fwd``; a MAX is only
    ever taken of a detached tensor)."""

    @staticmethod
    def forward(x, group, op):
        return _all_reduce(x, group, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, op):
        return _Reduce.apply(x, group, op), in_dims[0]


class _Scatter(torch.autograd.Function):
    """``apply(x, group)``: ``x`` itself; its backward all-reduces the
    gradient over ``group`` (``psum_bwd``)."""

    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _Reduce.apply(grad, ctx.group, dist.ReduceOp.SUM), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _Scatter.apply(x, group), in_dims[0]


def psum_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce on forward, identity on backward (Megatron's ``f``
    merge)."""
    return _Reduce.apply(x, group, dist.ReduceOp.SUM)


def psum_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """Identity on forward, all-reduce on backward (Megatron's ``g``
    scatter)."""
    return _Scatter.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` of a tensor no gradient flows
    through."""
    return _Reduce.apply(x.detach(), group, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# The current plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Which parameter groups are sharded over which model group, and
    this rank's position in it."""

    group: Any = None                 # the model group (a ProcessGroup)
    index: int = 0                    # this rank's model index
    attn: bool = False
    ffn: bool = False
    vocab: bool = False


_ctx: Optional[TPContext] = None


@contextlib.contextmanager
def tensor_parallel(ctx: Optional[TPContext]):
    """Make ``ctx`` current for the duration (None: no TP)."""
    global _ctx
    old, _ctx = _ctx, ctx
    try:
        yield
    finally:
        _ctx = old


def _group_of(group: str):
    ctx = _ctx
    if ctx is not None and getattr(ctx, group):
        return ctx.group
    return None


def col_in(x: torch.Tensor, group: str) -> torch.Tensor:
    """Replicated activation entering a column-parallel matmul."""
    g = _group_of(group)
    return x if g is None else psum_bwd(x, g)


def row_out(x: torch.Tensor, group: str) -> torch.Tensor:
    """Partial sum leaving a row-parallel matmul."""
    g = _group_of(group)
    return x if g is None else psum_fwd(x, g)


def shared_param(params, group: str):
    """A replicated parameter dict (or tensor) read inside a sharded region
    (the per-head-dim qk-norm scales applied to head-sharded q/k):
    identity forward, all-reduce backward per leaf, so the ranks' partial
    gradients assemble into the full, replicated one."""
    g = _group_of(group)
    if g is None:
        return params
    if isinstance(params, torch.Tensor):
        return psum_bwd(params, g)
    return {k: psum_bwd(v, g) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Vocab-sharded embedding and cross entropy
# ---------------------------------------------------------------------------


def vocab_active() -> Optional[TPContext]:
    """The current context when the vocab group is sharded, else None."""
    ctx = _ctx
    return ctx if ctx is not None and ctx.vocab else None


def sharded_embed(table: torch.Tensor, ids: torch.Tensor,
                  ctx: TPContext) -> torch.Tensor:
    """Lookup into a vocab-sharded ``[V_local, d]`` table: each rank
    gathers the rows it owns (other ids give zeros) and one ``psum_fwd``
    assembles the replicated embedding, so the backward scatter stays on
    the owning rank."""
    v_local = table.shape[0]
    local = ids - ctx.index * v_local
    ok = (local >= 0) & (local < v_local)
    rows = torch.nn.functional.embedding(
        torch.clamp(local, 0, v_local - 1), table)
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return psum_fwd(rows, ctx.group)


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          valid_vocab: Optional[int],
                          ctx: TPContext) -> torch.Tensor:
    """``lse - label_logit`` over vocab-sharded logits ``[..., V_local]``:
    the max is an all-reduce MAX of a detached tensor, the sum-exp and the
    label logit are per-rank partials merged with ``psum_fwd``, so the
    full ``[..., V]`` logits never exist on one rank."""
    logits = logits.float()
    v_local = logits.shape[-1]
    start = ctx.index * v_local
    if valid_vocab is not None:
        cols = start + torch.arange(v_local, device=logits.device)
        logits = logits.masked_fill(cols >= valid_vocab, -1e30)
    m = pmax(torch.amax(logits, dim=-1, keepdim=True), ctx.group)
    lse = torch.log(psum_fwd(torch.sum(torch.exp(logits - m), dim=-1),
                             ctx.group)) + m[..., 0]
    local = labels.long() - start
    ok = (local >= 0) & (local < v_local)
    lab = torch.gather(logits, -1,
                       torch.clamp(local, 0, v_local - 1)[..., None])[..., 0]
    label_logit = psum_fwd(torch.where(ok, lab, torch.zeros_like(lab)),
                           ctx.group)
    return lse - label_logit
