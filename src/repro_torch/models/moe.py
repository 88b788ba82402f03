"""Mixture-of-experts FFN: shared + routed experts, top-k, capacity dispatch.
Reference: ``src/repro/models/moe.py`` (``padded_num_experts``,
``moe_init`` / ``_experts_init``, ``route``, ``dispatch_indices``,
``_dispatch_compute_combine``, ``moe_apply``, ``moe_param_count``).

Dispatch is the reference's sort-free formulation:
  1. router softmax (f32, whatever the model dtype) -> top-k (expert id,
     weight) per token, the weights renormalised over the k;
  2. each assignment's position inside its expert: a running count over
     the token-major flattening ``[T * k]`` (capacity ``C`` per expert;
     assignments at ``pos >= C`` are dropped, GShard / Switch semantics);
  3. tokens scattered into an ``[E, C, d]`` buffer, the batched expert
     SwiGLU, the k weighted outputs of each token gathered back and summed.

Differences of form, not of result:

* ``top_i`` comes from a stable descending sort, so tied probabilities
  pick the lower expert id first, as ``jax.lax.top_k`` does (``torch.topk``
  makes no such promise on the card).
* The combine gathers each token's k outputs to ``[T, k, d]`` and adds
  them in slot order (the reference scatter-adds them); no atomics, so a
  run repeats bit for bit and a captured graph equals the eager run. The
  scatter into the buffer is an out-of-place ``index_copy``: kept slots
  are written once each, and only the drop slot (sliced away) takes
  several rows.
* Everything stays on the device with shapes fixed by ``T`` (the capacity
  is host math on the static token count): no ``.item()``, no
  ``nonzero``, no boolean-mask indexing, so the decode graph and the
  training step graph capture it and ``torch.func.vmap`` (the spmd
  engine's batched worker gradients) goes through it.

Partitioning: the reference's ``'ep'`` mode pads ``E`` to a multiple of 16
with the pad logits at -1e30; that is ported (``moe_init``, ``route``).
Its expert-sharded buffer constraint (``_maybe_ep_constraint``) and the
``shard_map`` over the data axes in ``moe_apply`` act only under a GSPMD
mesh with ``distributed.context.moe_data_sharding`` (the reference's
dry-run launcher); the port has the plain path, which is what the
reference runs on one device, in decode and in its tests.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common, mlp


def padded_num_experts(num_experts: int, multiple: int = 16) -> int:
    return ((num_experts + multiple - 1) // multiple) * multiple


def moe_init(gen, cfg, dtype=torch.float32, device=None) -> nn.ModuleDict:
    """Router (f32 whatever ``dtype``), the routed experts' stacked SwiGLU
    weights ``[E, d_in, d_out]`` and, with shared experts, one dense
    SwiGLU of ``shared_d_ff``."""
    m = cfg.moe
    d = cfg.d_model
    e = (padded_num_experts(m.num_experts) if m.partition_mode == "ep"
         else m.num_experts)
    p = {
        "router": common.dense_init(gen, d, e, torch.float32, device),
        "w_gate": _experts_init(gen, e, d, m.expert_d_ff, dtype, device),
        "w_up": _experts_init(gen, e, d, m.expert_d_ff, dtype, device),
        "w_down": _experts_init(gen, e, m.expert_d_ff, d, dtype, device),
    }
    if m.num_shared_experts > 0:
        p["shared"] = mlp.mlp_init(gen, d, m.shared_d_ff, "swiglu", dtype,
                                   device)
    return nn.ModuleDict(p)


def _experts_init(gen, e: int, d_in: int, d_out: int, dtype,
                  device) -> nn.ParameterDict:
    std = 1.0 / math.sqrt(d_in)
    return nn.ParameterDict({"w": nn.Parameter(common.trunc_normal(
        gen, (e, d_in, d_out), std, dtype, device))})


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_params, x: torch.Tensor, num_real_experts: int,
          top_k: int):
    """x: [T, d] -> (weights [T, k] f32, ids [T, k] int64, probs [T, E]
    f32, aux_loss 0-d f32)."""
    logits = common.dense(router_params, x.float())               # [T, E]
    e_total = logits.shape[-1]
    experts = torch.arange(e_total, device=x.device)
    if num_real_experts < e_total:                       # padding experts
        logits = logits.masked_fill(experts >= num_real_experts, -1e30)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, top_k)
    top_w = top_w / torch.clamp_min(torch.sum(top_w, dim=-1, keepdim=True),
                                    1e-9)
    # Switch aux loss: fraction routed (first choice) vs mean prob
    f = torch.mean((top_i[:, :1] == experts).float(), dim=0)
    pbar = torch.mean(probs, dim=0)
    aux = e_total * torch.sum(f * pbar)
    return top_w, top_i, probs, aux


def dispatch_indices(top_i: torch.Tensor, num_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position of each (token, slot) assignment inside its expert buffer:
    (pos [T, k] int32, keep [T, k] bool); assignments at or past the
    capacity are dropped (keep False), GShard-style."""
    t, k = top_i.shape
    flat = top_i.reshape(-1)                                     # [T*k]
    onehot = (flat[:, None] == torch.arange(
        num_experts, device=top_i.device)).to(torch.int32)       # [T*k, E]
    pos_flat = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos_flat, 1, flat[:, None])[:, 0]
    return pos.reshape(t, k), (pos < capacity).reshape(t, k)


def capacity(capacity_factor: float, tokens: int, top_k: int,
             num_experts: int) -> int:
    """Slots per expert for ``tokens`` routed tokens (the reference's
    ``int(max(1, capacity_factor * T * k / E))``)."""
    return int(max(1, capacity_factor * tokens * top_k / num_experts))


def _dispatch_compute_combine(experts, cfg, x: torch.Tensor,
                              top_w: torch.Tensor, top_i: torch.Tensor,
                              capacity_factor: float) -> torch.Tensor:
    """Scatter -> batched expert SwiGLU -> weighted gather. x: [T, d];
    top_w / top_i: [T, k]. The capacity is reckoned from T (every row
    handed in: decode's idle slots and prefill's padding take capacity
    too, as in the reference)."""
    t, d = x.shape
    e = experts["w_gate"]["w"].shape[0]                # padded E in 'ep'
    k = top_i.shape[1]
    cap = capacity(capacity_factor, t, k, e)
    pos, keep = dispatch_indices(top_i, e, cap)
    # flat slot in [E * (cap + 1)]: (expert, pos), or the expert's drop
    # slot at cap
    slot = (top_i * (cap + 1) + torch.where(keep, pos,
                                            torch.full_like(pos, cap))
            ).reshape(-1)
    rows = x[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e * (cap + 1), d), dtype=x.dtype,
                      device=x.device).index_copy(0, slot, rows)
    buf = buf.reshape(e, cap + 1, d)[:, :cap]
    g = torch.bmm(buf, experts["w_gate"]["w"])
    u = torch.bmm(buf, experts["w_up"]["w"])
    y = torch.bmm(F.silu(g) * u, experts["w_down"]["w"])     # [E, C, d]
    y = F.pad(y, (0, 0, 0, 1))                 # drop slot -> zeros
    gathered = y.reshape(e * (cap + 1), d).index_select(0, slot)
    w = (top_w * keep).to(x.dtype)
    parts = (gathered.reshape(t, k, d) * w[:, :, None]).unbind(1)
    out = parts[0]
    for part in parts[1:]:                     # the reference's add order
        out = out + part
    return out


def moe_apply(params, cfg, x: torch.Tensor,
              capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, d] -> (out [T, d], aux_loss 0-d f32, times
    ``router_aux_weight``)."""
    m = cfg.moe
    top_w, top_i, _, aux = route(params["router"], x, m.num_experts,
                                 m.top_k)
    out = _dispatch_compute_combine(params, cfg, x, top_w, top_i,
                                    capacity_factor)
    if "shared" in params:
        out = out + mlp.mlp_apply(params["shared"], x, "swiglu")
    return out, aux * m.router_aux_weight


def moe_param_count(cfg, active_only: bool = False) -> int:
    m = cfg.moe
    d = cfg.d_model
    e = m.top_k if active_only else m.num_experts
    n = e * 3 * d * m.expert_d_ff                          # swiglu experts
    n += d * m.num_experts                                 # router
    if m.num_shared_experts > 0:
        n += 3 * d * m.shared_d_ff                         # swiglu, no bias
    return n
