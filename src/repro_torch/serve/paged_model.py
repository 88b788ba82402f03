"""Paged prefill + decode: the device halves of the serve engine.
Reference: ``src/repro/serve/paged_model.py`` (``supports_paged``,
``build_paged_decode``, ``build_paged_prefill``, ``tp_pool_specs``,
``build_tp_paged_fns``).

* ``prefill(packed, n_pages, pool)`` runs the stack over one bucket-padded
  prompt. ``packed`` is one int32 device vector ``[true_len, *page_ids,
  *tokens]`` (one host->device transfer per admission). Every layer's
  attention goes through :func:`repro_torch.kernels.flash_attention.
  flash_attention`. It returns the greedy first token (from the hidden
  state at ``true_len - 1``) and scatters the whole bucket's K/V, padding
  included, into the request's pages (quantized first for an int8 pool).
  Padding positions are masked by decode's validity rule (``kpos <= len``)
  until real decode tokens overwrite them.
* ``decode(state, pool)`` advances every slot one token. ``state`` packs
  per slot ``[last_token, len, *page_table_row]`` as one int32 device
  tensor. Each layer scatters the new K/V at ``(page_table[b, len // ps],
  len % ps)``, gathers each slot's pages with :func:`repro_torch.kernels.
  page_gather.gather_pages`, attends under the validity + window mask and
  the greedy argmax stays on the device. Idle slots carry a zeroed
  page-table row, so their dead writes land on the trash page and the
  host ignores their tokens. Rows that write one (page, offset) all write
  the last such row's K/V (the reference's scatter order on the CPU): the
  trash page's content then does not hang on the order of racing writes
  on the card, which matters for MoE, whose idle rows take capacity.

An MoE layer's FFN routes the step's ``[B * S, d]`` rows through
``models.moe.moe_apply`` (the reference's ``_ffn``): decode routes all B
slots, idle ones included, and prefill the whole bucket, padding included,
so both take capacity as the reference's do.

Both update the pool's tensors in place (the reference returns a new
pool); layers are a Python loop (the reference's ``lax.scan``). Both carry
the tensor-parallel hooks where ``transformer.block_apply`` has them
(``tp.col_in`` / ``tp.row_out`` around attention and the FFN, ``col_in``
on the head), identity unless a ``tp.TPContext`` is current, and call
``gather_logits`` on the logits before the greedy argmax.

Tensor parallelism (:func:`build_tp_paged_fns`, the reference's
``shard_map`` over the mesh ``'model'`` axis): each rank of the model
group runs the same functions on its slice of the model
(``convert.shard_model``: its config holds the local head counts and FFN
width) and of the pool (the kv-head axis, when the plan shards
attention), inside a ``TPContext``; the vocab-sharded logits are
all-gathered (``tp.all_gather_last``) before the argmax, so every rank
picks the same token as one card.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed import tp
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.page_gather import gather_pages
from repro_torch.models import attention, common
from repro_torch.models.transformer import block_ffn

Pool = Dict[str, torch.Tensor]


def supports_paged(cfg) -> Tuple[bool, str]:
    """Families the paged serve path covers (mirrors decode_step support):
    the reference's, with its messages."""
    if cfg.family not in ("dense", "moe"):
        return False, f"family {cfg.family!r} has no paged decode path"
    if cfg.attention_kind != "gqa":
        return False, (f"attention_kind {cfg.attention_kind!r} is not paged "
                       f"(MLA latents need their own page layout)")
    return True, ""


def _identity(logits: torch.Tensor) -> torch.Tensor:
    return logits


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _paged_attn(p_attn, cfg, h, pool: Pool, layer: int, lens, page_table,
                window: int, *, quantized: bool, use_kernel: bool):
    """One layer's paged decode attention. h: [B, 1, d] (post-ln)."""
    b = h.shape[0]
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    ps = pool["k"].shape[2]
    q, k_new, v_new = attention._project_qkv(p_attn, cfg, h, lens[:, None])
    # scatter the new token's K/V into its slot's current page
    bidx = torch.arange(b, device=h.device)
    pid = page_table[bidx, lens // ps].long()           # idle rows -> trash
    off = (lens % ps).long()
    dest = pid * ps + off
    last = torch.where(dest[:, None] == dest[None, :], bidx[None, :],
                       -1).amax(dim=1)                  # last row per dest
    k_new, v_new = k_new[last], v_new[last]
    k_pool, v_pool = pool["k"][layer], pool["v"][layer]
    if quantized:
        kq, ksc = attention._quantize_kv(k_new[:, 0])
        vq, vsc = attention._quantize_kv(v_new[:, 0])
        k_scale, v_scale = pool["k_scale"][layer], pool["v_scale"][layer]
        k_pool[pid, off] = kq
        v_pool[pid, off] = vq
        k_scale[pid, off] = ksc
        v_scale[pid, off] = vsc
        k = gather_pages(k_pool, page_table, k_scale, out_dtype=h.dtype,
                         use_kernel=use_kernel)
        v = gather_pages(v_pool, page_table, v_scale, out_dtype=h.dtype,
                         use_kernel=use_kernel)
    else:
        k_pool[pid, off] = k_new[:, 0].to(k_pool.dtype)
        v_pool[pid, off] = v_new[:, 0].to(v_pool.dtype)
        k = gather_pages(k_pool, page_table, out_dtype=h.dtype,
                         use_kernel=use_kernel)
        v = gather_pages(v_pool, page_table, out_dtype=h.dtype,
                         use_kernel=use_kernel)
    s = k.shape[1]                                        # max_pages * ps
    qg = q.reshape(b, kv, cfg.q_per_kv, hd)
    # scores in the model dtype, then f32; probs back in v's dtype for PV
    scores = torch.einsum("bgqd,bsgd->bgqs", qg, k).float() / math.sqrt(hd)
    scores = common.softcap(scores, cfg.attn_logit_softcap)
    kpos = torch.arange(s, device=h.device)
    valid = (kpos[None, :] <= lens[:, None]) & attention._window_ok(
        lens[:, None] - kpos[None, :], window)
    scores = scores.masked_fill(~valid[:, None, None, :], attention.NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgqs,bsgd->bgqd", probs.to(v.dtype), v)
    out = out.reshape(b, 1, cfg.num_heads * hd)
    return common.dense(p_attn["wo"], out)


def build_paged_decode(model, *, quantized: bool, use_kernel: bool = True,
                       gather_logits: Callable = _identity) -> Callable:
    """decode(state[B, 2+maxp] int32, pool) -> next_token [B] int32.

    ``state[:, 0]`` last tokens, ``state[:, 1]`` lens, ``state[:, 2:]`` the
    page table. Greedy argmax happens on the device, after
    ``gather_logits`` (TP: the vocab shards' all-gather)."""
    cfg = model.cfg

    @torch.inference_mode()
    def decode(state: torch.Tensor, pool: Pool) -> torch.Tensor:
        tokens = state[:, 0:1].long()
        lens = state[:, 1].long()
        page_table = state[:, 2:].contiguous()
        x = model._embed_inputs(tokens)
        for layer, (p_l, win, kind) in enumerate(zip(
                model.layers, model.windows, model.kinds)):
            h1 = tp.col_in(common.rmsnorm(p_l["ln1"], x, cfg.norm_eps),
                           "attn")
            x = x + tp.row_out(_paged_attn(
                p_l["attn"], cfg, h1, pool, layer, lens, page_table, win,
                quantized=quantized, use_kernel=use_kernel), "attn")
            h2 = common.rmsnorm(p_l["ln2"], x, cfg.norm_eps)
            x = x + block_ffn(p_l, cfg, kind, h2)[0]
        x = common.rmsnorm(model.final_norm, x, cfg.norm_eps)
        logits = gather_logits(
            (tp.col_in(x, "vocab") @ model._output_weights())[:, 0])
        return torch.argmax(logits, dim=-1).to(torch.int32)

    return decode


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def build_paged_prefill(model, *, quantized: bool, use_kernel: bool = True,
                        gather_logits: Callable = _identity) -> Callable:
    """prefill(packed, n_pages, pool) -> first token (0-d int32 tensor).

    ``packed`` is ``[true_len, *page_ids (n_pages), *tokens (bucket)]``
    int32 on the device; ``true_len`` also arrives as a host int so the
    last-position slice needs no device read. ``gather_logits`` as in
    :func:`build_paged_decode`."""
    cfg = model.cfg
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    @torch.inference_mode()
    def prefill(packed: torch.Tensor, true_len: int, n_pages: int,
                pool: Pool) -> torch.Tensor:
        page_ids = packed[1:1 + n_pages].long()
        tokens = packed[None, 1 + n_pages:].long()
        x = model._embed_inputs(tokens)
        s = x.shape[1]
        ps = pool["k"].shape[2]
        if s != n_pages * ps:
            raise ValueError(f"bucket {s} is not {n_pages} pages of {ps}")
        positions = torch.arange(s, device=x.device)[None]
        for layer, (p_l, win, kind) in enumerate(zip(
                model.layers, model.windows, model.kinds)):
            h1 = tp.col_in(common.rmsnorm(p_l["ln1"], x, cfg.norm_eps),
                           "attn")
            q, k, v = attention._project_qkv(p_l["attn"], cfg, h1, positions)
            out = flash_attention(q, k, v, causal=True, window=win,
                                  softcap=cfg.attn_logit_softcap,
                                  use_kernel=use_kernel)
            x = x + tp.row_out(common.dense(p_l["attn"]["wo"],
                                            out.reshape(1, s, -1)), "attn")
            h2 = common.rmsnorm(p_l["ln2"], x, cfg.norm_eps)
            x = x + block_ffn(p_l, cfg, kind, h2)[0]
            # scatter the prompt K/V (the whole bucket) into its pages
            if quantized:
                for name, t in (("k", k), ("v", v)):
                    tq, tsc = attention._quantize_kv(t[0])
                    pool[name][layer, page_ids] = tq.reshape(
                        n_pages, ps, kv, hd)
                    pool[f"{name}_scale"][layer, page_ids] = tsc.reshape(
                        n_pages, ps, kv)
            else:
                for name, t in (("k", k), ("v", v)):
                    pool[name][layer, page_ids] = t[0].reshape(
                        n_pages, ps, kv, hd).to(pool[name].dtype)
        x = common.rmsnorm(model.final_norm, x[:, true_len - 1:true_len],
                           cfg.norm_eps)
        logits = gather_logits(
            (tp.col_in(x, "vocab") @ model._output_weights())[0, 0])
        return torch.argmax(logits).to(torch.int32)

    return prefill


# ---------------------------------------------------------------------------
# Tensor parallelism (the mesh 'model' axis over a model group of ranks)
# ---------------------------------------------------------------------------


def build_tp_paged_fns(model, ctx: tp.TPContext, *, quantized: bool,
                       use_kernel: bool = True):
    """(prefill, decode) of one rank of the model group, over ``model``
    already cut to this rank's slice (``convert.shard_model``; its config
    holds the local head counts, so a rank's pool holds its kv heads when
    attention shards, as the reference's ``tp_pool_specs``): each runs
    inside ``ctx`` and all-gathers the vocab-sharded logits before the
    greedy argmax when the vocabulary shards."""
    gather = _identity
    if ctx.vocab:
        def gather(logits):
            return tp.all_gather_last(logits, ctx.group)

    decode_core = build_paged_decode(model, quantized=quantized,
                                     use_kernel=use_kernel,
                                     gather_logits=gather)
    prefill_core = build_paged_prefill(model, quantized=quantized,
                                       use_kernel=use_kernel,
                                       gather_logits=gather)

    def decode(state, pool):
        with tp.tensor_parallel(ctx):
            return decode_core(state, pool)

    def prefill(packed, true_len, n_pages, pool):
        with tp.tensor_parallel(ctx):
            return prefill_core(packed, true_len, n_pages, pool)

    return prefill, decode
