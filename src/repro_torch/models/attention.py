"""Attention token mixers: GQA and MLA, masks, dense attention, int8 KV
quantization, decode over contiguous caches.
Reference: ``src/repro/models/attention.py`` (``gqa_init``,
``_project_qkv``, ``_expand_kv``, ``_window_ok``, ``make_attention_mask``,
``gqa_attend``, ``_quantize_kv``, ``_dequantize_kv``, the decode path
``gqa_init_cache`` / ``gqa_decode``, and MLA: ``mla_init``, ``_mla_qkv``,
``_mla_expand_kv``, ``mla_attend``, ``mla_init_cache``, ``mla_decode``,
and the blocked online-softmax path: ``chunked_attention_core``,
``gqa_attend_chunked`` and ``mla_attend``'s branch above
``MLA_DENSE_MAX_LEN`` tokens; the qk-norm scales pass
``distributed.tp.shared_param`` as in the reference).
The blocked core is plain PyTorch, as the reference's is plain ``jnp``:
Python loops over query and key chunks in place of its ``lax.scan``,
the same online-softmax arithmetic in the same order. The reference's
``constrain_dims`` calls are sharding hints for its GSPMD mesh and have
no counterpart.

Windows are per-layer Python ints here (the reference feeds them through
``lax.scan`` as traced scalars); ``window <= 0`` means unlimited. The decode
path's positions (``cache_len``, ``write_pos``) are host ints too, and
``gqa_decode`` writes the new token's K/V into the cache tensors in place
(the reference returns a new cache).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tp
from repro_torch.models import common

NEG_INF = -1e30
# above this many tokens MLA runs the blocked online-softmax core (the
# dense path materializes the whole [S, S] score matrix)
MLA_DENSE_MAX_LEN = 8192


def gqa_init(gen, cfg, dtype=torch.float32, device=None) -> nn.ModuleDict:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": common.dense_init(gen, d, h * hd, dtype, device,
                                bias=cfg.use_bias),
        "wk": common.dense_init(gen, d, kv * hd, dtype, device,
                                bias=cfg.use_bias),
        "wv": common.dense_init(gen, d, kv * hd, dtype, device,
                                bias=cfg.use_bias),
        "wo": common.dense_init(gen, h * hd, d, dtype, device,
                                bias=cfg.use_bias,
                                std=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_init(hd, dtype, device)
        p["k_norm"] = common.rmsnorm_init(hd, dtype, device)
    return nn.ModuleDict(p)


def _project_qkv(params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: [B, S, d] -> q [B, S, H, hd], k/v [B, S, KV, hd]; qk-norm before
    RoPE, as in the reference."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = common.dense(params["wq"], x).reshape(b, s, h, hd)
    k = common.dense(params["wk"], x).reshape(b, s, kv, hd)
    v = common.dense(params["wv"], x).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        # the qk-norm scales are replicated but applied to head-sharded
        # q/k under TP: tp.shared_param assembles their whole gradient
        # from the ranks' parts
        q = common.rmsnorm(tp.shared_param(params["q_norm"], "attn"), q,
                           cfg.norm_eps)
        k = common.rmsnorm(tp.shared_param(params["k_norm"], "attn"), k,
                           cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def _window_ok(diff: torch.Tensor, window: int) -> torch.Tensor:
    """True where ``diff`` (q_pos - k_pos) is within the lookback window."""
    if window > 0:
        return diff < window
    return torch.ones_like(diff, dtype=torch.bool)


def make_attention_mask(s_q: int, s_kv: int, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        device=None) -> torch.Tensor:
    """[s_q, s_kv] boolean mask. window>0 limits lookback to `window` tokens."""
    qpos = torch.arange(s_q, device=device) + q_offset
    kpos = torch.arange(s_kv, device=device)
    diff = qpos[:, None] - kpos[None, :]
    mask = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
    return mask & _window_ok(diff, window)


def gqa_attend(params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
               window: int = 0) -> torch.Tensor:
    """Full-sequence dense attention. x: [B, S, d] -> [B, S, d]."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    k = _expand_kv(k, cfg.q_per_kv)
    v = _expand_kv(v, cfg.q_per_kv)
    hd = cfg.resolved_head_dim
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    scores = common.softcap(scores, cfg.attn_logit_softcap)
    mask = make_attention_mask(s, s, window=window, device=x.device)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return common.dense(params["wo"], out.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# Chunked (flash-style) path: loops over KV chunks with running softmax stats
# ---------------------------------------------------------------------------


def chunked_attention_core(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0,
                           q_chunk: int = 2048,
                           kv_chunk: int = 2048) -> torch.Tensor:
    """Blocked attention on projected q [B, S, H, D] and k / v [B, S_kv,
    H, D] (KV already head-expanded): O(q_chunk * kv_chunk) live scores
    instead of O(S * S_kv). Query chunks (outer) and KV chunks (inner)
    carry running (max, sum, weighted-V) accumulators in f32: the
    online-softmax recurrence. ``causal`` masks later keys and, with
    ``window`` > 0, keys ``window`` or more positions back; without it
    every key is visible. Padded keys past ``S_kv`` are masked. Returns
    [B, S, H, D] in q's dtype."""
    b, s, h, hd = q.shape
    s_kv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s_kv)
    nq = -(-s // q_chunk)
    nk = -(-s_kv // kv_chunk)
    q = common.pad_seq(q, nq * q_chunk - s)
    k = common.pad_seq(k, nk * kv_chunk - s_kv)
    v = common.pad_seq(v, nk * kv_chunk - s_kv)
    qs = q.reshape(b, nq, q_chunk, h, hd).permute(1, 0, 3, 2, 4)  # [nq,B,H,qc,D]
    ks = k.reshape(b, nk, kv_chunk, h, hd).permute(1, 0, 3, 2, 4)
    vs = v.reshape(b, nk, kv_chunk, h, hd).permute(1, 0, 3, 2, 4)
    ar_q = torch.arange(q_chunk, device=q.device)
    ar_k = torch.arange(kv_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        qc = qs[qi]
        qpos = qi * q_chunk + ar_q
        m = torch.full((b, h, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, h, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            kc, vc = ks[ki], vs[ki]
            scores = torch.einsum("bhqd,bhkd->bhqk", qc, kc).float() * scale
            scores = common.softcap(scores, softcap)
            kpos = ki * kv_chunk + ar_k
            diff = qpos[:, None] - kpos[None, :]
            if causal:
                mask = (diff >= 0) & _window_ok(diff, window)
            else:
                mask = torch.ones_like(diff, dtype=torch.bool)
            mask = mask & (kpos < s_kv)[None, :]            # kv padding
            scores = scores.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, torch.amax(scores, dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vc.dtype), vc).float()
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.to(qc.dtype))
    out = torch.stack(outs)                                 # [nq,B,H,qc,D]
    return out.permute(1, 0, 3, 2, 4).reshape(b, nq * q_chunk, h, hd)[:, :s]


def gqa_attend_chunked(params, cfg, x: torch.Tensor, positions: torch.Tensor,
                       *, window: int = 0, q_chunk: int = 2048,
                       kv_chunk: int = 2048) -> torch.Tensor:
    """``gqa_attend`` through ``chunked_attention_core``: the same
    projections, RoPE and softcap, causal with ``window``. x: [B, S, d]
    -> [B, S, d]."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    k = _expand_kv(k, cfg.q_per_kv)
    v = _expand_kv(v, cfg.q_per_kv)
    out = chunked_attention_core(q, k, v, causal=True, window=window,
                                 softcap=cfg.attn_logit_softcap,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    return common.dense(params["wo"], out.reshape(b, s, -1))


def _quantize_kv(x: torch.Tensor):
    """x: [..., kv, hd] -> (int8 payload, f16 per-(pos, head) scale).

    The payload is rounded against the f32 scale but the f16 cast of that
    scale is what is stored, and dequant multiplies by the f16 scale: the
    reference's order, kept so the int8 pool's bits match."""
    x32 = x.float()
    scale = torch.amax(torch.abs(x32), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(
        torch.int8)
    return q, scale.to(torch.float16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# Decode path (contiguous KV cache)
# ---------------------------------------------------------------------------


def gqa_init_cache(cfg, batch: int, max_len: int, dtype,
                   device=None) -> dict:
    """KV cache ``[B, max_len, kv, hd]``. ``dtype=torch.int8`` selects the
    quantized layout: int8 payload and per-(position, head) f16 scales."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_len, kv, hd)
    if dtype == torch.int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float16,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(params, cfg, x: torch.Tensor, cache: dict, cache_len: int,
               *, window: int = 0, write_pos=None,
               update_cache: bool = True):
    """One-token decode. x: [B, 1, d]; cache k/v: [B, S, kv, hd].

    ``cache_len`` is the true position of the new token (RoPE and
    validity: ``kpos <= cache_len`` and the window). ``write_pos`` is where
    its K/V lands, ``cache_len`` by default; ``cache_len % size`` for a
    ring-buffer (sliding-window) cache, which is all valid once wrapped.
    Returns (out [B, 1, d], cache), the cache updated in place."""
    b = x.shape[0]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if write_pos is None:
        write_pos = cache_len
    s = cache["k"].shape[1]
    if update_cache and not 0 <= write_pos < s:
        raise ValueError(f"write position {write_pos} is outside the "
                         f"cache's {s} positions")
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos)
    quantized = cache["k"].dtype == torch.int8
    if update_cache:
        if quantized:
            for name, t in (("k", k_new), ("v", v_new)):
                tq, tsc = _quantize_kv(t[:, 0])
                cache[name][:, write_pos] = tq
                cache[f"{name}_scale"][:, write_pos] = tsc
        else:
            cache["k"][:, write_pos] = k_new[:, 0].to(cache["k"].dtype)
            cache["v"][:, write_pos] = v_new[:, 0].to(cache["v"].dtype)
    if quantized:
        k = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        k, v = cache["k"], cache["v"]
    qg = q.reshape(b, kv, cfg.q_per_kv, hd)
    scores = torch.einsum("bgqd,bsgd->bgqs", qg, k).float() / math.sqrt(hd)
    scores = common.softcap(scores, cfg.attn_logit_softcap)
    kpos = torch.arange(s, device=x.device)
    valid = (kpos <= cache_len) & _window_ok(cache_len - kpos, window)
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgqs,bsgd->bgqd", probs.to(v.dtype), v)
    return common.dense(params["wo"], out.reshape(b, 1, h * hd)), cache


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg, dtype=torch.float32, device=None) -> nn.ModuleDict:
    """The full-rank query ``wq`` (or, with ``q_lora_rank > 0``, the
    low-rank ``wq_a`` -> ``q_norm`` -> ``wq_b``), the compressed KV latent
    and shared rope key ``wkv_a``, ``kv_norm``, the latent's expansion
    ``wkv_b`` to every head's (nope key, value), and ``wo``."""
    d, h = cfg.d_model, cfg.num_heads
    m = cfg.mla
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    p = {}
    if not m.q_lora_rank:
        p["wq"] = common.dense_init(gen, d, h * qk_dim, dtype, device)
    p["wkv_a"] = common.dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim,
                                   dtype, device)
    p["kv_norm"] = common.rmsnorm_init(m.kv_lora_rank, dtype, device)
    p["wkv_b"] = common.dense_init(gen, m.kv_lora_rank,
                                   h * (m.qk_nope_dim + m.v_head_dim),
                                   dtype, device)
    p["wo"] = common.dense_init(gen, h * m.v_head_dim, d, dtype, device,
                                std=1.0 / math.sqrt(h * m.v_head_dim))
    if m.q_lora_rank:
        p["wq_a"] = common.dense_init(gen, d, m.q_lora_rank, dtype, device)
        p["q_norm"] = common.rmsnorm_init(m.q_lora_rank, dtype, device)
        p["wq_b"] = common.dense_init(gen, m.q_lora_rank, h * qk_dim, dtype,
                                      device)
    return nn.ModuleDict(p)


def _mla_qkv(params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x: [B, S, d] -> q_nope [B, S, H, nope], q_rope [B, S, H, rope] (rope
    applied), the normed latent c_kv [B, S, rank] and the one rope key
    shared by every head, k_rope [B, S, 1, rope]."""
    b, s, _ = x.shape
    h = cfg.num_heads
    m = cfg.mla
    if "wq_a" in params:
        q = common.dense(params["wq_b"], common.rmsnorm(
            params["q_norm"], common.dense(params["wq_a"], x), cfg.norm_eps))
    else:
        q = common.dense(params["wq"], x)
    q = q.reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    kv_a = common.dense(params["wkv_a"], x)             # [B, S, rank + rope]
    c_kv, k_rope = torch.split(kv_a, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    c_kv = common.rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)
    k_rope = common.apply_rope(k_rope[:, :, None, :], positions,
                               cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(params, cfg, c_kv: torch.Tensor):
    """The latent [B, S, rank] -> every head's k_nope [B, S, H, nope] and
    v [B, S, H, v]."""
    b, s, _ = c_kv.shape
    m = cfg.mla
    kv = common.dense(params["wkv_b"], c_kv).reshape(
        b, s, cfg.num_heads, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_dim, m.v_head_dim], dim=-1)
    return k_nope, v


def mla_attend(params, cfg, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA, the latent expanded per head. x: [B, S, d]
    -> [B, S, d]. Above ``MLA_DENSE_MAX_LEN`` tokens the blocked core runs
    instead of the dense scores: nope and rope fold into one head dim of
    ``nope + rope`` (the rope key broadcast to every head), v is
    zero-padded to that width and the output sliced back (the core is
    square in D)."""
    b, s, _ = x.shape
    h = cfg.num_heads
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, cfg, x, positions)
    k_nope, v = _mla_expand_kv(params, cfg, c_kv)
    if s > MLA_DENSE_MAX_LEN:
        qk = torch.cat([q_nope, q_rope], dim=-1)        # [B, S, H, nope+rope]
        kk = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_dim)],
                       dim=-1)
        d_qk = m.qk_nope_dim + m.qk_rope_dim
        v_pad = F.pad(v, (0, d_qk - m.v_head_dim))
        out = chunked_attention_core(qk, kk, v_pad, causal=True)
        out = out[..., :m.v_head_dim]
        return common.dense(params["wo"], out.reshape(b, s, -1))
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkld->bhqk", q_rope, k_rope)
              ).float() * scale
    mask = make_attention_mask(s, s, device=x.device)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return common.dense(params["wo"], out.reshape(b, s, -1))


def mla_init_cache(cfg, batch: int, max_len: int, dtype,
                   device=None) -> dict:
    """The latent cache: ``c_kv`` [B, max_len, rank] and ``k_rope`` [B,
    max_len, rope], nothing per head."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                  dtype=dtype, device=device)}


def _promoted(*ts: torch.Tensor):
    """``ts`` cast to their promoted dtype: the reference's einsums mix a
    bf16 latent cache with an f32 model's activations and compute in f32."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def mla_decode(params, cfg, x: torch.Tensor, cache: dict, cache_len: int,
               update_cache: bool = True):
    """One-token MLA decode against the latent cache. x: [B, 1, d]. The
    new token's latent and rope key are written at ``cache_len`` in place;
    ``wkv_b`` is absorbed: the nope scores are ``(q_nope @ Wb_k) @ c_kv^T``
    and the output ``(probs @ c_kv) @ Wb_v``, so no key or value is
    expanded per head over the cache. Returns (out [B, 1, d], cache)."""
    b = x.shape[0]
    h = cfg.num_heads
    m = cfg.mla
    s = cache["c_kv"].shape[1]
    if update_cache and not 0 <= cache_len < s:
        raise ValueError(f"write position {cache_len} is outside the "
                         f"cache's {s} positions")
    pos = torch.full((b, 1), cache_len, dtype=torch.long, device=x.device)
    q_nope, q_rope, c_new, kr_new = _mla_qkv(params, cfg, x, pos)
    if update_cache:
        cache["c_kv"][:, cache_len] = c_new[:, 0].to(cache["c_kv"].dtype)
        cache["k_rope"][:, cache_len] = kr_new[:, 0, 0].to(
            cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    wkv_b = params["wkv_b"]["w"].reshape(m.kv_lora_rank, h,
                                         m.qk_nope_dim + m.v_head_dim)
    wb_k = wkv_b[..., :m.qk_nope_dim]                       # [rank, h, nope]
    wb_v = wkv_b[..., m.qk_nope_dim:]                       # [rank, h, v]
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, wb_k)    # [B, 1, h, rank]
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    scores = (torch.einsum("bqhr,bsr->bhqs", *_promoted(q_abs, c_kv))
              + torch.einsum("bqhd,bsd->bhqs", *_promoted(q_rope, k_rope))
              ).float() * scale
    valid = torch.arange(s, device=x.device) <= cache_len
    scores = scores.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", probs.to(c_kv.dtype), c_kv)
    out = torch.einsum("bqhr,rhd->bqhd", *_promoted(ctx, wb_v))
    return common.dense(params["wo"], out.reshape(b, 1, -1)), cache
