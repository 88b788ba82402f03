"""Analytic FLOP / HBM-byte accounting per (arch x shape) cell.
Reference: ``src/repro/analysis/perfmodel.py`` (``_avg_kv``, the per-token
counts, ``cell_flops``, ``_cache_total_bytes``, ``cell_bytes``), here over
the port's configs and ``repro_torch.models.registry.param_count``.

Plain host arithmetic: every field equals the reference's bit for bit, so
each expression keeps the reference's order of operations. The one change
is that parameter counts are memoized per config (the port counts on a
model built on the ``meta`` device, ~0.1 s a call). No chip constant lives
here: the roofline (``repro_torch.benchmarks.roofline``) holds the card's.

Conventions (the reference's):
  * flops are global (all chips) per step; matmul = 2*M*N*K
  * causal attention scores use the exact average effective KV length
  * train multiplier: fwd + 2x bwd (+1x fwd recompute when remat='full')
  * HBM bytes are global per step; parameter traffic counts every
    data-parallel replica's shard reads (chips/model_shard copies)
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.models import registry


@functools.lru_cache(maxsize=256)
def _param_count(cfg, active_only: bool = False) -> int:
    return registry.param_count(cfg, active_only=active_only)


def _avg_kv(seq: int, window: int) -> float:
    """Mean number of attended KV positions per query (causal)."""
    if window <= 0 or window >= seq:
        return (seq + 1) / 2.0
    head = window * (window + 1) / 2.0          # positions < window
    rest = (seq - window) * window
    return (head + rest) / seq


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellFlops:
    fwd_layers: float          # per-step fwd flops inside the layer stack
    fwd_other: float           # logits / CE
    train: float               # full train-step flops (incl. remat policy)
    fwd: float                 # fwd-only (prefill; last-position logits)
    decode: float              # one decode step
    model_flops_train: float   # 6*N_active*D — the "useful flops" yardstick
    model_flops_fwd: float


def _attn_flops_per_tok(cfg, s_kv: float) -> float:
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    d = cfg.d_model
    if cfg.attention_kind == "mla":
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        proj = (2 * d * (h * qk)
                + 2 * d * (m.kv_lora_rank + m.qk_rope_dim)
                + 2 * m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                + 2 * h * m.v_head_dim * d)
        attn = 2 * s_kv * h * qk + 2 * s_kv * h * m.v_head_dim
        return proj + attn
    proj = 2 * d * (h * hd) + 2 * 2 * d * (kv * hd) + 2 * (h * hd) * d
    attn = 2 * s_kv * h * hd * 2               # QK^T and PV
    return proj + attn


def _mlp_flops_per_tok(d: int, f: int, act: str) -> float:
    mults = 3 if act == "swiglu" else 2
    return 2.0 * d * f * mults


def _ssd_flops_per_tok(cfg) -> float:
    d = cfg.d_model
    h, hd, n = cfg.num_heads, cfg.resolved_head_dim, cfg.ssm.state_dim
    proj = 2 * d * (h * hd) + 2 * 2 * d * (h * n) + 2 * d * h
    scan = 6.0 * h * n * hd                    # decay+outer+read on [N,P] state
    out = 2 * (h * hd) * d
    return proj + scan + out


def _rwkv_flops_per_tok(cfg) -> float:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    heads = d // hd
    time_mix = 5 * 2 * d * d + 2 * 2 * 64 * d      # wr/wk/wv/wg/wo + decay lora
    wkv = 6.0 * heads * hd * hd                    # state decay+outer+read
    channel = 2 * d * cfg.d_ff * 2 + 2 * d * d     # wk, wv, wr
    return time_mix + wkv + channel


def _layer_flops_per_tok(cfg, layer_idx: int, s_kv_full: float,
                         s_kv_win: float) -> float:
    d = cfg.d_model
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        is_win = cfg.sliding_window > 0 and not (
            cfg.global_every > 0 and (layer_idx + 1) % cfg.global_every == 0)
        total = _attn_flops_per_tok(cfg, s_kv_win if is_win else s_kv_full)
        if cfg.moe.enabled and layer_idx >= cfg.moe.first_dense:
            m = cfg.moe
            total += 2 * d * m.num_experts
            total += m.top_k * _mlp_flops_per_tok(d, m.expert_d_ff, "swiglu")
            if m.num_shared_experts:
                total += _mlp_flops_per_tok(d, m.shared_d_ff, "swiglu")
        else:
            f = cfg.moe.dense_d_ff if (cfg.moe.enabled and cfg.moe.dense_d_ff) \
                else cfg.d_ff
            total += _mlp_flops_per_tok(d, f, cfg.hidden_act)
        return total
    if fam == "hybrid":
        return (_attn_flops_per_tok(cfg, s_kv_win) + _ssd_flops_per_tok(cfg)
                + _mlp_flops_per_tok(d, cfg.d_ff, cfg.hidden_act))
    if fam == "ssm":
        return _rwkv_flops_per_tok(cfg)
    raise ValueError(fam)


def cell_flops(cfg, shape, remat: str = "full") -> CellFlops:
    s, b = shape.seq_len, shape.global_batch
    t = b * s
    v = cfg.padded_vocab
    d = cfg.d_model
    s_full = _avg_kv(s, 0)
    s_win = _avg_kv(s, cfg.sliding_window)

    if cfg.family == "audio":
        t_enc = b * cfg.encoder_seq_len
        per_enc = (_attn_flops_per_tok(cfg, cfg.encoder_seq_len)     # bidir
                   + _mlp_flops_per_tok(d, cfg.d_ff, cfg.hidden_act))
        per_dec = (_attn_flops_per_tok(cfg, s_full)
                   + _attn_flops_per_tok(cfg, cfg.encoder_seq_len)   # cross
                   + _mlp_flops_per_tok(d, cfg.d_ff, cfg.hidden_act))
        fwd_layers = (t_enc * per_enc * cfg.num_encoder_layers
                      + t * per_dec * cfg.num_layers)
    else:
        fwd_layers = sum(t * _layer_flops_per_tok(cfg, i, s_full, s_win)
                         for i in range(cfg.num_layers))

    fwd_other = 2.0 * t * d * v                # training logits
    remat_extra = 1.0 if remat == "full" else 0.0
    train = (3.0 + remat_extra) * fwd_layers + 3.0 * fwd_other
    fwd = fwd_layers + 2.0 * b * d * v

    if cfg.family == "audio":
        per_dec = (_attn_flops_per_tok(cfg, float(s))
                   + _attn_flops_per_tok(cfg, cfg.encoder_seq_len)
                   + _mlp_flops_per_tok(d, cfg.d_ff, cfg.hidden_act))
        decode = b * per_dec * cfg.num_layers + 2.0 * b * d * v
    else:
        skv_full = float(s)
        skv_win = float(min(s, cfg.sliding_window)) if cfg.sliding_window > 0 \
            else float(s)
        decode = sum(b * _layer_flops_per_tok(cfg, i, skv_full, skv_win)
                     for i in range(cfg.num_layers)) + 2.0 * b * d * v

    n_active = _param_count(cfg, active_only=True)
    return CellFlops(fwd_layers=fwd_layers, fwd_other=fwd_other, train=train,
                     fwd=fwd, decode=decode,
                     model_flops_train=6.0 * n_active * t,
                     model_flops_fwd=2.0 * n_active * t)


# ---------------------------------------------------------------------------
# HBM traffic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CellBytes:
    train: float
    fwd: float
    decode: float
    cache_bytes: float          # resident KV/state cache (decode shapes)


def _cache_total_bytes(cfg, shape, dtype_bytes: int = 2) -> float:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        hd = cfg.rwkv_head_dim
        heads = cfg.d_model // hd
        return cfg.num_layers * b * (heads * hd * hd * 4 + 2 * cfg.d_model * 4)
    if cfg.family == "hybrid":
        w = min(s, cfg.sliding_window) if cfg.sliding_window > 0 else s
        attn = cfg.num_layers * b * w * 2 * cfg.num_kv_heads \
            * cfg.resolved_head_dim * dtype_bytes
        ssd = cfg.num_layers * b * cfg.num_heads * cfg.ssm.state_dim \
            * cfg.resolved_head_dim * 4
        return attn + ssd
    if cfg.attention_kind == "mla":
        m = cfg.mla
        return cfg.num_layers * b * s * (m.kv_lora_rank + m.qk_rope_dim) \
            * dtype_bytes
    per_layer_s = []
    for i in range(cfg.num_layers):
        is_win = cfg.sliding_window > 0 and not (
            cfg.global_every > 0 and (i + 1) % cfg.global_every == 0)
        per_layer_s.append(min(s, cfg.sliding_window) if is_win else s)
    kvb = sum(per_layer_s) * b * 2 * cfg.num_kv_heads \
        * cfg.resolved_head_dim * dtype_bytes
    if cfg.family == "audio":
        kvb += cfg.num_layers * b * cfg.encoder_seq_len * 2 * cfg.num_heads \
            * cfg.resolved_head_dim * dtype_bytes      # cross K/V
    return kvb


def cell_bytes(cfg, shape, *, chips: int, model_shard: int,
               param_bytes: int = 2, opt_slots: int = 2,
               zero1: bool = True, remat: str = "full") -> CellBytes:
    p = _param_count(cfg)
    dp = max(1, chips // model_shard)
    t = shape.global_batch * shape.seq_len
    d = cfg.d_model
    v = cfg.padded_vocab
    layers = cfg.num_layers + (cfg.num_encoder_layers
                               if cfg.family == "audio" else 0)

    # parameter passes: every DP replica reads its TP shard
    param_pass = p * param_bytes * dp
    param_reads_train = (2 + (1 if remat == "full" else 0)) * param_pass
    grad_rw = 2 * p * 4 * dp                        # write + optimizer read (f32)
    opt_factor = 1 if zero1 else dp                 # ZeRO-1 shards state over dp
    opt_rw = 2 * opt_slots * p * 4 * opt_factor     # read + write, f32 slots
    ema_rw = 2 * p * 4 * opt_factor
    param_write = param_pass

    # activations: ~8 residual-stream R/W per layer (pre-norm block: 2 norms,
    # attn in/out, mlp in/out, 2 residual adds), 2-byte activations, x2 for
    # the backward pass streams
    act = 8 * t * d * 2 * layers * 2
    # logits: produced + consumed fwd, recomputed in bwd (chunked CE)
    logits = 2 * t * v * 4 * 2

    train = (param_reads_train + grad_rw + opt_rw + ema_rw + param_write
             + act + logits)
    fwd = param_pass + 8 * t * d * 2 * layers
    cache = _cache_total_bytes(cfg, shape)
    decode = param_pass + cache * 1.02              # read cache + tiny write
    return CellBytes(train=train, fwd=fwd, decode=decode, cache_bytes=cache)
