"""Whisper-style encoder-decoder backbone, the ``audio`` family (the audio
frontend is a stub, as in the reference: the encoder takes precomputed
frame embeddings [B, T_enc, d], T_enc = ``cfg.encoder_seq_len``).
Reference: ``src/repro/models/whisper.py`` (``_enc_block_init``,
``_dec_block_init``, ``CHUNK_THRESHOLD``, ``_self_attend``,
``_cross_attend``, ``_cross_kv`` and ``WhisperModel``'s ``init``,
``encode``, ``decode_stack``, ``forward``, ``per_token_loss``,
``init_cache``, ``prime_cross_cache``, ``decode_step`` and ``prefill``).

A bidirectional encoder and a causal decoder with cross-attention:
pre-LN, GELU FFNs with biases, learned positions (``pos_enc``,
``pos_dec``; no RoPE), the decoder's output tied to its embedding.
Attention over more than ``CHUNK_THRESHOLD`` tokens runs the blocked
core (``attention.chunked_attention_core``).

Decode (the toy serve path's): each decoder layer's self-attention K/V
cache, written at ``lens`` in place, and its cross-attention K/V, computed
once from the encoder's output by ``prime_cross_cache``. ``lens`` is a
host int. An int8 cache request follows the reference to the bit: the new
K/V and the cross K/V are cast to int8 with no scales (the float value
truncated toward zero, saturating at the int8 range, as XLA converts),
and the self-attention's probabilities are cast to the cache's int8
before they weight V.

The reference scans stacked ``enc_blocks/<path>[L_enc, ...]`` and
``dec_blocks/<path>[L, ...]`` leaves; here each is an ``nn.ModuleList``
of per-layer ``nn.ModuleDict`` nodes with the same keys. The paged serve
engine and tensor parallelism do not take this family, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention, common, mlp
from repro_torch.models.transformer import run_remat

CHUNK_THRESHOLD = 8192
LN_EPS = 1e-5


def _enc_block_init(gen, cfg, dtype, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": common.layernorm_init(cfg.d_model, dtype, device),
        "attn": attention.gqa_init(gen, cfg, dtype, device),
        "ln2": common.layernorm_init(cfg.d_model, dtype, device),
        "mlp": mlp.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype,
                            device, bias=True),
    })


def _dec_block_init(gen, cfg, dtype, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": common.layernorm_init(cfg.d_model, dtype, device),
        "attn": attention.gqa_init(gen, cfg, dtype, device),
        "ln_x": common.layernorm_init(cfg.d_model, dtype, device),
        "xattn": attention.gqa_init(gen, cfg, dtype, device),
        "ln2": common.layernorm_init(cfg.d_model, dtype, device),
        "mlp": mlp.mlp_init(gen, cfg.d_model, cfg.d_ff, "gelu", dtype,
                            device, bias=True),
    })


def _to_int8(t: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int8 conversion: truncation toward zero, saturating
    at [-128, 127] (torch's cast wraps out-of-range values)."""
    return torch.clamp(t, -128, 127).to(torch.int8)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return _to_int8(t) if dtype == torch.int8 else t.to(dtype)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with the operands promoted as ``jnp.einsum`` promotes
    them (an int8 cache with float activations computes in the float
    type). Two int8 operands are multiplied in f32, exact at these
    magnitudes, and the result cast back to int8."""
    if a.dtype == b.dtype == torch.int8:
        return _to_int8(torch.einsum(eq, a.float(), b.float()))
    a, b = attention._promoted(a, b)
    return torch.einsum(eq, a, b)


def _dense(params, x: torch.Tensor) -> torch.Tensor:
    """``common.dense`` on an input of any dtype: int8 promotes to the
    weight's float type, as in the reference."""
    if not x.is_floating_point():
        x = x.to(params["w"].dtype)
    return common.dense(params, x)


def _self_attend(p, cfg, x: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """Non-rotary MHA over x [B, S, d] (learned absolute positions), the
    blocked core above ``CHUNK_THRESHOLD`` tokens."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = common.dense(p["wq"], x).reshape(b, s, h, hd)
    k = common.dense(p["wk"], x).reshape(b, s, kv, hd)
    v = common.dense(p["wv"], x).reshape(b, s, kv, hd)
    k = attention._expand_kv(k, cfg.q_per_kv)
    v = attention._expand_kv(v, cfg.q_per_kv)
    if s > CHUNK_THRESHOLD:
        out = attention.chunked_attention_core(q, k, v, causal=causal)
        return common.dense(p["wo"], out.reshape(b, s, -1))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(hd)
    if causal:
        mask = attention.make_attention_mask(s, s, device=x.device)
        scores = scores.masked_fill(~mask[None, None], attention.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)
    return common.dense(p["wo"], out)


def _cross_attend(p, cfg, x: torch.Tensor, enc_k: torch.Tensor,
                  enc_v: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] attending to the encoder's K / V [B, T, H, hd]
    (unmasked), the blocked core above ``CHUNK_THRESHOLD`` queries."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    q = common.dense(p["wq"], x).reshape(b, s, h, hd)
    if s > CHUNK_THRESHOLD:
        out = attention.chunked_attention_core(q, enc_k, enc_v, causal=False)
        return common.dense(p["wo"], out.reshape(b, s, -1))
    scores = _einsum("bqhd,bkhd->bhqk", q, enc_k).float() / math.sqrt(hd)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _einsum("bhqk,bkhd->bqhd", probs, enc_v).reshape(b, s, -1)
    return common.dense(p["wo"], out)


def _cross_kv(p, cfg, enc_out: torch.Tensor):
    """The encoder's output [B, T, d] -> cross K, V [B, T, H, hd]."""
    b, t, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = common.dense(p["wk"], enc_out).reshape(b, t, kv, hd)
    v = common.dense(p["wv"], enc_out).reshape(b, t, kv, hd)
    return (attention._expand_kv(k, cfg.q_per_kv),
            attention._expand_kv(v, cfg.q_per_kv))


def _enc_block(p, cfg, h: torch.Tensor) -> torch.Tensor:
    h = h + _self_attend(p["attn"], cfg, common.layernorm(p["ln1"], h, LN_EPS),
                         causal=False)
    return h + mlp.mlp_apply(p["mlp"], common.layernorm(p["ln2"], h, LN_EPS),
                             "gelu")


def _dec_block(p, cfg, h: torch.Tensor, enc_out: torch.Tensor
               ) -> torch.Tensor:
    h = h + _self_attend(p["attn"], cfg, common.layernorm(p["ln1"], h, LN_EPS),
                         causal=True)
    ek, ev = _cross_kv(p["xattn"], cfg, enc_out)
    h = h + _cross_attend(p["xattn"], cfg,
                          common.layernorm(p["ln_x"], h, LN_EPS), ek, ev)
    return h + mlp.mlp_apply(p["mlp"], common.layernorm(p["ln2"], h, LN_EPS),
                             "gelu")


class WhisperModel(nn.Module):
    """``device=None`` means the card (``cuda``); pass ``device="cpu"`` to
    run on the CPU. ``generator`` must live on that device; ``None`` seeds
    a fresh one with 0."""

    def __init__(self, cfg, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"WhisperModel takes the audio family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = common.dtype_of(cfg.dtype)
        self.device = common.resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def init(self, gen: torch.Generator) -> "WhisperModel":
        """(Re)draw every parameter from ``gen`` with the reference's init
        scheme."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        self.embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev)
        self.pos_dec = nn.Parameter(common.trunc_normal(
            gen, (cfg.max_seq_len, cfg.d_model), 0.01, dt, dev))
        self.pos_enc = nn.Parameter(common.trunc_normal(
            gen, (cfg.encoder_seq_len, cfg.d_model), 0.01, dt, dev))
        self.enc_blocks = nn.ModuleList(
            _enc_block_init(gen, cfg, dt, dev)
            for _ in range(cfg.num_encoder_layers))
        self.enc_ln = common.layernorm_init(cfg.d_model, dt, dev)
        self.dec_blocks = nn.ModuleList(
            _dec_block_init(gen, cfg, dt, dev)
            for _ in range(cfg.num_layers))
        self.dec_ln = common.layernorm_init(cfg.d_model, dt, dev)
        return self

    def encode(self, frames: torch.Tensor, remat: str = "none"
               ) -> torch.Tensor:
        """frames [B, T, d] -> the encoder's output [B, T, d]."""
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=self.device)
        x = frames.to(self.dtype) + self.pos_enc[None, :frames.shape[1]]
        for p in self.enc_blocks:
            x = run_remat(remat, lambda p_, h_: _enc_block(p_, cfg, h_), p, x)
        return common.layernorm(self.enc_ln, x, LN_EPS)

    def decode_stack(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                     remat: str = "none") -> torch.Tensor:
        """tokens [B, S] over ``enc_out`` -> logits [B, S, V_padded]."""
        cfg = self.cfg
        s = tokens.shape[1]
        x = common.embed(self.embed, tokens).to(self.dtype)
        x = x + self.pos_dec[None, :s]
        for p in self.dec_blocks:
            x = run_remat(remat, lambda p_, h_, e_: _dec_block(p_, cfg, h_, e_),
                          p, x, extra=(enc_out,))
        x = common.layernorm(self.dec_ln, x, LN_EPS)
        return x @ self.embed["embedding"].T

    def forward(self, tokens: torch.Tensor, encoder_frames=None,
                prefix_embeds=None) -> torch.Tensor:
        """tokens [B, S] and the frames (``encoder_frames``, else
        ``prefix_embeds``) [B, T, d] -> logits [B, S, V_padded]."""
        frames = encoder_frames if encoder_frames is not None \
            else prefix_embeds
        return self.decode_stack(tokens, self.encode(frames))

    def per_token_loss(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: tokens [B, S], labels [B, S] (-1 = masked) and
        encoder_frames [B, T, d] -> (per-token loss [B, S] f32, aux 0-d f32
        = 0). Each block under ``cfg.remat``."""
        remat = self.cfg.remat
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        logits = self.decode_stack(
            tokens, self.encode(batch["encoder_frames"], remat), remat)
        loss = common.softmax_cross_entropy(
            logits, torch.clamp_min(labels, 0), self.cfg.vocab_size)
        loss = torch.where(labels >= 0, loss, torch.zeros_like(loss))
        return loss, torch.zeros((), dtype=torch.float32, device=self.device)

    # -- decode: self caches + cross caches primed once -----------------------

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """Each decoder layer's self-attention cache of ``max_len``
        positions and zero cross K / V [B, T_enc, H, hd], all in ``dtype``
        (``torch.int8``: int8, the self caches with f16 scales that the
        reference allocates and its decode does not use)."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        shape = (batch, cfg.encoder_seq_len, cfg.num_heads,
                 cfg.resolved_head_dim)
        return {
            "lens": 0,
            "self": [attention.gqa_init_cache(cfg, batch, max_len, dtype,
                                              self.device)
                     for _ in range(cfg.num_layers)],
            "cross_k": [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(cfg.num_layers)],
            "cross_v": [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(cfg.num_layers)],
        }

    @torch.inference_mode()
    def prime_cross_cache(self, cache: dict, frames) -> dict:
        """Encode ``frames`` [B, T, d] and write each decoder layer's cross
        K / V, cast to the cache's dtype, into ``cache``; returns it."""
        enc_out = self.encode(frames)
        ck, cv = [], []
        for i, p in enumerate(self.dec_blocks):
            k, v = _cross_kv(p["xattn"], self.cfg, enc_out)
            ck.append(_cast(k, cache["cross_k"][i].dtype))
            cv.append(_cast(v, cache["cross_v"][i].dtype))
        cache["cross_k"], cache["cross_v"] = ck, cv
        return cache

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, cache: dict):
        """token: [B, 1] -> (logits [B, V_padded], cache): each layer's new
        K / V written at ``lens`` in place, ``lens`` advanced."""
        cfg = self.cfg
        cache_len = int(cache["lens"])
        b = token.shape[0]
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        x = common.embed(self.embed, token.to(self.device).long()).to(
            self.dtype)
        x = x + self.pos_dec[None, cache_len:cache_len + 1]
        for i, p in enumerate(self.dec_blocks):
            c = cache["self"][i]
            s = c["k"].shape[1]
            if not 0 <= cache_len < s:
                raise ValueError(f"write position {cache_len} is outside "
                                 f"the cache's {s} positions")
            hn = common.layernorm(p["ln1"], x, LN_EPS)
            # non-rotary: the projections of gqa_decode without RoPE
            q = common.dense(p["attn"]["wq"], hn).reshape(b, 1, h, hd)
            k_new = common.dense(p["attn"]["wk"], hn).reshape(b, kv, hd)
            v_new = common.dense(p["attn"]["wv"], hn).reshape(b, kv, hd)
            c["k"][:, cache_len] = _cast(k_new, c["k"].dtype)
            c["v"][:, cache_len] = _cast(v_new, c["v"].dtype)
            qg = q.reshape(b, kv, cfg.q_per_kv, hd)
            scores = _einsum("bgqd,bsgd->bgqs", qg, c["k"]).float() \
                / math.sqrt(hd)
            valid = torch.arange(s, device=x.device) <= cache_len
            scores = scores.masked_fill(~valid, attention.NEG_INF)
            probs = torch.softmax(scores, dim=-1)
            att = _einsum("bgqs,bsgd->bgqd", _cast(probs, c["v"].dtype),
                          c["v"])
            x = x + _dense(p["attn"]["wo"], att.reshape(b, 1, -1))
            # cross attention against the primed cache
            hn = common.layernorm(p["ln_x"], x, LN_EPS)
            x = x + _cross_attend(p["xattn"], cfg, hn, cache["cross_k"][i],
                                  cache["cross_v"][i])
            hn = common.layernorm(p["ln2"], x, LN_EPS)
            x = x + mlp.mlp_apply(p["mlp"], hn, "gelu")
        x = common.layernorm(self.dec_ln, x, LN_EPS)
        logits = (x @ self.embed["embedding"].T)[:, 0]
        cache["lens"] = cache_len + 1
        return logits, cache

    def prefill(self, tokens: torch.Tensor, encoder_frames=None,
                prefix_embeds=None) -> torch.Tensor:
        """The last position's logits [B, V] of ``forward``."""
        return self.forward(tokens, encoder_frames=encoder_frames,
                            prefix_embeds=prefix_embeds)[:, -1]


def make(cfg, *, device=None, generator=None) -> WhisperModel:
    return WhisperModel(cfg, device=device, generator=generator)
