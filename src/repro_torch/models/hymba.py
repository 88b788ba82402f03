"""Hymba-style hybrid LM: parallel attention and SSM heads in every block,
the ``hybrid`` family.
Reference: ``src/repro/models/hymba.py`` (``block_init``, ``block_apply``
and ``HymbaLM``'s ``init``, ``forward``, ``per_token_loss``,
``init_cache``, ``decode_step`` and ``prefill``).

Each block computes, from the same pre-norm input,

    y = beta_a * attn(x) + beta_s * ssd(x)

(learnable f32 scalars a block, the mix in f32), then a SwiGLU FFN.
Attention is GQA with the config's sliding window in every layer
(``attention.gqa_attend``, or ``gqa_attend_chunked`` above
``transformer.CHUNKED_ATTN_THRESHOLD`` tokens); the SSM path is the
multi-head SSD mixer of ``models.mamba``.

Decode (``init_cache`` / ``decode_step``, the toy serve path's): each
layer keeps an O(window) attention ring buffer of ``min(max_len,
window)`` positions, written at ``lens % size`` (RoPE takes the true
position), and an O(1) f32 SSD state carried one token on by
``mamba.ssd_scan``. ``cache["lens"]`` is a host int; the caches are
updated in place under ``torch.inference_mode``.

The reference scans stacked ``blocks/<path>[L, ...]`` leaves; here
``blocks`` is an ``nn.ModuleList`` of per-layer ``common.ParamTree``
nodes with the same keys (``ln1``, ``attn``, ``ssd``, ``ssd_out``,
``beta_a``, ``beta_s``, ``ln2``, ``mlp``). Remat goes through
``transformer.run_remat``, as the transformer's layers do. The paged
serve engine and tensor parallelism do not take this family, as in the
reference (``serve.paged_model.supports_paged``,
``distributed.sharding.tp_plan``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention, common, mamba, mlp, transformer
from repro_torch.models.transformer import _positions, run_remat


def _ssd_dims(cfg):
    return cfg.num_heads, cfg.resolved_head_dim, cfg.ssm.state_dim


def block_init(gen, cfg, dtype, device=None) -> common.ParamTree:
    h, hd, n = _ssd_dims(cfg)
    return common.ParamTree({
        "ln1": common.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attention.gqa_init(gen, cfg, dtype, device),
        "ssd": mamba.ssd_init(gen, cfg.d_model, h, hd, n, dtype, device),
        "ssd_out": common.dense_init(gen, h * hd, cfg.d_model, dtype,
                                     device),
        "beta_a": torch.full((), 0.5, dtype=torch.float32, device=device),
        "beta_s": torch.full((), 0.5, dtype=torch.float32, device=device),
        "ln2": common.rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": mlp.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.hidden_act,
                            dtype, device),
    })


def _mix(p, attn_out: torch.Tensor, ssd_out: torch.Tensor,
         dtype) -> torch.Tensor:
    """``beta_a * attn + beta_s * ssd`` in f32, cast to ``dtype``."""
    return (p["beta_a"] * attn_out.float()
            + p["beta_s"] * ssd_out.float()).to(dtype)


def block_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                ssd_state=None, chunked: bool = True):
    """One hybrid block over x [B, S, d]: (x, the SSD's final state)."""
    h_, hd, n = _ssd_dims(cfg)
    hn = common.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attend = (attention.gqa_attend_chunked
              if x.shape[1] > transformer.CHUNKED_ATTN_THRESHOLD
              else attention.gqa_attend)
    attn_out = attend(p["attn"], cfg, hn, positions,
                      window=cfg.sliding_window)
    ssd_y, new_state = mamba.ssd_apply(p["ssd"], hn, h_, hd, n, ssd_state,
                                       chunked=chunked)
    b, s = x.shape[:2]
    ssd_out = common.dense(p["ssd_out"], ssd_y.reshape(b, s, h_ * hd))
    x = x + _mix(p, attn_out, ssd_out, x.dtype)
    hn = common.rmsnorm(p["ln2"], x, cfg.norm_eps)
    x = x + mlp.mlp_apply(p["mlp"], hn, cfg.hidden_act)
    return x, new_state


class HymbaLM(nn.Module):
    """``device=None`` means the card (``cuda``); pass ``device="cpu"`` to
    run on the CPU. ``generator`` must live on that device; ``None`` seeds
    a fresh one with 0."""

    def __init__(self, cfg, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"HymbaLM takes the hybrid family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = common.dtype_of(cfg.dtype)
        self.device = common.resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def init(self, gen: torch.Generator) -> "HymbaLM":
        """(Re)draw every parameter from ``gen`` with the reference's init
        scheme."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        self.embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev)
        self.blocks = nn.ModuleList(block_init(gen, cfg, dt, dev)
                                    for _ in range(cfg.num_layers))
        self.final_norm = common.rmsnorm_init(cfg.d_model, dt, dev)
        return self

    def _run_blocks(self, x: torch.Tensor, remat: str = "none"
                    ) -> torch.Tensor:
        cfg = self.cfg
        for p in self.blocks:
            x = run_remat(remat, lambda p_, x_: block_apply(
                p_, cfg, x_, _positions(x_))[0], p, x)
        return common.rmsnorm(self.final_norm, x, cfg.norm_eps)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: [B, S] -> logits [B, S, V_padded] (tied head)."""
        x = common.embed(self.embed, tokens).to(self.dtype)
        return self._run_blocks(x) @ self.embed["embedding"].T

    def per_token_loss(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: tokens [B, S], labels [B, S] (-1 = masked) -> (per-token
        loss [B, S] f32, aux loss 0-d f32 = 0). Each block under
        ``cfg.remat``."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x = common.embed(self.embed, tokens).to(self.dtype)
        x = self._run_blocks(x, remat=self.cfg.remat)
        logits = x @ self.embed["embedding"].T
        loss = common.softmax_cross_entropy(
            logits, torch.clamp_min(labels, 0), self.cfg.vocab_size)
        loss = torch.where(labels >= 0, loss, torch.zeros_like(loss))
        return loss, torch.zeros((), dtype=torch.float32, device=self.device)

    # -- decode: O(window) attention ring + O(1) SSD state a layer ----------

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """Each layer's attention cache of ``min(max_len, window)``
        positions (``dtype=torch.int8``: int8 payload and f16 scales) and
        its zero f32 SSD state."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        h, hd, n = _ssd_dims(cfg)
        w = (min(max_len, cfg.sliding_window) if cfg.sliding_window > 0
             else max_len)
        return {
            "lens": 0,
            "attn": [attention.gqa_init_cache(cfg, batch, w, dtype,
                                              self.device)
                     for _ in range(cfg.num_layers)],
            "ssd": [mamba.ssd_init_state(batch, h, hd, n, self.device)
                    for _ in range(cfg.num_layers)],
        }

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, cache: dict):
        """token: [B, 1] -> (logits [B, V_padded], cache), each layer's ring
        written in place, its SSD state carried on, ``lens`` advanced."""
        cfg = self.cfg
        h_, hd, n = _ssd_dims(cfg)
        cache_len = int(cache["lens"])
        x = common.embed(self.embed, token.to(self.device).long()).to(
            self.dtype)
        states = list(cache["ssd"])
        for i, p in enumerate(self.blocks):
            hn = common.rmsnorm(p["ln1"], x, cfg.norm_eps)
            layer_cache = cache["attn"][i]
            size = layer_cache["k"].shape[1]
            is_ring = cfg.sliding_window > 0 and size <= cfg.sliding_window
            attn_out, _ = attention.gqa_decode(
                p["attn"], cfg, hn, layer_cache, cache_len,
                window=0 if is_ring else cfg.sliding_window,
                write_pos=cache_len % size if is_ring else None)
            ssd_y, states[i] = mamba.ssd_apply(p["ssd"], hn, h_, hd, n,
                                               states[i], chunked=False)
            ssd_out = common.dense(p["ssd_out"],
                                   ssd_y.reshape(x.shape[0], 1, -1))
            x = x + _mix(p, attn_out, ssd_out, x.dtype)
            hn = common.rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + mlp.mlp_apply(p["mlp"], hn, cfg.hidden_act)
        x = common.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = (x @ self.embed["embedding"].T)[:, 0]
        cache["ssd"] = states
        cache["lens"] = cache_len + 1
        return logits, cache

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """The last position's logits [B, V] of ``forward``."""
        return self.forward(tokens)[:, -1]


def make(cfg, *, device=None, generator=None) -> HymbaLM:
    return HymbaLM(cfg, device=device, generator=generator)
