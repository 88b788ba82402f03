"""Decoder-only transformer LM: the dense, MoE and vlm families, GQA or MLA
attention.
Reference: ``src/repro/models/transformer.py`` (``segments``,
``layer_windows_np``, ``block_init`` / ``block_apply``, ``_remat_wrap``
(``none``, ``full`` and ``dots``: ``dots_with_no_batch_dims_saveable``),
``CHUNKED_ATTN_THRESHOLD`` and ``TransformerLM``'s ``init``,
``_embed_inputs``, ``forward``, ``per_token_loss``, ``init_cache``,
``decode_step``, ``_decode_block``, ``prefill`` and ``_output_weights``).

Decode over contiguous per-layer caches (``init_cache`` /
``decode_step``, the toy serve path's; the engine's paged path is
``serve.paged_model``): ``cache["lens"]`` is a host int, the position of
the next token, and ``decode_step`` writes each layer's K/V into the
cache tensors in place under ``torch.inference_mode``. A window layer's
cache holds ``min(max_len, window)`` positions as a ring buffer written at
``lens % size``; RoPE still takes the true position.

Tensor parallelism (the spmd engine's ``'model'`` axis): ``block_apply``,
``forward`` and ``per_token_loss`` carry the reference's hooks
(``distributed.tp.col_in`` / ``row_out``), identity unless the engine has
made a ``tp.TPContext`` current. Under one the model is a rank's slice
(``models.convert.shard_model``): its config holds the local head counts
and hidden width, its embedding the local vocabulary rows, and the tied
head reads them transposed, so the logits are the local vocabulary
columns.

The reference scans stacked ``seg_dense`` / ``seg_moe`` leaves
``[L, ...]``, one scan a segment; here the layers are one
``nn.ModuleList`` of per-layer ``nn.ModuleDict``s with the same keys
(``ln1``, ``attn``, ``ln2``, and ``mlp`` on a dense layer or ``moe`` on an
MoE one), ``layers.<i>`` being the model's layer ``i`` whatever its
segment (``kinds[i]`` names it). The weights are trainable parameters;
the serve path runs under ``torch.inference_mode``.

MoE (``models.moe``): an MoE layer's FFN routes the block's ``[B * S, d]``
rows through ``moe.moe_apply`` under ``cfg.moe.capacity_factor``, with no
tensor-parallel hooks around it (as in the reference), and its aux loss
is summed over the layers into ``per_token_loss``'s second output. Under
a TP context it runs whole on every rank, on the residual stream that
``row_out``'s all-reduce left the same on each.

MLA (``cfg.attention_kind == "mla"``, deepseek-v2): ``attention.
mla_attend`` over the sequence, and in decode ``attention.mla_decode``
over a latent cache (``c_kv``, ``k_rope``; bf16 when ``int8`` is asked
for, as in the reference), with no ring buffer. ``sharding.tp_plan``
leaves MLA attention unsharded.

The vlm family (internvl2): ``forward``, ``per_token_loss``
(``batch["prefix_embeds"]``) and ``prefill`` take ``prefix_embeds`` [B,
P, d], cast to the model dtype and put ahead of the token embeddings
(``embed_scale`` scales the tokens only); positions run over prefix and
text, and the loss is 0 over the prefix. Under TP only the token ids go
through the vocab-sharded lookup: the prefix is replicated.

Remat (``run_remat``): 'full' runs each layer through
``common.Remat``, an ``autograd.Function`` that ``torch.func`` goes
through (the spmd engine's batched worker gradients vmap the worker
loss). 'dots' is a selective ``torch.utils.checkpoint`` keeping the
matmuls' outputs; that cannot run under ``torch.func``, so there (the
batched gradients) 'dots' recomputes the whole layer as 'full' does: the
same gradients, the recompute of 'full'.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed import tp
from repro_torch.models import attention, common, mlp, moe

# padded_vocab * seq above this: cross entropy chunked over tokens (the
# reference's switch in ``per_token_loss``)
CHUNKED_CE_THRESHOLD = 32_000_000
# GQA over more tokens than this: the blocked online-softmax core
# (``attention.gqa_attend_chunked``) in place of the dense [S, S] scores
CHUNKED_ATTN_THRESHOLD = 8192


def segments(cfg) -> List[Tuple[str, int, int]]:
    """[(kind, count, first_layer_index)] — homogeneous layer groups: an
    MoE model's leading ``first_dense`` dense layers, then its MoE ones."""
    if cfg.moe.enabled:
        fd = cfg.moe.first_dense
        out = []
        if fd > 0:
            out.append(("dense", fd, 0))
        out.append(("moe", cfg.num_layers - fd, fd))
        return out
    return [("dense", cfg.num_layers, 0)]


def layer_kinds(cfg) -> List[str]:
    """Each layer's segment kind, in layer order."""
    return [kind for kind, count, _ in segments(cfg) for _ in range(count)]


def layer_windows_np(cfg) -> np.ndarray:
    """Per-layer sliding window (0 = global), host-side config math."""
    idx = np.arange(cfg.num_layers)
    if cfg.sliding_window <= 0:
        return np.zeros((cfg.num_layers,), np.int32)
    if cfg.global_every > 0:
        is_global = (idx + 1) % cfg.global_every == 0
        return np.where(is_global, 0, cfg.sliding_window).astype(np.int32)
    return np.full((cfg.num_layers,), cfg.sliding_window, np.int32)


def block_init(gen, cfg, kind: str, dtype, device=None) -> nn.ModuleDict:
    if kind not in ("dense", "moe") or \
            cfg.attention_kind not in ("gqa", "mla"):
        raise ValueError(f"{kind}/{cfg.attention_kind} is not a "
                         f"transformer block (dense or moe, gqa or mla)")
    attn_init = (attention.mla_init if cfg.attention_kind == "mla"
                 else attention.gqa_init)
    p = {
        "ln1": common.rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn_init(gen, cfg, dtype, device),
        "ln2": common.rmsnorm_init(cfg.d_model, dtype, device),
    }
    if kind == "moe":
        p["moe"] = moe.moe_init(gen, cfg, dtype, device)
    else:
        d_ff = (cfg.moe.dense_d_ff if (cfg.moe.enabled and cfg.moe.dense_d_ff)
                else cfg.d_ff)
        p["mlp"] = mlp.mlp_init(gen, cfg.d_model, d_ff, cfg.hidden_act,
                                dtype, device, bias=cfg.use_bias)
    return nn.ModuleDict(p)


def block_ffn(p, cfg, kind: str, h: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's FFN on the post-norm ``h`` [B, S, d]: (out, aux). An
    MoE layer routes the ``B * S`` rows together (aux: its router loss);
    a dense one is the MLP between the TP hooks (aux None)."""
    if kind == "moe":
        b, s, d = h.shape
        out, aux = moe.moe_apply(p["moe"], cfg, h.reshape(b * s, d),
                                 cfg.moe.capacity_factor)
        return out.reshape(b, s, d), aux
    h = tp.col_in(h, "ffn")
    return tp.row_out(mlp.mlp_apply(p["mlp"], h, cfg.hidden_act), "ffn"), None


def block_apply(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                window: int, kind: str = "dense"):
    """One pre-norm block over the full sequence: dense attention, or the
    blocked core above ``CHUNKED_ATTN_THRESHOLD`` tokens (GQA). Under
    a ``tp.TPContext`` the qkv and up/gate projections take head- and
    hidden-sharded weights (an all-reduce of the input's gradient) and
    ``wo`` / ``w_down`` give partial sums, all-reduced forward. Returns
    the new ``x``, and for ``kind`` 'moe' the pair ``(x, aux)``."""
    h = tp.col_in(common.rmsnorm(p["ln1"], x, cfg.norm_eps), "attn")
    if cfg.attention_kind == "mla":
        attn_out = attention.mla_attend(p["attn"], cfg, h, positions)
    elif x.shape[1] > CHUNKED_ATTN_THRESHOLD:
        attn_out = attention.gqa_attend_chunked(p["attn"], cfg, h, positions,
                                                window=window)
    else:
        attn_out = attention.gqa_attend(p["attn"], cfg, h, positions,
                                        window=window)
    x = x + tp.row_out(attn_out, "attn")
    out, aux = block_ffn(p, cfg, kind,
                         common.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + out if aux is None else (x + out, aux)


# matmuls without batch dimensions: what JAX's
# dots_with_no_batch_dims_saveable keeps (bmm / einsum carry batch dims)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dots_contexts():
    """``checkpoint``'s ``context_fn`` for remat 'dots': the first pass
    keeps the outputs of ``aten.mm`` / ``aten.addmm``, the recompute in
    backward reads them back and recomputes everything else."""
    return create_selective_checkpoint_contexts(_save_dots)


def run_remat(policy: str, fn, params, x: torch.Tensor,
              dots_context_fn=dots_contexts, extra=()):
    """``fn(params, x, *extra)`` under the reference's remat policy while
    autograd records: 'none' as it is; 'full' through ``common.Remat``
    (recomputed in backward); 'dots' through a selective ``checkpoint``
    whose ``dots_context_fn`` keeps the matmuls' outputs, or, under
    ``torch.func`` transforms, as 'full'. ``extra``: more tensor inputs
    (an encoder's output), differentiated like ``x``. The layers draw no
    random numbers, so no RNG state is saved (which a CUDA-graph capture
    would refuse)."""
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r} (none, full, "
                         f"dots)")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(params, x, *extra)
    if policy == "dots" and not torch._C._are_functorch_transforms_active():
        return checkpoint(fn, params, x, *extra, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=dots_context_fn)
    return common.remat_module(fn, params, x, *extra)


def _positions(x: torch.Tensor) -> torch.Tensor:
    """[B, S] token positions of ``x`` [B, S, d], made inside the layer
    (``common.Remat``'s closures may hold no tensor made under a
    ``torch.func`` transform)."""
    return torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])


class TransformerLM(nn.Module):
    """Decoder LM: dense, MoE or vlm. ``device=None`` means the card
    (``cuda``); pass ``device="cpu"`` to run on the CPU. ``generator``
    must live on that device; ``None`` seeds a fresh one with 0."""

    def __init__(self, cfg, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                f"family {cfg.family!r} is not a transformer family (dense, "
                f"moe, vlm); models.get_model builds the others")
        self.cfg = cfg
        self.dtype = common.dtype_of(cfg.dtype)
        self.device = common.resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    # -- init ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> "TransformerLM":
        """(Re)draw every parameter from ``gen`` with the reference's
        init scheme (truncated normals, unit norms)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        self.embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev)
        self.final_norm = common.rmsnorm_init(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            self.lm_head = common.dense_init(gen, cfg.d_model,
                                             cfg.padded_vocab, dt, dev)
        self.kinds = layer_kinds(cfg)
        self.layers = nn.ModuleList(block_init(gen, cfg, kind, dt, dev)
                                    for kind in self.kinds)
        self.windows = [int(w) for w in layer_windows_np(cfg)]
        return self

    # -- forward (train / prefill) --------------------------------------------

    def _embed_inputs(self, tokens: torch.Tensor,
                      prefix_embeds: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """The token embeddings [B, S, d] (scaled by ``embed_scale``),
        after ``prefix_embeds`` [B, P, d] when given: [B, P + S, d]."""
        x = common.embed(self.embed, tokens).to(self.dtype)
        if self.cfg.embed_scale != 1.0:
            x = x * self.cfg.embed_scale
        if prefix_embeds is not None:
            prefix = torch.as_tensor(prefix_embeds, device=x.device)
            x = torch.cat([prefix.to(self.dtype), x], dim=1)
        return x

    def _run_layers(self, x: torch.Tensor, remat: str = "none"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``remat``: the policy (``run_remat``) applied to each layer.
        Returns (x, the MoE layers' aux loss summed, 0-d f32)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p, win, kind in zip(self.layers, self.windows, self.kinds):
            out = run_remat(remat, lambda p_, x_, w=win, k=kind: block_apply(
                p_, cfg, x_, _positions(x_), w, k), p, x)
            if kind == "moe":
                x, a = out
                aux = aux + a
            else:
                x = out
        return x, aux

    def _output_weights(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed["embedding"].T
        return self.lm_head["w"]

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: [B, S] (after an optional ``prefix_embeds`` [B, P, d]) ->
        logits [B, P + S, V_padded] (the local vocabulary columns under a
        TP context)."""
        x, _ = self._run_layers(self._embed_inputs(tokens, prefix_embeds))
        x = common.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return tp.col_in(x, "vocab") @ self._output_weights()

    # -- loss ----------------------------------------------------------------

    def per_token_loss(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: tokens [B, S], labels [B, S] (-1 = masked), optional
        prefix_embeds [B, P, d] -> (per-token loss [B, P + S] f32, 0 over
        the prefix; aux loss 0-d f32: the MoE layers' router losses
        summed, 0 without MoE layers).

        Big logits (``padded_vocab * S > CHUNKED_CE_THRESHOLD``) go
        through ``chunked_cross_entropy``."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        prefix = batch.get("prefix_embeds")
        x, aux = self._run_layers(self._embed_inputs(tokens, prefix),
                                  remat=cfg.remat)
        x = common.rmsnorm(self.final_norm, x, cfg.norm_eps)
        if prefix is not None:
            pad = torch.full((labels.shape[0], x.shape[1] - labels.shape[1]),
                             -1, dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        x = tp.col_in(x, "vocab")               # TP head: local logits
        b, s, d = x.shape
        out_w = self._output_weights()
        safe_labels = torch.clamp_min(labels, 0)
        if cfg.padded_vocab * s > CHUNKED_CE_THRESHOLD:
            loss = common.chunked_cross_entropy(
                x.reshape(b * s, d), out_w, safe_labels.reshape(b * s),
                cfg.vocab_size).reshape(b, s)
        else:
            loss = common.softmax_cross_entropy(x @ out_w, safe_labels,
                                                cfg.vocab_size)
        loss = torch.where(labels >= 0, loss, torch.zeros_like(loss))
        return loss, aux

    # -- decode (per-layer contiguous caches) --------------------------------

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """``dtype=torch.int8`` selects quantized GQA caches (int8 payload,
        f16 per-(position, head) scales); MLA's latent caches are then
        bf16, whatever the model dtype (the latent is already the
        compression). ``lens`` is a host int; the layers' caches are
        listed per segment (``seg_dense``, ``seg_moe``), as in the
        reference."""
        dtype = dtype or self.dtype
        mla = self.cfg.attention_kind == "mla"
        mla_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
        cache = {"lens": 0}
        for kind, count, first in segments(self.cfg):
            layers = []
            for w in self.windows[first:first + count]:
                s = min(max_len, w) if w > 0 else max_len
                layers.append(
                    attention.mla_init_cache(self.cfg, batch, s, mla_dtype,
                                             self.device) if mla else
                    attention.gqa_init_cache(self.cfg, batch, s, dtype,
                                             self.device))
            cache[f"seg_{kind}"] = layers
        return cache

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, cache: dict):
        """token: [B, 1] -> (logits [B, V_padded], cache): the cache
        updated in place and ``lens`` advanced by one."""
        cfg = self.cfg
        cache_len = int(cache["lens"])
        x = self._embed_inputs(token.to(self.device).long())
        layer_caches = [c for kind, _, _ in segments(cfg)
                        for c in cache[f"seg_{kind}"]]
        for p, win, kind, layer_cache in zip(self.layers, self.windows,
                                             self.kinds, layer_caches):
            x = self._decode_block(p, x, layer_cache, cache_len, win, kind)
        x = common.rmsnorm(self.final_norm, x, cfg.norm_eps)
        logits = (x @ self._output_weights())[:, 0]
        cache["lens"] = cache_len + 1
        return logits, cache

    def _decode_block(self, p, x: torch.Tensor, layer_cache: dict,
                      cache_len: int, window: int,
                      kind: str = "dense") -> torch.Tensor:
        cfg = self.cfg
        h = common.rmsnorm(p["ln1"], x, cfg.norm_eps)
        if cfg.attention_kind == "mla":   # no ring buffer (the reference's)
            attn_out, _ = attention.mla_decode(p["attn"], cfg, h,
                                               layer_cache, cache_len)
        else:
            size = layer_cache["k"].shape[1]
            # a ring buffer holds exactly the last `size` tokens: written
            # at cache_len % size, every slot valid once wrapped
            is_ring = window > 0 and size <= window
            attn_out, _ = attention.gqa_decode(
                p["attn"], cfg, h, layer_cache, cache_len,
                window=0 if is_ring else window,
                write_pos=cache_len % size if is_ring else None)
        x = x + attn_out
        h = common.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if kind == "moe":
            return x + block_ffn(p, cfg, kind, h)[0]
        return x + mlp.mlp_apply(p["mlp"], h, cfg.hidden_act)

    def prefill(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Run the stack over ``prefix_embeds`` (optional) and ``tokens``,
        return only the last position's logits [B, V]."""
        x, _ = self._run_layers(self._embed_inputs(tokens, prefix_embeds))
        x = common.rmsnorm(self.final_norm, x[:, -1:], self.cfg.norm_eps)
        return (x @ self._output_weights())[:, 0]


def make(cfg, *, device=None, generator=None) -> TransformerLM:
    return TransformerLM(cfg, device=device, generator=generator)
