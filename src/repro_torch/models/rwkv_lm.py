"""RWKV-6 language model: embed -> rwkv blocks -> head, the ``ssm`` family.
Reference: ``src/repro/models/rwkv_lm.py`` (``RWKVLM``'s ``init``,
``_fresh_states``, ``forward``, ``per_token_loss``, ``init_cache``,
``decode_step`` and ``prefill``).

Decode carries an O(1) state per layer (``init_cache``: the token-shift
vectors and the f32 ``[B, H, D, D]`` wkv state); ``decode_step`` runs each
block with ``chunked=False``, so one token with its carried state goes
through ``rwkv6.wkv_scan`` in plain PyTorch, as the reference's ``jnp``
scan does (the wkv kernels start from a zero state). ``prefill`` is
``forward(tokens)[:, -1]``: on the card the wkv6 forward kernel from a
zero state. ``cache["lens"]`` is a host int.

The reference scans stacked ``blocks/<path>[L, ...]`` leaves; here
``blocks`` is an ``nn.ModuleList`` of per-layer blocks with the same keys
(``ln1``, ``att``, ``ln2``, ``ffn``). Each block sees a fresh zero state.
Every layer's wkv runs through the hand-written kernels on the card
(``use_kernel=True``, the default) or their plain twin
(``use_kernel=False``, and always on the CPU). Remat goes through
``transformer.run_remat``: ``full`` is ``common.Remat``, whose first pass
runs without grad mode, so the wkv writes no chunk states there
(``rwkv6_scan.wants_states``); the recompute in backward writes them.
``dots`` (a selective checkpoint, outside ``torch.func``) keeps the
outputs of the block's matmuls without batch dimensions and recomputes
the rest, the wkv included; its first pass runs under
``rwkv6_scan.states_discarded``.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import rwkv6_scan
from repro_torch.models import common, rwkv6
from repro_torch.models.transformer import dots_contexts, run_remat

@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def dots_remat_contexts():
    """``context_fn`` for remat 'dots': ``dots_contexts`` with the first
    pass also under ``states_discarded``."""
    keep, recompute = dots_contexts()
    return _both(rwkv6_scan.states_discarded(), keep), recompute


class RWKVLM(nn.Module):
    """``device=None`` means the card (``cuda``); pass ``device="cpu"`` to
    run on the CPU. ``generator`` must live on that device; ``None`` seeds
    a fresh one with 0. ``use_kernel=False`` runs the wkv's plain twin on
    the card too."""

    def __init__(self, cfg, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 use_kernel: bool = True):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"RWKVLM takes the ssm family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.dtype = common.dtype_of(cfg.dtype)
        self.device = common.resolve_device(device)
        self.use_kernel = use_kernel
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.init(generator)

    def init(self, gen: torch.Generator) -> "RWKVLM":
        """(Re)draw every parameter from ``gen`` with the reference's init
        scheme."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        self.embed = common.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       dt, dev)
        self.ln_in = common.layernorm_init(cfg.d_model, dt, dev)
        self.blocks = nn.ModuleList(
            rwkv6.rwkv_block_init(gen, cfg, dt, dev)
            for _ in range(cfg.num_layers))
        self.ln_out = common.layernorm_init(cfg.d_model, dt, dev)
        self.head = common.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                      dt, dev)
        return self

    def _fresh_states(self, batch: int):
        """The zero block state; ``att_s`` None is the zero wkv state the
        kernels start from."""
        zeros = torch.zeros((batch, self.cfg.d_model), dtype=self.dtype,
                            device=self.device)
        return {"att_x": zeros, "att_s": None, "ffn_x": zeros}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: [B, S] -> logits [B, S, V_padded]. Under remat ``full``
        or ``dots`` (with autograd on) each block recomputes in backward."""
        cfg, use_kernel = self.cfg, self.use_kernel
        x = common.embed(self.embed, tokens).to(self.dtype)
        x = common.layernorm(self.ln_in, x, 1e-5)

        def block(p, x_):
            # the zero state is made inside the block: common.Remat's
            # closures may hold no tensor made under a torch.func transform
            return rwkv6.rwkv_block_apply(p, cfg, x_,
                                          self._fresh_states(x_.shape[0]),
                                          chunked=True,
                                          use_kernel=use_kernel)[0]

        for p in self.blocks:
            x = run_remat(cfg.remat, block, p, x, dots_remat_contexts)
        x = common.layernorm(self.ln_out, x, 1e-5)
        return common.dense(self.head, x)

    def per_token_loss(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """batch: tokens [B, S], labels [B, S] (-1 = masked) -> (per-token
        loss [B, S] f32 over the full logits, aux loss 0-d f32 = 0)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        logits = self.forward(tokens)
        loss = common.softmax_cross_entropy(
            logits, torch.clamp_min(labels, 0), self.cfg.vocab_size)
        loss = torch.where(labels >= 0, loss, torch.zeros_like(loss))
        return loss, torch.zeros((), dtype=torch.float32, device=self.device)

    # -- decode: O(1) recurrent state -----------------------------------------

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """One zero block state a layer; ``max_len`` is irrelevant to a
        recurrent cache (O(1) in S)."""
        del max_len
        return {"lens": 0,
                "state": [rwkv6.rwkv_init_block_state(
                    self.cfg, batch, dtype or self.dtype, self.device)
                    for _ in range(self.cfg.num_layers)]}

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, cache: dict):
        """token: [B, 1] -> (logits [B, V_padded], cache) with each layer's
        state carried one token on (``chunked=False``: the plain scan)."""
        cfg = self.cfg
        states = list(cache["state"])
        x = common.embed(self.embed, token.to(self.device).long()).to(
            self.dtype)
        x = common.layernorm(self.ln_in, x, 1e-5)
        for i, p in enumerate(self.blocks):
            x, states[i] = rwkv6.rwkv_block_apply(p, cfg, x, states[i],
                                                  chunked=False)
        x = common.layernorm(self.ln_out, x, 1e-5)
        logits = common.dense(self.head, x)[:, 0]
        cache["state"] = states
        cache["lens"] = int(cache["lens"]) + 1
        return logits, cache

    def prefill(self, tokens: torch.Tensor) -> torch.Tensor:
        """The last position's logits [B, V] of ``forward``."""
        return self.forward(tokens)[:, -1]


def make(cfg, *, device=None, generator=None) -> RWKVLM:
    return RWKVLM(cfg, device=device, generator=generator)
