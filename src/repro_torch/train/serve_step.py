"""Serving steps over contiguous caches: prefill, single-token decode, and
the greedy generation loop of the toy serve path.
Reference: ``src/repro/train/serve_step.py`` (``build_decode_step``,
``build_prefill``, ``bucketed_max_len``, ``greedy_generate``).

The models hold their weights, so the built steps take no ``params``.
``decode_input_specs`` / ``prefill_input_specs`` (``jax.ShapeDtypeStruct``s
for the reference's dry run) have no counterpart here: the port's dry run
(``launch/dryrun.py``) calls these steps on ``meta`` tensors.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch


def build_decode_step(model) -> Callable:
    def decode_step(token, cache):
        return model.decode_step(token, cache)
    return decode_step


def build_prefill(model) -> Callable:
    def prefill(batch):
        kwargs = {k: batch[k] for k in ("prefix_embeds", "encoder_frames")
                  if k in batch}
        return model.prefill(batch["tokens"], **kwargs)
    return prefill


def bucketed_max_len(need: int, floor: int = 8) -> int:
    """Round a cache length up to the next power-of-two bucket (the
    reference's rule: one cache shape a bucket, the extra positions inert
    under the validity mask)."""
    if need <= 0:
        raise ValueError(f"cache length must be positive (got {need})")
    b = floor
    while b < need:
        b *= 2
    return b


def greedy_generate(model, prompt: torch.Tensor, num_tokens: int,
                    max_len: int, *, bucket: bool = True, cache_dtype=None,
                    marks: Optional[List[float]] = None,
                    encoder_frames=None) -> torch.Tensor:
    """Greedy generation over the model's contiguous cache: prefill by
    stepping ``decode_step`` over the prompt's tokens one by one, then
    ``num_tokens`` greedy tokens. ``prompt``: [B, P] ids. Returns [B,
    num_tokens] in the prompt's dtype.

    ``max_len`` is rounded up to a power-of-two bucket (``bucket=False``
    keeps it exact). ``cache_dtype=torch.int8`` selects the quantized
    cache. ``encoder_frames`` [B, T, d] (an encoder-decoder model) primes
    the cross cache first (``prime_cross_cache``). ``marks``, when given,
    receives three ``time.perf_counter()`` reads: before the priming and
    the prompt, after them and after the decode, each after a
    ``torch.cuda.synchronize`` on the card."""
    b, plen = prompt.shape
    device = model.device

    def mark():
        if marks is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            marks.append(time.perf_counter())

    cache = model.init_cache(b, bucketed_max_len(max_len) if bucket
                             else max_len, cache_dtype)
    mark()
    if encoder_frames is not None:
        cache = model.prime_cross_cache(cache, encoder_frames)
    logits = None
    for i in range(plen):
        logits, cache = model.decode_step(prompt[:, i:i + 1], cache)
    mark()
    out = []
    tok = torch.argmax(logits, -1)[:, None].to(prompt.dtype)
    for _ in range(num_tokens):
        out.append(tok)
        logits, cache = model.decode_step(tok, cache)
        tok = torch.argmax(logits, -1)[:, None].to(prompt.dtype)
    mark()
    return torch.cat(out, dim=1)
