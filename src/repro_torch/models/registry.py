"""Model registry: family -> model class, and parameter counts. Reference:
``src/repro/models/registry.py`` (``get_model``: the dense, moe, vlm,
hybrid, ssm and audio families; ``param_count``)."""
from __future__ import annotations

import math
import re
from typing import Optional

import torch


def get_model(cfg, *, device=None,
              generator: Optional[torch.Generator] = None):
    """Build and initialize the model for ``cfg`` on ``device`` (``None``
    means ``cuda``)."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer
        return transformer.make(cfg, device=device, generator=generator)
    if cfg.family == "hybrid":
        from repro_torch.models import hymba
        return hymba.make(cfg, device=device, generator=generator)
    if cfg.family == "ssm":
        from repro_torch.models import rwkv_lm
        return rwkv_lm.make(cfg, device=device, generator=generator)
    if cfg.family == "audio":
        from repro_torch.models import whisper
        return whisper.make(cfg, device=device, generator=generator)
    raise ValueError(f"unknown model family: {cfg.family}")


def param_count(cfg, active_only: bool = False) -> int:
    """The parameter count of ``cfg``'s model, built on the ``meta``
    device (no memory, any width). ``active_only``: less the routed
    experts a token does not visit (all but ``top_k`` of each MoE
    layer's, padded experts included), as in the reference."""
    model = get_model(cfg, device="meta", generator=torch.Generator())
    total = sum(p.numel() for p in model.parameters())
    if active_only and cfg.moe.enabled:
        for name, p in model.named_parameters():
            if re.search(r"\.moe\.(w_gate|w_up|w_down)\.w$", name):
                experts = p.shape[0]                # [E, d_in, d_out]
                total -= math.prod(p.shape) // experts * (
                    experts - cfg.moe.top_k)
    return total
