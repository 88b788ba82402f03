"""Model registry: family -> model class. Reference:
``src/repro/models/registry.py`` (``get_model``; the dense, moe and ssm
families)."""
from __future__ import annotations

from typing import Optional

import torch


def get_model(cfg, *, device=None,
              generator: Optional[torch.Generator] = None):
    """Build and initialize the model for ``cfg`` on ``device`` (``None``
    means ``cuda``)."""
    if cfg.family in ("dense", "moe"):
        from repro_torch.models import transformer
        return transformer.make(cfg, device=device, generator=generator)
    if cfg.family == "ssm":
        from repro_torch.models import rwkv_lm
        return rwkv_lm.make(cfg, device=device, generator=generator)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (the remaining model "
        f"families slice, ROADMAP Queue 1 item 9); repro_torch runs the "
        f"dense, moe and ssm (rwkv6) families")
