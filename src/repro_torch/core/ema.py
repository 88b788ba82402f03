"""Exponential moving average of parameters, kept in f32 (paper: eval on
the EMA, alpha = 0.9999). Reference: ``src/repro/core/ema.py``.

The EMA is a dict ``{name: f32 tensor}`` keyed like the parameters;
``update`` works in place (one f32 copy of the model is all it holds).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch


@torch.no_grad()
def init(named_params: Iterable[Tuple[str, torch.Tensor]]
         ) -> Dict[str, torch.Tensor]:
    return {k: p.detach().to(torch.float32, copy=True)
            for k, p in named_params}


@torch.no_grad()
def update(ema: Dict[str, torch.Tensor],
           named_params: Iterable[Tuple[str, torch.Tensor]],
           decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params (paper Alg. 2/4 last
    line). ``1 - decay`` is taken in f32, as the reference does."""
    d = np.float32(decay)
    one_minus = float(np.float32(1.0) - d)
    for k, p in named_params:
        ema[k].mul_(float(d)).add_(p.detach().float() * one_minus)
