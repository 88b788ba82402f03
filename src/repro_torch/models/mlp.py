"""Dense FFN blocks: SwiGLU / GELU / squared-ReLU.
Reference: ``src/repro/models/mlp.py``."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common


def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype=torch.float32,
             device=None, bias: bool = False) -> nn.ModuleDict:
    p = {
        "w_up": common.dense_init(gen, d_model, d_ff, dtype, device,
                                  bias=bias),
        "w_down": common.dense_init(gen, d_ff, d_model, dtype, device,
                                    bias=bias),
    }
    if act == "swiglu":
        p["w_gate"] = common.dense_init(gen, d_model, d_ff, dtype, device,
                                        bias=bias)
    return nn.ModuleDict(p)


def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    f = common.activation(act)
    up = common.dense(params["w_up"], x)
    if act == "swiglu":
        h = f(common.dense(params["w_gate"], x)) * up
    else:
        h = f(up)
    return common.dense(params["w_down"], h)
