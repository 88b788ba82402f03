"""RWKV-6 "Finch": data-dependent-decay linear attention + channel mix.
Reference: ``src/repro/models/rwkv6.py`` (``_lora``, ``time_mix_init``,
``_token_shift``, ``_mix``, ``time_mix_project``, ``wkv_scan``,
``wkv_chunked``, ``time_mix_apply``, ``channel_mix_init`` /
``channel_mix_apply``, ``rwkv_block_init`` / ``rwkv_block_apply``,
``rwkv_init_block_state``).

Per head (head_dim = D), with receptance r_t, key k_t, value v_t, bonus u,
and *data-dependent* decay w_t = exp(-exp(ŵ_t)):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T            (state: [D, D])
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

Two execution paths: the sequential oracle ``wkv_scan`` (``s == 1``, the
tests) and the chunked form ``wkv_chunked`` (training), which on the card
runs the hand-written kernels of ``kernels/rwkv6_scan.py``, forward and
backward, and on the CPU their plain twin. Parameters live in
``nn.ParameterDict`` / ``nn.ModuleDict`` / ``common.ParamTree`` containers
with the reference's keys (``mu/{r,k,v,w,g}``, ``w_lora/{a,b}``,
``w_base``, ``wr`` … ``wo``, ``u``, ``ln_x``; ``ffn/{mu,wk,wv,wr}``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import rwkv6_scan
from repro_torch.models import common


def _lora_init(gen, d: int, rank: int, out: int, dtype, device
               ) -> nn.ParameterDict:
    return nn.ParameterDict({
        "a": nn.Parameter(common.trunc_normal(gen, (d, rank), 1.0 / d ** 0.5,
                                              dtype, device)),
        "b": nn.Parameter(common.trunc_normal(gen, (rank, out),
                                              1.0 / rank ** 0.5, dtype,
                                              device)),
    })


def _lora(p, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p["a"]) @ p["b"]


def _mus(names, d: int, dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        n: nn.Parameter(torch.full((d,), 0.5, dtype=dtype, device=device))
        for n in names})


def time_mix_init(gen, cfg, dtype=torch.float32,
                  device=None) -> common.ParamTree:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return common.ParamTree({
        "mu": _mus(("r", "k", "v", "w", "g"), d, dtype, device),
        "w_lora": _lora_init(gen, d, 64, d, dtype, device),
        # decay bias (slow default)
        "w_base": torch.full((d,), -6.0, dtype=dtype, device=device),
        "wr": common.dense_init(gen, d, d, dtype, device),
        "wk": common.dense_init(gen, d, d, dtype, device),
        "wv": common.dense_init(gen, d, d, dtype, device),
        "wg": common.dense_init(gen, d, d, dtype, device),
        "wo": common.dense_init(gen, d, d, dtype, device),
        # per-head bonus
        "u": common.trunc_normal(gen, (h, hd), 0.5, dtype, device),
        "ln_x": common.layernorm_init(d, dtype, device),
    })


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """shift(x)_t = x_{t-1}; x_prev is the seed for t=0. x: [B,S,d]."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(mu: torch.Tensor, x: torch.Tensor,
         shifted: torch.Tensor) -> torch.Tensor:
    return x + (shifted - x) * mu


def time_mix_project(params, cfg, x: torch.Tensor, x_prev: torch.Tensor):
    """Projections + data-dependent decays. Returns (r,k,v,g,w) [B,S,H,D]."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    sx = _token_shift(x, x_prev)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (_mix(mu[n], x, sx) for n in "rkvwg")
    r = common.dense(params["wr"], xr).reshape(b, s, h, hd)
    k = common.dense(params["wk"], xk).reshape(b, s, h, hd)
    v = common.dense(params["wv"], xv).reshape(b, s, h, hd)
    g = F.silu(common.dense(params["wg"], xg))
    # data-dependent decay in (0,1): w = exp(-exp(w_base + lora(xw))).
    # w_log is clamped so per-step |log w| <= 5: keeps the chunked form's
    # exp(-cumsum(log w)) factor finite in f32 for chunk <= 16 (max e^80).
    w_log = (params["w_base"].float()
             + _lora(params["w_lora"], xw).float())
    w_log = torch.clamp(w_log, -8.0, 1.6)
    w = torch.exp(-torch.exp(w_log)).reshape(b, s, h, hd)
    return r, k, v, g, w


def wkv_scan(r, k, v, w, u, state=None):
    """Sequential oracle. r,k,v,w: [B,S,H,D]; u: [H,D]; state: [B,H,D,D].

    Returns (out [B,S,H,D], final_state). Computed in f32.
    """
    b, s, h, d = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    if state is None:
        state = torch.zeros((b, h, d, d), dtype=torch.float32,
                            device=r.device)
    outs = []
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # [B,H,D]
        kv = kt[..., :, None] * vt[..., None, :]              # [B,H,D,D]
        outs.append(torch.einsum("bhd,bhde->bhe", rt,
                                 state + u[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv_chunked(r, k, v, w, u, state=None, chunk: int = rwkv6_scan.CHUNK,
                *, use_kernel: bool = True):
    """Chunked-parallel wkv6: intra-chunk attention form + inter-chunk
    state (see ``kernels/rwkv6_scan.wkv6_plain``). On the card it runs the
    wkv6 kernels, which start from a zero state in chunks of 16: any other
    ``state`` or ``chunk`` on a CUDA tensor raises. ``use_kernel=False``,
    and the CPU, take the plain twin. Returns (out [B,S,H,D] f32, state)."""
    if use_kernel and r.device.type == "cuda":
        if state is not None or chunk != rwkv6_scan.CHUNK:
            raise ValueError(
                f"the wkv6 kernels start from a zero state in chunks of "
                f"{rwkv6_scan.CHUNK} (got a state: {state is not None}, "
                f"chunk {chunk}); use_kernel=False takes the plain twin")
        return rwkv6_scan.wkv6(r, k, v, w, u)
    return rwkv6_scan.wkv6_plain(r, k, v, w, u, state, chunk)


def time_mix_apply(params, cfg, x: torch.Tensor, x_prev: torch.Tensor,
                   state=None, chunked: bool = True, *,
                   use_kernel: bool = True):
    """Full RWKV6 time-mix block (no residual). Returns (out, (x_last, state))."""
    b, s, d = x.shape
    r, k, v, g, w = time_mix_project(params, cfg, x, x_prev)
    u = params["u"].float()
    if chunked and s > 1:
        out, state = wkv_chunked(r, k, v, w, u, state, use_kernel=use_kernel)
    else:
        out, state = wkv_scan(r, k, v, w, u, state)
    out = out.reshape(b, s, d).to(x.dtype)
    out = common.layernorm(params["ln_x"], out, 1e-5) * g
    out = common.dense(params["wo"], out)
    return out, (x[:, -1, :], state)


def channel_mix_init(gen, cfg, dtype=torch.float32,
                     device=None) -> nn.ModuleDict:
    d, f = cfg.d_model, cfg.d_ff
    return nn.ModuleDict({
        "mu": _mus(("k", "r"), d, dtype, device),
        "wk": common.dense_init(gen, d, f, dtype, device),
        "wv": common.dense_init(gen, f, d, dtype, device),
        "wr": common.dense_init(gen, d, d, dtype, device),
    })


def channel_mix_apply(params, x: torch.Tensor, x_prev: torch.Tensor):
    sx = _token_shift(x, x_prev)
    xk = _mix(params["mu"]["k"], x, sx)
    xr = _mix(params["mu"]["r"], x, sx)
    k = torch.square(F.relu(common.dense(params["wk"], xk)))
    r = torch.sigmoid(common.dense(params["wr"], xr))
    return r * common.dense(params["wv"], k), x[:, -1, :]


def rwkv_block_init(gen, cfg, dtype=torch.float32,
                    device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": common.layernorm_init(cfg.d_model, dtype, device),
        "att": time_mix_init(gen, cfg, dtype, device),
        "ln2": common.layernorm_init(cfg.d_model, dtype, device),
        "ffn": channel_mix_init(gen, cfg, dtype, device),
    })


def rwkv_block_apply(params, cfg, x: torch.Tensor, block_state: Dict,
                     chunked: bool = True, *, use_kernel: bool = True):
    """block_state: dict(att_x, att_s, ffn_x); ``att_s`` None is the zero
    state. Returns (x, new_state)."""
    h = common.layernorm(params["ln1"], x, 1e-5)
    att, (ax, astate) = time_mix_apply(params["att"], cfg, h,
                                       block_state["att_x"],
                                       block_state["att_s"], chunked=chunked,
                                       use_kernel=use_kernel)
    x = x + att
    h = common.layernorm(params["ln2"], x, 1e-5)
    ffn, fx = channel_mix_apply(params["ffn"], h, block_state["ffn_x"])
    x = x + ffn
    return x, {"att_x": ax, "att_s": astate, "ffn_x": fx}


def rwkv_init_block_state(cfg, batch: int, dtype=torch.float32,
                          device=None) -> Dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    return {
        "att_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "att_s": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                             device=device),
        "ffn_x": torch.zeros((batch, d), dtype=dtype, device=device),
    }
