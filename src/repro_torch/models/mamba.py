"""Mamba-2 / SSD-style selective state-space head (Hymba's SSM path).
Reference: ``src/repro/models/mamba.py`` (``ssd_init``, ``ssd_project``,
``ssd_scan``, ``ssd_chunked``, ``ssd_apply``, ``ssd_init_state``).

Multi-head SSD with a scalar decay per head, a_t = exp(-softplus(dt) * A):

    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T        state: [N, P] a head
    y_t = C_t^T S_t + D x_t

N is the state dim, P the head dim. ``ssd_scan`` is the sequential form
(the oracle, and decode's one step); ``ssd_chunked`` the chunked-parallel
training form: inside a chunk of 64 the gates are ``exp(acc_t - acc_j)``
from the cumulative log decay (``min(diff, 0)`` keeps the masked upper
triangle from overflowing), across chunks the state is carried. The state
math is f32 whatever the model dtype, as in the reference. The reference's
``lax.scan`` over time (``ssd_scan``) or over the chunks' carried state
(``ssd_chunked``, whose per-chunk products are batched over the chunks)
is a Python loop here; every operation goes through ``torch.func.vmap``
(the spmd engine's batched worker gradients).
"""
from __future__ import annotations

import torch

from repro_torch.models import common


def ssd_init(gen, d_in: int, num_heads: int, head_dim: int, state_dim: int,
             dtype=torch.float32, device=None) -> common.ParamTree:
    """Projections of a multi-head SSD mixer over x [B, S, d_in]: the value
    path ``wx``, the input and output gates ``wb`` / ``wc``, the per-head
    step ``wdt``, ``a_log`` (A = -exp(a_log)) and ``dt_bias`` in f32, the
    skip ``d_skip``."""
    h, p, n = num_heads, head_dim, state_dim
    return common.ParamTree({
        "wx": common.dense_init(gen, d_in, h * p, dtype, device),
        "wb": common.dense_init(gen, d_in, h * n, dtype, device),
        "wc": common.dense_init(gen, d_in, h * n, dtype, device),
        "wdt": common.dense_init(gen, d_in, h, dtype, device),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((h, p), dtype=dtype, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
    })


def ssd_project(params, x: torch.Tensor, num_heads: int, head_dim: int,
                state_dim: int):
    """x [B, S, d] -> xv [B, S, H, P], bb / cc [B, S, H, N] (x's dtype),
    dt and decay [B, S, H] (f32, decay in (0, 1))."""
    b, s, _ = x.shape
    h, p, n = num_heads, head_dim, state_dim
    xv = common.dense(params["wx"], x).reshape(b, s, h, p)
    bb = common.dense(params["wb"], x).reshape(b, s, h, n)
    cc = common.dense(params["wc"], x).reshape(b, s, h, n)
    pre = common.dense(params["wdt"], x).float() + params["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))        # softplus
    a = -torch.exp(params["a_log"])                          # [H], negative
    decay = torch.exp(dt * a)
    return xv, bb, cc, dt, decay


def ssd_scan(xv, bb, cc, dt, decay, d_skip, state=None):
    """The sequential form. xv: [B, S, H, P]; bb / cc: [B, S, H, N]; dt /
    decay: [B, S, H]; ``state`` [B, H, N, P] f32 (zeros when None).
    Returns (y [B, S, H, P] in xv's dtype, the final state)."""
    b, s, h, p = xv.shape
    n = bb.shape[-1]
    xv32, bb32, cc32 = xv.float(), bb.float(), cc.float()
    if state is None:
        state = torch.zeros((b, h, n, p), dtype=torch.float32,
                            device=xv.device)
    ys = []
    for t in range(s):
        state = (decay[:, t, :, None, None] * state
                 + dt[:, t, :, None, None] * bb32[:, t, :, :, None]
                 * xv32[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cc32[:, t], state))
    y = torch.stack(ys, dim=1) + d_skip[None, None] * xv32
    return y.to(xv.dtype), state


def ssd_chunked(xv, bb, cc, dt, decay, d_skip, state=None, chunk: int = 64):
    """The chunked-parallel form of ``ssd_scan`` (same arguments and
    result). S is padded to a multiple of ``chunk``: x, B, C and dt with
    zeros, the decay with 1.0, so the padded steps leave the state as it
    is. What each chunk computes alone (the cumulative log decay, the
    gated intra-chunk products, its contribution to the state) is one
    batched op over every chunk; the loop carries the state across the
    chunks, as the reference's scan does."""
    b, s, h, p = xv.shape
    n = bb.shape[-1]
    if state is None:
        state = torch.zeros((b, h, n, p), dtype=torch.float32,
                            device=xv.device)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    xp, bp, cp, dtp = (common.pad_seq(t, pad) for t in (xv, bb, cc, dt))
    dcp = common.pad_seq(decay, pad, 1.0)
    # [B, nc, H, C, *]
    xs = xp.float().reshape(b, nc, chunk, h, p).transpose(2, 3)
    bs = bp.float().reshape(b, nc, chunk, h, n).transpose(2, 3)
    cs = cp.float().reshape(b, nc, chunk, h, n).transpose(2, 3)
    dts = dtp.reshape(b, nc, chunk, h).transpose(2, 3)          # [B,nc,H,C]
    dcs = dcp.reshape(b, nc, chunk, h).transpose(2, 3)
    logd = torch.log(torch.clamp_min(dcs, 1e-30))
    acc = torch.cumsum(logd, dim=-1)                            # inclusive
    # intra-chunk: y_t += sum_{j<=t} C_t.B_j dt_j x_j exp(acc_t - acc_j)
    scores = torch.einsum("bchtn,bchjn->bchtj", cs, bs * dts[..., None])
    diff = acc[..., :, None] - acc[..., None, :]                # [B,nc,H,C,C]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xv.device))
    gate = torch.where(tri, torch.exp(torch.clamp_max(diff, 0.0)),
                       torch.zeros_like(diff))
    y = torch.einsum("bchtj,bchjp->bchtp", scores * gate, xs)
    # each chunk's own contribution to the state, decayed to its end
    a_all = torch.exp(acc[..., -1])                             # [B,nc,H]
    w_j = torch.exp(acc[..., -1:] - acc)
    contrib = torch.einsum("bchjn,bchjp->bchnp",
                           bs * (dts * w_j)[..., None], xs)     # [B,nc,H,N,P]
    entering = []
    for c in range(nc):
        entering.append(state)
        state = a_all[:, c, :, None, None] * state + contrib[:, c]
    # the carried state: y_t += C_t . exp(acc_t) S_in
    y = y + torch.einsum("bchtn,bchnp->bchtp",
                         cs * torch.exp(acc)[..., None],
                         torch.stack(entering, dim=1))
    y = y.transpose(2, 3).reshape(b, nc * chunk, h, p)[:, :s]
    y = y + d_skip[None, None] * xv.float()
    return y.to(xv.dtype), state


def ssd_apply(params, x: torch.Tensor, num_heads: int, head_dim: int,
              state_dim: int, state=None, chunked: bool = True):
    """The SSD mixer over x [B, S, d]: (y [B, S, H, P], the final state).
    ``chunked`` and S > 1 take ``ssd_chunked``, else ``ssd_scan``."""
    xv, bb, cc, dt, decay = ssd_project(params, x, num_heads, head_dim,
                                        state_dim)
    fn = ssd_chunked if (chunked and x.shape[1] > 1) else ssd_scan
    return fn(xv, bb, cc, dt, decay, params["d_skip"].float(), state)


def ssd_init_state(batch: int, num_heads: int, head_dim: int,
                   state_dim: int, device=None) -> torch.Tensor:
    """The zero SSD state [B, H, N, P], f32."""
    return torch.zeros((batch, num_heads, state_dim, head_dim),
                       dtype=torch.float32, device=device)
