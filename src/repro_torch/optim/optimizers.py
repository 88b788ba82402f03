"""Stochastic optimizers over named parameter tensors.
Reference: ``src/repro/optim/optimizers.py``.

    opt = make_optimizer(cfg, schedule)
    state = opt.init(named_params)          # {"ms": {...}, "mom": {...}}
    scalars = opt.scalars(step)             # {"lr": ...} host f32 values
    opt.apply(named_params, grads, state, scalars)

``named_params`` maps a parameter name (the module's ``named_parameters``
key) to its tensor; ``grads`` maps the same names to gradients; the state
is a dict of dicts of f32 tensors keyed like the reference's trees
(``{"ms", "mom"}`` for ``rmsprop_momentum``, ``{"m"}`` for momentum,
``{"m", "v"}`` for adam, ``{"acc"}`` for adagrad, ``{}`` for sgd), each
inner dict keyed like the parameters. ``apply`` updates parameters and
state in place, under ``no_grad`` (the reference returns new trees; in
place the step holds one copy of each). The arithmetic and its order are
the reference's: f32 state, updates computed in f32, each parameter
rounded once to its own dtype.

The step enters only through its host scalars: ``scalars(step)`` gives
the values one step reads (the lr from the schedule, and Adam's bias
corrections ``bc1``/``bc2``), computed in f32 as the reference computes
them on the device. ``apply`` takes them as Python floats or as 0-dim f32
tensors. The trainer stages a chunk's K rows of them as ``[K]`` f32
tensors on the device and hands each step a 0-dim slice
(``stage_scalars``), so a captured CUDA graph reads each step's values
from memory instead of baking in the capture step's; its eager per-step
path stages them too, since on CUDA a float divisor is applied as a
multiply by its reciprocal and a tensor divisor as a division. On the
CPU the two forms give the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import (Callable, Dict, Mapping, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

Named = Dict[str, torch.Tensor]
State = Dict[str, Named]
Scalars = Mapping[str, Union[float, torch.Tensor]]


def _lr_scalars(schedule) -> Callable[[int], Dict[str, float]]:
    return lambda step: {"lr": schedule(step)}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Named], State]
    apply: Callable[[Named, Named, State, Scalars], None]
    scalars: Callable[[int], Dict[str, float]]


def stage_scalars(optimizer: Optimizer, steps: Sequence[int],
                  device) -> Dict[str, torch.Tensor]:
    """The per-step host scalars of ``steps`` as ``{name: [K] f32}`` on
    ``device`` (one host->device copy each; pinned first on the card)."""
    rows = [optimizer.scalars(s) for s in steps]
    out = {}
    for name in rows[0]:
        t = torch.from_numpy(np.array([r[name] for r in rows], np.float32))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[name] = t.to(device, non_blocking=True)
    return out


@torch.no_grad()
def global_norm(tensors: Named) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tensors.values()]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def clip_by_global_norm(grads: Named, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Named, torch.Tensor]:
    """Paper §A.3: Async-Opt requires global-norm clipping; Sync does not.
    ``norm``: the global norm when ``grads`` are one rank's slices of it
    (``spmd_engine.tp_global_norm``); None computes it from ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return ({k: (g.float() * scale).to(g.dtype) for k, g in grads.items()},
            norm)


def _f32_like(params: Named) -> Named:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def _set(p: torch.Tensor, value32: torch.Tensor) -> None:
    p.copy_(value32.to(p.dtype))


def sgd(schedule) -> Optimizer:
    def init(params):
        return {}

    @torch.no_grad()
    def apply(params, grads, state, scalars):
        lr = scalars["lr"]
        for k, p in params.items():
            _set(p, p.float() - lr * grads[k].float())

    return Optimizer(init, apply, _lr_scalars(schedule))


def momentum(schedule, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": _f32_like(params)}

    @torch.no_grad()
    def apply(params, grads, state, scalars):
        lr = scalars["lr"]
        for k, p in params.items():
            g = grads[k].float()
            m = state["m"][k]
            m.mul_(beta).add_(g)
            upd = beta * m + g if nesterov else m
            _set(p, p.float() - lr * upd)

    return Optimizer(init, apply, _lr_scalars(schedule))


def rmsprop_momentum(schedule, decay: float = 0.9, mom: float = 0.9,
                     eps: float = 1e-8) -> Optimizer:
    """The paper's optimizer (RMSProp w/ momentum, TF-style)."""

    def init(params):
        return {"ms": _f32_like(params), "mom": _f32_like(params)}

    @torch.no_grad()
    def apply(params, grads, state, scalars):
        lr = scalars["lr"]
        for k, p in params.items():
            g = grads[k].float()
            ms, mo = state["ms"][k], state["mom"][k]
            ms.mul_(decay).add_(torch.square(g).mul_(1 - decay))
            mo.mul_(mom).add_(g.mul(lr).div_(torch.sqrt(ms + eps)))
            _set(p, p.float() - mo)

    return Optimizer(init, apply, _lr_scalars(schedule))


def adam(schedule, beta1: float = 0.9, beta2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _f32_like(params), "v": _f32_like(params)}

    def scalars(step):
        t = np.float32(step) + np.float32(1.0)
        return {"lr": schedule(step),
                "bc1": float(np.float32(1.0) - np.float32(beta1) ** t),
                "bc2": float(np.float32(1.0) - np.float32(beta2) ** t)}

    @torch.no_grad()
    def apply(params, grads, state, scalars):
        lr, bc1, bc2 = scalars["lr"], scalars["bc1"], scalars["bc2"]
        for k, p in params.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m.mul_(beta1).add_(g * (1 - beta1))
            v.mul_(beta2).add_(torch.square(g).mul_(1 - beta2))
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            _set(p, p.float() - lr * u)

    return Optimizer(init, apply, scalars)


def adagrad(schedule, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"acc": _f32_like(params)}

    @torch.no_grad()
    def apply(params, grads, state, scalars):
        lr = scalars["lr"]
        for k, p in params.items():
            g = grads[k].float()
            acc = state["acc"][k]
            acc.add_(torch.square(g))
            _set(p, p.float() - lr * g / (torch.sqrt(acc) + eps))

    return Optimizer(init, apply, _lr_scalars(schedule))


def make_optimizer(opt_cfg, schedule) -> Optimizer:
    name = opt_cfg.name
    if name == "sgd":
        return sgd(schedule)
    if name == "momentum":
        return momentum(schedule, opt_cfg.momentum)
    if name == "rmsprop_momentum":
        return rmsprop_momentum(schedule, opt_cfg.decay, opt_cfg.momentum,
                                opt_cfg.eps)
    if name == "rmsprop":
        return rmsprop_momentum(schedule, opt_cfg.decay, 0.0, opt_cfg.eps)
    if name == "adam":
        return adam(schedule, opt_cfg.beta1, opt_cfg.beta2, opt_cfg.eps,
                    opt_cfg.weight_decay)
    if name == "adagrad":
        return adagrad(schedule)
    raise ValueError(f"unknown optimizer {name!r}")
