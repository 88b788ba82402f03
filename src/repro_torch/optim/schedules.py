"""Learning-rate schedules from the paper's appendices.
Reference: ``src/repro/optim/schedules.py``.

A.2/A.3 (Inception): lr(t) = γ0 · β^(t·N/(2T)), β=0.94, γ0 = 0.045·N for
Sync-Opt. A.1 (MNIST): constant then linear anneal to 0. A schedule maps
the host step (an int) to the lr as a Python float holding an f32 value,
computed in f32 as the reference computes it on the device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], float]
_f32 = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(_f32(lr))


def exponential_decay(gamma0: float, beta: float, steps_per_epoch: int,
                      num_workers: int = 1) -> Schedule:
    """Paper: gamma0 * beta^(t*N/(2T)); T = |X|/B steps per epoch."""
    def fn(step):
        exponent = _f32(_f32(step) * _f32(num_workers)
                        / _f32(2.0 * max(steps_per_epoch, 1)))
        return float(_f32(gamma0) * np.power(_f32(beta), exponent))
    return fn


def linear_anneal(lr: float, total_steps: int, anneal_from: int) -> Schedule:
    """Constant lr, then linearly annealed to 0 (paper A.1 MNIST recipe)."""
    def fn(step):
        t = _f32(step)
        frac = np.clip(_f32(_f32(total_steps) - t)
                       / _f32(max(total_steps - anneal_from, 1)),
                       _f32(0.0), _f32(1.0))
        return float(_f32(lr) * (_f32(1.0) if t < anneal_from else frac))
    return fn


def warmup(base: Schedule, warmup_steps: int) -> Schedule:
    if warmup_steps <= 0:
        return base
    def fn(step):
        scale = np.clip(_f32(step) / _f32(warmup_steps), _f32(0.0),
                        _f32(1.0))
        return float(_f32(base(step)) * scale)
    return fn


def from_config(opt_cfg, num_workers: int = 1) -> Schedule:
    """Build the paper-faithful schedule from an OptimizerConfig."""
    gamma0 = opt_cfg.learning_rate
    if opt_cfg.scale_lr_with_workers:
        gamma0 = gamma0 * num_workers          # paper's 0.045*N rule
    if opt_cfg.linear_anneal_steps > 0:
        sched = linear_anneal(gamma0, opt_cfg.linear_anneal_steps,
                              opt_cfg.linear_anneal_from)
    elif opt_cfg.steps_per_epoch > 0:
        sched = exponential_decay(gamma0, opt_cfg.lr_decay_rate,
                                  opt_cfg.steps_per_epoch, num_workers)
    else:
        sched = constant(gamma0)
    return warmup(sched, opt_cfg.warmup_steps)
