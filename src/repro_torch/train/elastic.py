"""Elastic scaling: resume training with a different worker count.
Reference: ``src/repro/train/elastic.py``.

The paper's lr rule (A.3: gamma0 = 0.045*N) makes a worker-count change a
first-class event: ``Trainer.rescale`` checkpoints, rebuilds the strategy
and the schedule for the new (N, b) of :func:`plan_rescale`, restores and
continues; the data pipeline's step counter replays no sample.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import AggregationConfig, TrainConfig, replace


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_workers: int
    new_workers: int
    old_backups: int
    new_backups: int
    lr_scale: float


def plan_rescale(cfg: TrainConfig, new_total: int,
                 backup_fraction: Optional[float] = None) -> RescalePlan:
    """Choose (N, b) for a new machine count, preserving the paper's
    ~4% backup fraction (N=96,b=4 optimum) unless told otherwise."""
    agg = cfg.aggregation
    frac = (backup_fraction if backup_fraction is not None
            else (agg.backup_workers / max(agg.total_workers, 1)))
    new_b = max(0, round(new_total * frac)) if agg.strategy == "backup" else 0
    new_n = new_total - new_b
    lr_scale = new_n / max(agg.num_workers, 1) \
        if cfg.optimizer.scale_lr_with_workers else 1.0
    return RescalePlan(agg.num_workers, new_n, agg.backup_workers, new_b, lr_scale)


def apply_rescale(cfg: TrainConfig, plan: RescalePlan) -> TrainConfig:
    new_agg = replace(cfg.aggregation, num_workers=plan.new_workers,
                      backup_workers=plan.new_backups)
    return replace(cfg, aggregation=new_agg)
