"""Sync-SGD with backup workers as a mask-weighted loss (paper Alg. 3/4).
Reference: ``src/repro/core/sync_backup.py``.

With the global batch laid out as W contiguous worker shards of B/W
examples, the paper's update

    theta <- theta - (lr/N) * sum_{w in fastest-N} G_w,
    G_w = mean gradient over worker w's mini-batch

equals the gradient of the mask-weighted loss

    L = sum_b weight_b * loss_b,
    weight_b = mask[worker_of(b)] / (N * B/W)

which is what the ``sim`` backend differentiates. The explicit
stacked-gradient form is the ``spmd`` engine's ``backup_reduce``.
"""
from __future__ import annotations

import torch


def per_example_weights(mask: torch.Tensor, global_batch: int,
                        n_aggregate: int) -> torch.Tensor:
    """weight_b = mask[worker_of(b)] / (N * per_worker_batch), f32."""
    per = global_batch // mask.shape[0]
    rep = torch.repeat_interleave(mask.float(), per)
    return rep / (n_aggregate * per)


def weighted_loss(per_example_loss: torch.Tensor, mask: torch.Tensor,
                  n_aggregate: int) -> torch.Tensor:
    """per_example_loss: [B] (already averaged over tokens) -> scalar whose
    gradient is the paper's Alg. 4 update direction."""
    wts = per_example_weights(mask, per_example_loss.shape[0], n_aggregate)
    return torch.sum(per_example_loss * wts)

