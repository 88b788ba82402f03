"""Bucketed masked reduce: the aggregation half of Alg. 4 line 7.
Reference: ``src/repro/kernels/bucketed_reduce.py`` (``ref_masked_mean``,
``bucket_bounds``, ``reduce_then_psum``).

The flattened ``[W, P]`` gradient stack is cut into buckets of
``bucket`` lanes and each bucket is masked-reduced: by the
``backup_reduce`` CUDA kernel (``use_kernel=True``, CUDA tensors only) or
by its plain twin (``use_kernel=False``). As in the reference, ``W == 1``
is a scalar rescale of the one row and an empty bucket takes the plain
path. The per-step monitoring scalars (``tail``) ride the last bucket:
the buckets are reduced straight into one ``[P + E]`` output whose last
``E`` lanes hold the tail, the layout over which the reference issues one
collective per bucket. The port runs one card, where that collective is
the identity: no ``torch.distributed`` all-reduce is issued here (it comes
with the multi-card engine, ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.backup_reduce import (backup_reduce,
                                               backup_reduce_plain)


def ref_masked_mean(grads: torch.Tensor, mask: torch.Tensor,
                    n_aggregate: int) -> torch.Tensor:
    """The reference's dense oracle: (mask @ grads) / n_aggregate, f32."""
    return (mask.float() @ grads.float()) / n_aggregate


def bucket_bounds(total: int, bucket: int) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) slices cutting ``total`` lanes into ``bucket``-size pieces;
    ``bucket <= 0`` means one bucket spanning everything, and the last
    bucket is ragged when ``bucket`` does not divide ``total``."""
    if total < 0:
        raise ValueError(f"total lanes must be >= 0 (got {total})")
    if bucket <= 0 or bucket >= total:
        return ((0, total),)
    return tuple((lo, min(lo + bucket, total))
                 for lo in range(0, total, bucket))


def reduce_then_psum(grads: torch.Tensor, mask: torch.Tensor,
                     n_aggregate: int, *, bucket: int = 0,
                     tail: Optional[torch.Tensor] = None,
                     use_kernel: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Bucketed masked reduce of [W, P] stacked grads.

    Returns ``([P] f32 (1/n_aggregate) * sum_{selected} g_w, tail_out)``,
    ``tail_out`` being ``tail`` in f32 (None in == None out)."""
    w, p = grads.shape
    if tuple(mask.shape) != (w,):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not match the "
                         f"worker axis of grads {tuple(grads.shape)}")
    mf = mask.float()
    e = 0 if tail is None else tail.numel()
    out = torch.empty(p + e, dtype=torch.float32, device=grads.device)
    for lo, hi in bucket_bounds(p, bucket):
        chunk = grads[:, lo:hi]
        if w == 1:
            # one local worker: the masked mean is a rescale of its row
            out[lo:hi] = chunk[0].float() * (mf[0] / n_aggregate)
        elif use_kernel and hi > lo:
            backup_reduce(chunk, mf, n_aggregate, out=out[lo:hi])
        else:
            out[lo:hi] = backup_reduce_plain(chunk, mf, n_aggregate)
    if tail is None:
        return out[:p], None
    out[p:] = tail.float().reshape(-1)
    return out[:p], out[p:]
