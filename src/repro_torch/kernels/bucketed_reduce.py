"""Bucketed masked reduce: the aggregation half of Alg. 4 line 7.
Reference: ``src/repro/kernels/bucketed_reduce.py`` (``ref_masked_mean``,
``bucket_bounds``, ``reduce_then_psum``).

The flattened ``[W, P]`` gradient stack is cut into buckets of
``bucket`` lanes and each bucket is masked-reduced: by the
``backup_reduce`` CUDA kernel (``use_kernel=True``, CUDA tensors only) or
by its plain twin (``use_kernel=False``). On the plain path, as in the
reference, ``W == 1`` is a scalar rescale of the one row; the kernel takes
``W == 1`` too (a rank of a shrunk ``'data'`` axis holds one worker), and
an empty bucket takes the plain path. The per-step monitoring scalars (``tail``) ride the last bucket:
the buckets are reduced straight into one ``[P + E]`` output whose last
``E`` lanes hold the tail.

With a process group (the spmd engine's ``'data'`` axis over ranks,
``distributed.mesh``) each bucket is summed over the ranks by one
``torch.distributed.all_reduce`` issued as soon as that bucket is
reduced, the last bucket together with the tail: ``ceil(P / bucket)``
collectives a step, as the reference's ``psum`` per bucket. Without one
(one card holds every worker) there is no collective.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

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
                     use_kernel: bool = True, group=None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Bucketed masked reduce of [W, P] stacked grads, summed over
    ``group``'s ranks per bucket (no collective when ``group`` is None).

    Returns ``([P] f32 (1/n_aggregate) * sum_{selected} g_w, tail_out)``,
    ``tail_out`` being ``tail`` in f32, summed over the ranks with the last
    bucket (None in == None out)."""
    w, p = grads.shape
    if tuple(mask.shape) != (w,):
        raise ValueError(f"mask shape {tuple(mask.shape)} does not match the "
                         f"worker axis of grads {tuple(grads.shape)}")
    mf = mask.float()
    e = 0 if tail is None else tail.numel()
    out = torch.empty(p + e, dtype=torch.float32, device=grads.device)
    bounds = bucket_bounds(p, bucket)
    for i, (lo, hi) in enumerate(bounds):
        chunk = grads[:, lo:hi]
        if use_kernel and hi > lo:
            # the kernel also takes one local worker (a rank of a shrunk
            # 'data' axis): the path keeps its kernel on the card
            backup_reduce(chunk, mf, n_aggregate, out=out[lo:hi])
        elif w == 1:
            # one local worker: the masked mean is a rescale of its row
            out[lo:hi] = chunk[0].float() * (mf[0] / n_aggregate)
        else:
            out[lo:hi] = backup_reduce_plain(chunk, mf, n_aggregate)
        if i == len(bounds) - 1:
            if tail is not None:
                out[p:] = tail.float().reshape(-1)
            hi = p + e
        if group is not None:
            dist.all_reduce(out[lo:hi], group=group)
    if tail is None:
        return out[:p], None
    return out[:p], out[p:]
