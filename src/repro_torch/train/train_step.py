"""The ``sim`` backend's train step: model + optimizer + the paper's
aggregation as a mask-weighted loss.
Reference: ``src/repro/train/train_step.py`` (``make_loss_fn``,
``_microbatch_split``, ``build_train_step``, and ``build_chunk_step`` in
its host-mask mode; :31-194).

The step signature, shared with the spmd engine, is

    step(opt_state, ema, scalars, batch, mask) -> metrics

``mask`` is the [W] backup-worker selection for this step (host-planned
by the ``StragglerSimulator``), ``scalars`` the optimizer's per-step
values (``Optimizer.scalars(step)``: the lr, and Adam's bias
corrections), as floats or 0-dim f32 tensors. The masked aggregation is
realized by weighting per-example losses (``core.sync_backup``), so the
gradient of the one global loss is Alg. 4's mean of the fastest N. The
model holds the parameters; they, ``opt_state`` and ``ema`` are updated
in place. ``metrics`` are 0-dim device tensors (the host lr is the
trainer's to log).

``build_chunk_step`` runs K steps over stacked inputs, the reference's
one ``lax.scan`` dispatch: a Python loop over the step on the CPU, a
captured CUDA graph replayed K times on the card
(``core.step_graph.chunk_step``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core import ema as ema_lib
from repro_torch.core import step_graph
from repro_torch.core import sync_backup
from repro_torch.distributed.spmd_engine import per_example_loss
from repro_torch.optim import optimizers as opt_lib


def make_loss_fn(model, num_workers: int, n_aggregate: int) -> Callable:
    """Builds loss(batch, mask) -> (scalar, metrics)."""

    def loss_fn(batch, mask):
        per_ex, aux = per_example_loss(model, batch)
        main = sync_backup.weighted_loss(per_ex, mask, n_aggregate)
        # monitoring loss: plain mean over the selected workers — divide
        # by the realized selection fraction so Timeout's variable counts
        # don't skew the reading
        sel = torch.sum(per_ex.detach() * sync_backup.per_example_weights(
            mask, per_ex.shape[0], n_aggregate))
        frac = torch.sum(mask.float()) / n_aggregate
        metrics = {"loss": sel / torch.clamp_min(frac, 1e-6),
                   "aux_loss": aux.detach()}
        return main + aux, metrics

    return loss_fn


def _microbatch_split(batch: Dict[str, torch.Tensor], num_workers: int,
                      num_microbatches: int) -> Dict[str, torch.Tensor]:
    """[B, ...] -> [M, B/M, ...] such that every microbatch holds an equal
    slice of every worker's shard (workers own contiguous row blocks, so
    the mask-weighted aggregation stays exact per microbatch)."""
    def split(x):
        per = x.shape[0] // num_workers
        per_mb = per // num_microbatches
        x = x.reshape((num_workers, num_microbatches, per_mb) + x.shape[1:])
        x = x.transpose(0, 1)
        return x.reshape((num_microbatches, num_workers * per_mb)
                         + x.shape[3:])

    return {k: split(v) for k, v in batch.items()}


def build_train_step(model, optimizer: opt_lib.Optimizer, *,
                     num_workers: int, n_aggregate: int,
                     ema_decay: float = 0.0, clip_norm: float = 0.0,
                     num_microbatches: int = 1) -> Callable:
    """``num_microbatches > 1`` accumulates per-microbatch gradients in
    f32 and averages them (metrics averaged too)."""
    loss_fn = make_loss_fn(model, num_workers, n_aggregate)

    def compute_grads(params, batch, mask):
        names, plist = list(params), list(params.values())
        if num_microbatches <= 1:
            total, metrics = loss_fn(batch, mask)
            grads = torch.autograd.grad(total, plist)
            return dict(zip(names, grads)), metrics
        mb = _microbatch_split(batch, num_workers, num_microbatches)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        sums: Dict[str, torch.Tensor] = {}
        for i in range(num_microbatches):
            total, metrics = loss_fn({k: v[i] for k, v in mb.items()}, mask)
            for k, g in zip(names, torch.autograd.grad(total, plist)):
                acc[k] += g.float()
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        return ({k: a / num_microbatches for k, a in acc.items()},
                {k: v / num_microbatches for k, v in sums.items()})

    def train_step(opt_state, ema_state, scalars, batch, mask):
        # looked up per call: init_state / restore may replace the tensors
        params = dict(model.named_parameters())
        grads, metrics = compute_grads(params, batch, mask)
        with torch.no_grad():
            if clip_norm > 0:
                grads, gnorm = opt_lib.clip_by_global_norm(grads, clip_norm)
                metrics["grad_norm"] = gnorm
            optimizer.apply(params, grads, opt_state, scalars)
            if ema_decay > 0:
                ema_lib.update(ema_state, params.items(), ema_decay)
        return metrics

    return train_step


def build_chunk_step(model, optimizer: opt_lib.Optimizer, *,
                     num_workers: int, n_aggregate: int,
                     ema_decay: float = 0.0, clip_norm: float = 0.0,
                     num_microbatches: int = 1) -> Callable:
    """K steps per call over stacked inputs (the reference's host-mask
    mode):

        chunk(opt_state, ema, scalars {name: [K]}, batches {name: [K, B,
              ...]}, masks [K, W]) -> metrics {name: [K]}

    Step k reads row k of every input; the step counter advances through
    the staged scalar rows, as the reference's carry does. The body is
    the unmodified ``build_train_step`` step."""
    step_fn = build_train_step(
        model, optimizer, num_workers=num_workers, n_aggregate=n_aggregate,
        ema_decay=ema_decay, clip_norm=clip_norm,
        num_microbatches=num_microbatches)
    return step_graph.chunk_step(step_fn, model)
