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

``build_event_chunk_step`` (reference :197-246) is the event regimes'
counterpart: K host-planned arrivals per call, each one captured CUDA
graph's replay on the card (one graph for an arrival that applies the
update, one for an arrival that only buffers), a Python loop on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
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


def build_event_chunk_step(model, grad_fn: Callable, update_fn: Callable,
                           strategy, *, ema_decay: float = 0.0) -> Callable:
    """K host-planned arrivals per call:

        chunk(params, opt_state, ema, workers {name: [W, ...]}, aux,
              scalars {name: [K]}, batches {name: [K, b, ...]},
              rows {worker, slot_w, slot_r: [K] int64}, apply [K] bool)
            -> losses [K]

    ``params`` are the PS parameters (the trainer's model), ``workers``
    the stacked per-worker read copies, ``aux`` the strategy's carry
    (``init_scan_state``), ``rows`` and ``apply`` the host plan
    (``EventPlan.rows``, ``EventPlan.apply``), ``scalars`` the optimizer's
    staged scalars of each arrival's PS version (``EventPlan.step``). All
    state is updated in place. Per arrival: the arriving worker's row is
    gathered into ``model`` (the gradient model of ``grad_fn``, never the
    PS's), ``grad_fn`` runs, the strategy aggregates or buffers
    (``on_arrival_scan``), an arrival that applies runs ``update_fn`` and
    the EMA, and the worker's row takes the fresh parameters. The worker
    index and the ring slots are ``[1]`` device tensors, never Python
    ints, so one capture serves every worker. On the card each branch of
    ``apply`` is its own captured graph (both in one memory pool), replayed
    as the plan says; on the CPU the body runs as it is.
    ``chunk.graphs`` maps ``apply`` to its StepGraph (empty on the CPU)."""
    device = torch.device(model.device)
    held: Dict[str, object] = {}

    def body(static: Dict[str, torch.Tensor], apply: bool
             ) -> Dict[str, torch.Tensor]:
        params, workers, wk = held["params"], held["workers"], \
            static["worker"]
        own = dict(model.named_parameters())
        with torch.no_grad():
            for k, p in own.items():
                torch.index_select(workers[k], 0, wk, out=p.unsqueeze(0))
        loss, grads = grad_fn(own, {k[6:]: v for k, v in static.items()
                                    if k.startswith("batch/")})
        with torch.no_grad():
            agg = strategy.on_arrival_scan(
                held["aux"], grads, {"apply": apply,
                                     "slot_w": static["slot_w"],
                                     "slot_r": static["slot_r"]})
            del grads
            if apply:
                update_fn(params, held["opt_state"], agg,
                          {k[7:]: v for k, v in static.items()
                           if k.startswith("scalar/")})
                del agg
                if ema_decay > 0:
                    ema_lib.update(held["ema"], params.items(), ema_decay)
            # the worker reads the fresh params for its next mini-batch
            for k, s in workers.items():
                s.index_copy_(0, wk, params[k].unsqueeze(0))
        return {"loss": loss}

    graphs: Dict[bool, step_graph.StepGraph] = {}
    if device.type == "cuda":
        pool = torch.cuda.graph_pool_handle()
        for a in (True, False):
            graphs[a] = step_graph.StepGraph(
                lambda static, a=a: body(static, a), device, pool=pool)

    def chunk(params, opt_state, ema, workers, aux, scalars, batches, rows,
              apply: np.ndarray) -> torch.Tensor:
        k = len(apply)
        held.update(params=params, opt_state=opt_state, ema=ema,
                    workers=workers, aux=aux)
        state = None
        losses = None
        for i in range(k):
            inputs = {**{n: v[i:i + 1] for n, v in rows.items()},
                      **{f"scalar/{n}": v[i] for n, v in scalars.items()},
                      **{f"batch/{n}": v[i] for n, v in batches.items()}}
            if not graphs:
                out = body(inputs, bool(apply[i]))
            else:
                if state is None:
                    state = [*step_graph.train_state(model, {}, None),
                             *params.values(),
                             *(t for sub in opt_state.values()
                               for t in sub.values()),
                             *(ema.values() if ema is not None else ()),
                             *workers.values(), *aux.values()]
                out = graphs[bool(apply[i])](inputs, state)
            if losses is None:
                losses = torch.empty((k,), dtype=out["loss"].dtype,
                                     device=out["loss"].device)
            losses[i].copy_(out["loss"])
        held.clear()
        return losses

    chunk.graphs = graphs
    return chunk
