"""Recovery supervisor: drive an experiment to completion through faults.
Reference: ``src/repro/train/supervisor.py`` (``RECOVERABLE``,
``run_supervised``).

``run_supervised(cfg)`` builds and runs the Trainer, and when the run
dies — an injected :class:`~repro_torch.core.faults.Preemption`, a
worker-exhaustion ``RuntimeError``, a checkpoint write whose ``OSError``
outlived its retries, or corrupt restored state — restores the last
verified-good checkpoint (``checkpoint.find_good_step`` walks back past
corrupt ones) and continues, up to ``cfg.faults.max_restarts`` times,
then logs ``give_up`` and re-raises.

The supervisor owns the :class:`~repro_torch.core.faults.FaultInjector`
across restarts: faults fire at most once, and ``injector.resync``
re-applies their persistent effects (deaths, active slowdowns) to each
rebuilt Trainer. A config that a run rescaled (``Trainer.rescale``) is
kept for later restarts. Log entries hold steps, workers and attempt
counts only, so the same (spec, seed) gives a bit-identical log;
``recover_times`` collects wall-clock recovery durations beside it.

In a world of ranks every rank runs its own supervisor: the plan is
seeded, so every rank fails at the same step, and each restores, after a
barrier, from the checkpoint rank 0 wrote. The old Trainer (its model,
state and step graph) is released before the next is built. A refusal
(``NotImplementedError``) is not a fault and is re-raised at once.
``tracer=`` / ``metrics=`` go to every Trainer it builds, so one trace and
one registry span the restarts.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core import faults as faults_lib
from repro_torch.core.straggler import LatencyModel
from repro_torch.data.synthetic_lm import SyntheticLMConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.loop import Trainer, TrainResult

# what a restart can fix: injected preemptions, dead-worker exhaustion or
# corruption (RuntimeError covers CheckpointCorruption), and write
# failures that outlived their retries
RECOVERABLE = (faults_lib.Preemption, RuntimeError, OSError)


def run_supervised(cfg: TrainConfig, *,
                   latency: Optional[LatencyModel] = None,
                   device=None,
                   data_cfg: Optional[SyntheticLMConfig] = None,
                   model=None, batch_fn: Optional[Callable] = None,
                   injector: Optional[faults_lib.FaultInjector] = None,
                   max_restarts: Optional[int] = None,
                   recover_times: Optional[List[float]] = None,
                   tracer=None, metrics=None) -> TrainResult:
    """Run ``cfg`` to ``cfg.total_steps``, restarting through failures.

    ``run_experiment``'s keywords; ``max_restarts`` overrides
    ``cfg.faults.max_restarts``. Raises the final error (after logging
    ``give_up``) once the restart budget is spent."""
    if injector is None:
        injector = faults_lib.build_injector(
            cfg.faults, num_steps=cfg.total_steps,
            num_workers=cfg.aggregation.total_workers)
    budget = cfg.faults.max_restarts if max_restarts is None else max_restarts
    attempts = 0
    resume = False
    crash_t: Optional[float] = None
    while True:
        tr = Trainer(cfg, latency=latency, device=device, data_cfg=data_cfg,
                     model=model, batch_fn=batch_fn, injector=injector,
                     tracer=tracer, metrics=metrics)
        if resume:
            if torch.distributed.is_initialized():
                torch.distributed.barrier()    # rank 0's write is whole
            good = ckpt_lib.find_good_step(cfg.checkpoint.directory)
            if good is not None:
                tr.reset_optimizer_state()
                tr.restore_checkpoint(good)
            else:
                # nothing verified-good on disk: recovery = fresh start
                tr.init_state()
            if injector is not None:
                injector.record("restore", step=tr.step, attempt=attempts)
        else:
            tr.init_state()
        if injector is not None:
            injector.resync(tr)
        if crash_t is not None and recover_times is not None:
            recover_times.append(time.monotonic() - crash_t)
        crash_t = None
        try:
            return tr.run(max(cfg.total_steps - tr.step, 0))
        except NotImplementedError:
            raise
        except RECOVERABLE as e:
            crash_t = time.monotonic()
            attempts += 1
            cfg = tr.cfg          # keep any elastic rescale the run applied
            if attempts > budget:
                if injector is not None:
                    injector.record("give_up", step=tr.step,
                                    restarts=attempts,
                                    error=type(e).__name__)
                    # the structured log would otherwise die with the run
                    e.recovery_log = list(injector.log)
                raise
            resume = True
            # the traceback holds the dead trainer: hand its memory back
            tr._release()
