"""Rank functions for ``tests/test_torch_spmd.py`` and
``tests/test_torch_faults.py``: what each spawned rank
of a ``'data'`` world runs (``repro_torch.distributed.mesh.spawn``). They
import no JAX (a rank imports this module, not the test file) and write
their results to ``out_dir/rank<r>.pt``, which the test reads back.
"""
import os
from typing import Dict, List, Sequence
from unittest import mock

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.straggler import Uniform
from repro_torch.kernels import bucketed_reduce
from repro_torch.models import load_jax_params
from repro_torch.train import loop as tloop
from repro_torch.train import supervisor


def stack_case(seed: int, w: int, p: int):
    """A [W, P] f32 stack, a [W] mask with some rows off and a [2] tail,
    from ``seed``: the same on every rank."""
    rng = np.random.RandomState(seed)
    grads = rng.randn(w, p).astype(np.float32)
    mask = rng.rand(w) < 0.7
    mask[0] = True
    tail = rng.randn(2).astype(np.float32)
    return grads, mask, tail


def _reduce_cases(rank: int, world: int, cases: Sequence) -> List[Dict]:
    """``reduce_then_psum`` over the world on this rank's rows of each
    case (its tail: the case's times ``rank + 1``), counting the
    all-reduces it issues and their sizes."""
    sizes: List[int] = []
    all_reduce = bucketed_reduce.dist.all_reduce

    def counted(t, *args, **kw):
        sizes.append(t.numel())
        return all_reduce(t, *args, **kw)

    bucketed_reduce.dist.all_reduce = counted
    out = []
    try:
        for seed, w, p, bucket, n in cases:
            grads, mask, tail = stack_case(seed, w, p)
            local = w // world
            rows = slice(rank * local, (rank + 1) * local)
            del sizes[:]
            red, tail_out = bucketed_reduce.reduce_then_psum(
                torch.from_numpy(grads[rows]), torch.from_numpy(mask[rows]),
                n, bucket=bucket, tail=torch.from_numpy(tail * (rank + 1)),
                use_kernel=False, group=torch.distributed.group.WORLD)
            out.append(dict(red=red.clone(), tail=tail_out.clone(),
                            sizes=list(sizes)))
    finally:
        bucketed_reduce.dist.all_reduce = all_reduce
    return out


def _trainer(cfg, params):
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    if params is not None:
        load_jax_params(tr.model, params)
        tr.reset_optimizer_state()
    return tr


def _state(res) -> Dict:
    return dict(params={k: v.detach().clone() for k, v in res.params.items()},
                ema={k: v.clone() for k, v in res.ema.items()},
                metrics=list(res.metrics), sim_time=res.sim_time)


def mesh_rank(rank: int, device, out_dir: str, params, reduce_cases,
              runs: Dict, resume_cfg, resume_at: int, resume_to: int
              ) -> None:
    """One rank: the reduce cases, then each of ``runs`` ({name: (cfg,
    steps)}) from ``params`` (a JAX param tree of numpy arrays), then the
    resume case: ``resume_cfg`` run to ``resume_at`` (its checkpoint
    cadence writes there), a new trainer restored from it and run to
    ``resume_to``."""
    world = torch.distributed.get_world_size()
    out = {"reduce": _reduce_cases(rank, world, reduce_cases)}
    for name, (cfg, steps) in runs.items():
        out[name] = _state(_trainer(cfg, params).run(steps))
    _trainer(resume_cfg, params).run(resume_at)
    tr = tloop.Trainer(resume_cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.reset_optimizer_state()
    tr.restore_checkpoint()
    out["resume_step"] = tr.step
    out["resume"] = _state(tr.run(resume_to - resume_at))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def chaos_rank(rank: int, device, out_dir: str, params, cfg,
               steps: int) -> None:
    """One rank of a faulted run: ``cfg``'s chaos plan over ``steps`` steps
    from ``params``, then a rescale to 3 workers, which shrinks the data
    axis (its ``mesh_data`` and whether this rank idles are kept)."""
    inj = faults.build_injector(cfg.faults, num_steps=cfg.total_steps,
                                num_workers=cfg.aggregation.total_workers)
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu",
                       injector=inj)
    tr.init_state()
    load_jax_params(tr.model, params)
    tr.reset_optimizer_state()
    res = tr.run(steps)
    out = dict(_state(res), recovery_log=res.recovery_log)
    tr.rescale(3)
    out.update(mesh_data=tr.cfg.execution.mesh_data, idle=tr._idle,
               workers=tr.cfg.aggregation.total_workers)
    torch.save(out, os.path.join(out_dir, f"chaos{rank}.pt"))



def shrink_rank(rank: int, device, out_dir: str, params, cfg) -> None:
    """One rank of a supervised run whose chaos plan takes the live
    workers below N: the rescale shrinks the ``'data'`` axis and the freed
    rank idles through the rest (checkpoints, a preemption and the
    restore included). From ``params``; the rank's state, log, final
    ``mesh_data`` and idle flag go to ``out_dir/shrink<r>.pt``."""
    built = []

    class Trainer(tloop.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append(self)

        def init_state(self, seed=None):
            super().init_state(seed)
            load_jax_params(self.model, params)
            self.reset_optimizer_state()

    with mock.patch.object(supervisor, "Trainer", Trainer):
        res = supervisor.run_supervised(cfg, latency=Uniform(1.0, 2.0),
                                        device="cpu")
    tr = built[-1]
    out = dict(_state(res), recovery_log=res.recovery_log, steps=res.steps,
               mesh_data=tr.cfg.execution.mesh_data, idle=tr._idle)
    torch.save(out, os.path.join(out_dir, f"shrink{rank}.pt"))
