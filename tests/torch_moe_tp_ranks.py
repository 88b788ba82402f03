"""Rank functions for ``tests/test_torch_moe_tp.py``: what each spawned rank
of a ``1 x 2`` mesh runs (``repro_torch.distributed.mesh.spawn``). They
import no JAX (a rank imports this module, not the test file) and write
their results to ``out_dir/rank<r>.pt``, which the test reads back.
"""
import contextlib
import os
from typing import Dict, List

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.straggler import Uniform
from repro_torch.data import synthetic_lm
from repro_torch.distributed import mesh, tp
from repro_torch.models import get_model, load_jax_params, moe
from repro_torch.serve import ServeEngine
from repro_torch.train import loop as tloop

ENGINE_KW = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
                 clock="virtual")
MOE_INPUTS_KEPT = 4          # the first MoE inputs of a run kept for the test


@contextlib.contextmanager
def moe_inputs(kept: List[torch.Tensor]):
    """Keep a copy of the rows handed to ``moe.moe_apply`` (its first
    ``MOE_INPUTS_KEPT`` calls outside a ``torch.func`` transform, whose
    tensors cannot leave it)."""
    orig = moe.moe_apply

    def apply(params, cfg, x, capacity_factor):
        if (len(kept) < MOE_INPUTS_KEPT
                and not torch._C._are_functorch_transforms_active()):
            kept.append(x.detach().clone())
        return orig(params, cfg, x, capacity_factor)

    moe.moe_apply = apply
    try:
        yield kept
    finally:
        moe.moe_apply = orig


def with_prefix(global_batch, model_cfg):
    """``global_batch`` of a synthetic pipeline (the port's or the JAX
    package's), each step's batch given ``model_cfg``'s prefix of
    precomputed embeddings, seeded by the step (a vlm run's batches)."""
    def batch(data_cfg, step):
        out = dict(global_batch(data_cfg, step))
        out["prefix_embeds"] = np.random.RandomState(1000 + step).randn(
            out["tokens"].shape[0], model_cfg.num_prefix_embeds,
            model_cfg.d_model).astype(np.float32)
        return out
    return batch


@contextlib.contextmanager
def prefix_batches(model_cfg):
    """The port's synthetic pipeline's batches given a prefix
    (``with_prefix``)."""
    orig = synthetic_lm.global_batch
    synthetic_lm.global_batch = with_prefix(orig, model_cfg)
    try:
        yield
    finally:
        synthetic_lm.global_batch = orig


def _serve(arch: str, params, int8: bool, trace, device, size) -> Dict:
    cfg = configs.get_smoke_config(arch)
    model = load_jax_params(get_model(cfg, device=device), params)
    before = (tp.all_reduces, tp.all_gathers)
    with moe_inputs([]) as kept:
        eng = ServeEngine(cfg, model, mesh_model=size, cache_int8=int8,
                          device=device, **ENGINE_KW)
        rep = eng.run(trace)
    return dict(tokens=rep.tokens_by_rid(), plan=eng.tp_plan,
                kv_heads=eng.pool_cfg.kv_heads, moe_inputs=kept,
                all_reduces=tp.all_reduces - before[0],
                all_gathers=tp.all_gathers - before[1])


def _train(cfg, params, steps: int) -> Dict:
    """A run from the JAX parameters ``params``: its metrics, the full
    parameters and EMA (the sharded leaves all-gathered over the model
    group), the split dimensions and local shapes, the local values of the
    replicated leaves and of their optimizer state, and the first MoE
    inputs. A vlm config's batches carry a prefix (``prefix_batches``)."""
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    load_jax_params(tr.model, params)
    tr.reset_optimizer_state()
    vlm = cfg.model.family == "vlm"
    with moe_inputs([]) as kept, (prefix_batches(cfg.model) if vlm
                                  else contextlib.nullcontext()):
        res = tr.run(steps)
    dims = dict(tr.model.tp_dims)
    local = {k: v.detach().clone() for k, v in res.params.items()}
    return dict(
        params={k: v.clone() for k, v in tr._full(local).items()},
        ema={k: v.clone() for k, v in tr._full(res.ema).items()},
        metrics=list(res.metrics), sim_time=res.sim_time, dims=dims,
        local_shapes={k: tuple(v.shape) for k, v in local.items()},
        replicated={k: v for k, v in local.items() if dims[k] is None},
        opt_replicated={s: {k: v.clone() for k, v in sub.items()
                            if dims[k] is None}
                        for s, sub in tr.opt_state.items()},
        moe_inputs=kept)


def moe_tp_rank(rank: int, device, out_dir: str, serve_cases: Dict,
                train_runs: Dict) -> None:
    """One rank: each of ``serve_cases`` ({name: (arch, JAX params, int8,
    trace)}) served at ``mesh_model`` = the world's size, then each of
    ``train_runs`` ({name: (config, JAX params, steps)})."""
    size = torch.distributed.get_world_size()
    out: Dict = {"model_index": mesh.model_index()}
    for name, (arch, params, int8, trace) in serve_cases.items():
        out[name] = _serve(arch, params, int8, trace, device, size)
    for name, (cfg, params, steps) in train_runs.items():
        out[name] = _train(cfg, params, steps)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
