"""Rank functions for ``tests/test_torch_serve_tp.py``: what each spawned
rank of a ``1 x M`` mesh runs (``repro_torch.distributed.mesh.spawn``). They
import no JAX (a rank imports this module, not the test file) and write
their results to ``out_dir/rank<r>.pt``, which the test reads back.
"""
import os
from typing import Dict

import torch

from repro_torch import configs
from repro_torch.distributed import mesh, tp
from repro_torch.models import get_model, load_jax_params
from repro_torch.serve import ServeEngine, restore_params

ENGINE_KW = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
                 clock="virtual")


def serve_rank(rank: int, device, out_dir: str, cases: Dict,
               ckpt_dir: str = "", ckpt_arch: str = "",
               ckpt_trace=None) -> None:
    """One rank: each of ``cases`` ({name: (arch, JAX param tree, int8,
    trace)}) served at ``mesh_model`` = the world's size, then, with
    ``ckpt_dir``, the checkpoint there restored through
    ``restore_params`` and served on ``ckpt_trace``. Records the tokens,
    the plan, the pool's kv heads and the collectives issued."""
    size = torch.distributed.get_world_size()
    out: Dict = {"model_index": mesh.model_index()}
    for name, (arch, params, int8, trace) in cases.items():
        cfg = configs.get_smoke_config(arch)
        model = load_jax_params(get_model(cfg, device=device), params)
        before = (tp.all_reduces, tp.all_gathers)
        eng = ServeEngine(cfg, model, mesh_model=size, cache_int8=int8,
                          device=device, **ENGINE_KW)
        rep = eng.run(trace)
        out[name] = dict(tokens=rep.tokens_by_rid(), plan=eng.tp_plan,
                         kv_heads=eng.pool_cfg.kv_heads,
                         local_heads=eng.model.cfg.num_heads,
                         all_reduces=tp.all_reduces - before[0],
                         all_gathers=tp.all_gathers - before[1])
    if ckpt_dir:
        cfg = configs.get_smoke_config(ckpt_arch)
        model, manifest = restore_params(ckpt_dir, cfg, device=device)
        eng = ServeEngine(cfg, model, mesh_model=size, device=device,
                          **ENGINE_KW)
        out["ckpt"] = dict(step=manifest["step"], plan=eng.tp_plan,
                           tokens=eng.run(ckpt_trace).tokens_by_rid())
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
