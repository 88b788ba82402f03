"""Rank functions for ``tests/test_torch_tp.py``: what each spawned rank of
a ``('data', 'model')`` mesh runs (``repro_torch.distributed.mesh.
spawn``). They import no JAX (a rank imports this module, not the test
file) and write their results to ``out_dir/rank<r>.pt``, which the test
reads back.
"""
import os
import warnings
from typing import Dict

import numpy as np
import torch

from repro_torch.core.straggler import Uniform
from repro_torch.distributed import mesh, tp
from repro_torch.models import load_jax_params
from repro_torch.train import loop as tloop

F_G_WORKERS = 3               # the vmapped worker dimension of the f/g cases
VALID_VOCAB = 13              # the f/g cross entropy's valid ids (of 16)


def fg_inputs(seed: int) -> Dict[str, np.ndarray]:
    """The f/g cases' inputs, from ``seed``: activations ``x`` [2, 5, 8],
    an embedding table [16, 8] with ids [2, 5], logits [2, 5, 16] over a
    vocabulary of 13 valid ids with labels, cotangents, and a stack of
    ``F_G_WORKERS`` of each for the vmapped cases (a gradient there is
    that of the output's dot product with the cotangent)."""
    rng = np.random.RandomState(seed)
    k = F_G_WORKERS
    return dict(
        x=rng.randn(2, 5, 8).astype(np.float32),
        cot=rng.randn(2, 5, 8).astype(np.float32),
        table=rng.randn(16, 8).astype(np.float32),
        ids=rng.randint(0, 16, (2, 5)),
        logits=(3 * rng.randn(2, 5, 16)).astype(np.float32),
        labels=rng.randint(0, 13, (2, 5)),
        ce_cot=rng.randn(2, 5).astype(np.float32),
        xs=rng.randn(k, 2, 5, 8).astype(np.float32),
        tables=rng.randn(k, 16, 8).astype(np.float32),
        idss=rng.randint(0, 16, (k, 2, 5)),
        logitss=(3 * rng.randn(k, 2, 5, 16)).astype(np.float32),
        labelss=rng.randint(0, 13, (k, 2, 5)),
        cots=rng.randn(k, 2, 5, 8).astype(np.float32),
        ce_cots=rng.randn(k, 2, 5).astype(np.float32))


def _fg_cases(group, index: int, size: int, seed: int) -> Dict:
    """psum_fwd, psum_bwd, sharded_embed and sharded_cross_entropy over
    ``group`` (this rank at ``index`` of ``size``), values and gradients,
    each also under ``torch.func.vmap(grad)``."""
    a = {k: torch.from_numpy(v) for k, v in fg_inputs(seed).items()}
    ctx = tp.TPContext(group, index, vocab=True)
    v = a["table"].shape[0] // size
    rows = slice(index * v, (index + 1) * v)
    out = {}

    # psum_fwd: each rank adds (index + 1) x; the gradient passes through
    x = (a["x"] * (index + 1)).requires_grad_()
    y = tp.psum_fwd(x, group)
    (g,) = torch.autograd.grad((y * a["cot"]).sum(), x)
    out["psum_fwd"] = (y.detach(), g)
    # psum_bwd: identity; the gradient is the sum of the ranks' cotangents
    x = a["x"].clone().requires_grad_()
    y = tp.psum_bwd(x, group)
    (g,) = torch.autograd.grad((y * a["cot"] * (index + 1)).sum(), x)
    out["psum_bwd"] = (y.detach(), g)
    # the same two under vmap(grad) over the worker dimension: (gradient,
    # output) per worker
    out["psum_fwd_vmap"] = _vmap_grad(
        lambda t: tp.psum_fwd(t * (index + 1), group), a["xs"], a["cots"])
    out["psum_bwd_vmap"] = _vmap_grad(
        lambda t: tp.psum_bwd(t, group), a["xs"], a["cots"] * (index + 1))

    # the vocab-sharded embedding against the whole table
    table = a["table"][rows].clone().requires_grad_()
    e = tp.sharded_embed(table, a["ids"], ctx)
    (g,) = torch.autograd.grad((e * a["cot"]).sum(), table)
    out["embed"] = (e.detach(), g)
    out["embed_vmap"] = _vmap_grad(
        lambda t, i: tp.sharded_embed(t, i, ctx),
        a["tables"][:, rows].contiguous(), a["cots"], a["idss"])

    # the vocab-sharded cross entropy against the whole logits
    logits = a["logits"][..., rows].clone().requires_grad_()
    ce = tp.sharded_cross_entropy(logits, a["labels"], VALID_VOCAB, ctx)
    (g,) = torch.autograd.grad((ce * a["ce_cot"]).sum(), logits)
    out["ce"] = (ce.detach(), g)
    out["ce_vmap"] = _vmap_grad(
        lambda t, lab: tp.sharded_cross_entropy(t, lab, VALID_VOCAB, ctx),
        a["logitss"][..., rows].contiguous(), a["ce_cots"], a["labelss"])
    return out


def _vmap_grad(fn, xs, cots, *rest):
    """Per worker (the leading dimension), the gradient of ``fn``'s output
    dotted with its cotangent with respect to the first input, and the
    output: ``torch.func.vmap`` of ``grad`` (the engine's form)."""
    def loss(x, c, *r):
        y = fn(x, *r)
        return (y * c).sum(), y

    return torch.func.vmap(torch.func.grad(loss, has_aux=True))(
        xs, cots, *rest)


def _trainer(cfg, params):
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    if params is not None:
        load_jax_params(tr.model, params)
        tr.reset_optimizer_state()
    return tr


def _state(tr, res) -> Dict:
    """A run's metrics and its full parameters and EMA (the sharded leaves
    all-gathered over the model group), with this rank's local shapes of
    the sharded leaves and the local values of the replicated ones."""
    dims = getattr(tr.model, "tp_dims", {})
    local = {k: v.detach().clone() for k, v in res.params.items()}
    return dict(
        params={k: v.clone() for k, v in tr._full(local).items()},
        ema={k: v.clone() for k, v in tr._full(res.ema).items()},
        metrics=list(res.metrics), sim_time=res.sim_time,
        local_shapes={k: tuple(v.shape) for k, v in local.items()},
        opt_shapes={s: {k: tuple(v.shape) for k, v in sub.items()}
                    for s, sub in tr.opt_state.items()},
        ema_shapes={k: tuple(v.shape) for k, v in res.ema.items()},
        replicated={k: v for k, v in local.items() if dims.get(k) is None},
        dims=dict(dims))


def tp_rank(rank: int, device, out_dir: str, params: Dict, runs: Dict,
            resume_cfg, resume_at: int, resume_to: int, fg_seed=None,
            rwkv=None) -> None:
    """One rank: the f/g cases (``fg_seed`` not None), each of ``runs``
    ({name: (cfg, steps)}) from ``params`` ({arch: JAX param tree}), the
    resume case (``resume_cfg`` to ``resume_at``, where its cadence writes
    a checkpoint, then a new trainer restored from it to ``resume_to``),
    and ``rwkv`` ((cfg, steps), its 'model' axis replicated with a
    warning)."""
    out: Dict = {"data_index": mesh.data_index(),
                 "model_index": mesh.model_index()}
    first = next(iter(runs.values()))[0].execution
    if fg_seed is not None:
        group = mesh.model_group(first.mesh_data, first.mesh_model)
        out["fg"] = _fg_cases(group, mesh.model_index(),
                              first.mesh_model, fg_seed)
    qwen = params["qwen3-0.6b"]
    for name, (cfg, steps) in runs.items():
        tr = _trainer(cfg, qwen)
        out[name] = _state(tr, tr.run(steps))
    _trainer(resume_cfg, qwen).run(resume_at)
    tr = tloop.Trainer(resume_cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.reset_optimizer_state()
    tr.restore_checkpoint()
    out["resume_step"] = tr.step
    out["resume"] = _state(tr, tr.run(resume_to - resume_at))
    if rwkv is not None:
        cfg, steps = rwkv
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tr = _trainer(cfg, params["rwkv6-1.6b"])
        out["rwkv_warnings"] = [str(w.message) for w in caught]
        out["rwkv"] = _state(tr, tr.run(steps))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
