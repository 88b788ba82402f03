"""The MoE family under tensor parallelism (the spmd engine's and the serve
engine's ``'model'`` axis) against one card and the JAX package, on the
CPU.

One spawn of 2 gloo ranks (``tests/torch_moe_tp_ranks.py``, one torch
thread each) runs every case at mesh 1 x 2:

* ``ServeEngine(mesh_model=2)`` on qwen2-moe's smoke config, fp and int8
  pools: both ranks' greedy tokens equal the port's one-card engine's and
  the JAX engine's on the same JAX parameters and trace; attention and
  the vocabulary shard, the pool holds a rank's kv heads.
* Training qwen2-moe's smoke config, backup 6 + 2 on the spmd engine at
  ``grad_batch`` 1 and 0, from the JAX init: losses, aux, params and EMA
  within rtol 2e-4 / atol 2e-5 of the JAX spmd Trainer (the MoE's aux
  loss is each worker's own on the spmd engine and one global-batch term
  on sim, so the spmd Trainer is the oracle), ``sim_time`` and
  ``selected`` equal; the ``moe`` leaves stay whole, and they, their
  optimizer state and every MoE input (training and serving) are bit-
  identical across the model group; the checkpoint rank 0 writes
  restores in the JAX Trainer and on one card.
* deepseek-v2-lite's smoke config (MLA, a dense first layer, 8 experts):
  the dense MLP and the vocabulary split, MLA and the MoE whole, the run
  equal to the JAX spmd Trainer's.
* internvl2's smoke config with prefix batches (the vlm prefix under TP:
  replicated, only the token ids through the vocab-sharded lookup):
  attention, the MLP and the vocabulary split, the run equal to the JAX
  spmd Trainer's on the same prefix batches and to the port's one-card
  run.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core.straggler import Uniform as JUniform
from repro.data import synthetic_lm as jdata
from repro.serve import ServeEngine as JServeEngine
from repro.train import loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.core.straggler import Uniform
from repro_torch.distributed import mesh
from repro_torch.models import from_jax_tree, get_model, load_jax_params
from repro_torch.serve import ServeEngine, TraceConfig, make_trace
from repro_torch.train import loop as tloop

import torch_moe_tp_ranks as ranks
from torch_moe_common import (jax_params, jitted_jax_init,  # noqa: F401
                              one_torch_thread)
from torch_parity import port_config

QWEN, DEEPSEEK, VLM = "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", \
    "internvl2-2b"
RTOL, ATOL = 2e-4, 2e-5
STEPS = 4
RANK_TIMEOUT_S = 180.0
POOLS = ("fp", "int8")
TRAIN_RUNS = ("qwen_gb1", "qwen_gb0", "deepseek_gb0")


def _jcfg(arch, directory="", *, backend="spmd", mesh_model=1,
          grad_batch=0, every=0):
    """Backup 6 + 2 over 16 sequences of 16 tokens, momentum and an EMA."""
    return jbase.TrainConfig(
        model=jconfigs.get_smoke_config(arch),
        shape=jbase.ShapeConfig("t", 16, 16, "train"),
        aggregation=jbase.AggregationConfig(strategy="backup", num_workers=6,
                                            backup_workers=2),
        optimizer=jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                        scale_lr_with_workers=False,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, mesh_model=mesh_model,
                                        grad_batch=grad_batch),
        seed=0, total_steps=STEPS, log_every=1)


def _tcfg(jcfg):
    cfg = port_config(jcfg)
    # use_kernel=True asks for the backup_reduce CUDA kernel; None takes
    # its plain twin on the CPU
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


def _trace(cfg):
    return make_trace(TraceConfig(
        num_requests=6, rate=2.0, prompt_len_min=2, prompt_len_max=12,
        max_new_min=2, max_new_max=8, vocab=cfg.vocab_size, seed=3))


@pytest.fixture(scope="module")
def params():
    """The JAX init at seed 0 (the trainers') of the smoke configs."""
    return {arch: jax_params(jconfigs.get_smoke_config(arch), 0)
            for arch in (QWEN, DEEPSEEK, VLM)}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory, params):
    """One spawn of 2 gloo ranks serving and training every case."""
    root = tmp_path_factory.mktemp("moe_tp")
    trace = _trace(tconfigs.get_smoke_config(QWEN))
    serve = {pool: (QWEN, params[QWEN], pool == "int8", trace)
             for pool in POOLS}
    train = {
        f"qwen_gb{gb}": (_tcfg(_jcfg(
            QWEN, root / f"qwen_gb{gb}", mesh_model=2, grad_batch=gb,
            every=STEPS if gb == 1 else 0)), params[QWEN], STEPS)
        for gb in (1, 0)}
    train["deepseek_gb0"] = (_tcfg(_jcfg(DEEPSEEK, mesh_model=2)),
                             params[DEEPSEEK], STEPS)
    train["vlm_gb0"] = (_tcfg(_jcfg(VLM, mesh_model=2)), params[VLM], STEPS)
    mesh.spawn(ranks.moe_tp_rank, 1, "cpu", args=(str(root), serve, train),
               mesh_model=2, threads=1, timeout_s=RANK_TIMEOUT_S)
    return dict(root=root, trace=trace,
                ranks=[torch.load(root / f"rank{r}.pt", weights_only=False)
                       for r in range(2)])


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX spmd Trainer's runs (one device): what the TP runs are held
    to. internvl2's batches carry the ranks' prefix
    (``ranks.with_prefix``)."""
    out = {}
    for arch in (QWEN, DEEPSEEK, VLM):
        mp = pytest.MonkeyPatch()
        if arch == VLM:
            mp.setattr(jdata, "global_batch", ranks.with_prefix(
                jdata.global_batch, jconfigs.get_smoke_config(VLM)))
        try:
            tr = jloop.Trainer(_jcfg(arch), latency=JUniform(1.0, 2.0))
            tr.init_state()
            out[arch] = tr.run(STEPS)
        finally:
            mp.undo()
    return out


def _np(v) -> np.ndarray:
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _close_state(got_params, got_ema, want):
    for part, have, ref in (("params", got_params, want.params),
                            ("ema", got_ema, want.ema)):
        ref = from_jax_tree(ref)
        assert sorted(have) == sorted(ref)
        for k, v in have.items():
            np.testing.assert_allclose(_np(v), np.asarray(ref[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{part} {k}")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", POOLS)
def test_tp_engine_tokens_equal_one_card_and_jax(tp_run, params, pool):
    int8 = pool == "int8"
    cfg = tconfigs.get_smoke_config(QWEN)
    model = load_jax_params(get_model(cfg, device="cpu"), params[QWEN])
    want = ServeEngine(cfg, model, device="cpu", cache_int8=int8,
                       **ranks.ENGINE_KW).run(tp_run["trace"]).tokens_by_rid()
    assert want == JServeEngine(jconfigs.get_smoke_config(QWEN), params[QWEN],
                                cache_int8=int8, **ranks.ENGINE_KW).run(
        tp_run["trace"]).tokens_by_rid()
    assert len(want) == len(tp_run["trace"])
    for r, rk in enumerate(tp_run["ranks"]):
        got = rk[pool]
        assert rk["model_index"] == r
        assert got["tokens"] == want, r
        assert got["plan"].attn and got["plan"].vocab
        assert got["kv_heads"] == cfg.num_kv_heads // 2
        assert got["all_reduces"] > 0 and got["all_gathers"] > 0


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", TRAIN_RUNS)
def test_tp_trainer_matches_jax(tp_run, jax_runs, run):
    want = jax_runs[DEEPSEEK if run.startswith("deepseek") else QWEN]
    for rk in tp_run["ranks"]:
        got = rk[run]
        assert got["sim_time"] == want.sim_time
        for key in ("selected", "lr"):
            assert [m[key] for m in got["metrics"]] == \
                [m[key] for m in want.metrics]
        for key in ("loss", "aux_loss"):
            np.testing.assert_allclose([m[key] for m in got["metrics"]],
                                       [m[key] for m in want.metrics],
                                       rtol=RTOL, atol=ATOL)
        assert all(m["aux_loss"] > 0 for m in got["metrics"])
        _close_state(got["params"], got["ema"], want)


@pytest.mark.parametrize("run", TRAIN_RUNS)
def test_tp_split_and_moe_bit_identical(tp_run, run):
    """What splits: attention (qwen2-moe; MLA stays whole), the dense
    MLP (deepseek's first layer) and the vocabulary. The ``moe`` leaves
    never do; they, their optimizer state, every replicated leaf and the
    MoE inputs are the same bits on both ranks."""
    first, second = (rk[run] for rk in tp_run["ranks"])
    dims = first["dims"]
    moe_leaves = [k for k in dims if ".moe." in k]
    assert moe_leaves and all(dims[k] is None for k in moe_leaves)
    assert dims["embed.embedding"] == 0
    if run.startswith("deepseek"):
        assert dims["layers.0.mlp.w_up.w"] == 1
        assert dims["layers.0.mlp.w_down.w"] == 0
        assert dims["lm_head.w"] == 1
        assert all(d is None for k, d in dims.items() if ".attn." in k)
    else:
        assert dims["layers.0.attn.wq.w"] == 1
    full = {k: tuple(v.shape) for k, v in first["params"].items()}
    for k, d in dims.items():
        want = list(full[k])
        if d is not None:
            want[d] //= 2
        assert first["local_shapes"][k] == tuple(want), k
    assert sorted(first["replicated"]) == sorted(second["replicated"])
    for k, v in first["replicated"].items():
        assert torch.equal(second["replicated"][k], v), k
    for s, sub in first["opt_replicated"].items():
        assert set(moe_leaves) <= set(sub)
        for k, v in sub.items():
            assert torch.equal(second["opt_replicated"][s][k], v), (s, k)
    if run == "qwen_gb1":           # gb 0's MoE inputs lie inside vmap
        assert len(first["moe_inputs"]) == ranks.MOE_INPUTS_KEPT
    for a, b in zip(first["moe_inputs"], second["moe_inputs"]):
        assert torch.equal(a, b)
    for k, v in first["params"].items():
        assert torch.equal(second["params"][k], v), k


@pytest.mark.parametrize("pool", POOLS)
def test_tp_serving_moe_inputs_bit_identical(tp_run, pool):
    first, second = (rk[pool]["moe_inputs"] for rk in tp_run["ranks"])
    assert len(first) == ranks.MOE_INPUTS_KEPT
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_tp_checkpoint_restores_in_jax_and_on_one_card(tp_run, jax_runs):
    """The step-4 checkpoint rank 0 wrote at mesh 1 x 2 (the model group
    gathering the sharded leaves) holds the JAX run's state, read by the
    JAX Trainer and by the port on one card."""
    want = jax_runs[QWEN]
    directory = tp_run["root"] / "qwen_gb1"
    jtr = jloop.Trainer(_jcfg(QWEN, directory), latency=JUniform(1.0, 2.0))
    jtr.restore_checkpoint(STEPS)
    assert jtr.step == STEPS
    _close_state(from_jax_tree(jtr.params), from_jax_tree(jtr.ema), want)
    one = tloop.Trainer(_tcfg(_jcfg(QWEN, directory)),
                        latency=Uniform(1.0, 2.0), device="cpu")
    one.reset_optimizer_state()
    one.restore_checkpoint(STEPS)
    assert one.step == STEPS and not hasattr(one.model, "tp_dims")
    _close_state(one.params, one.ema, want)


def test_tp_vlm_prefix_equals_one_card(tp_run, params, jax_runs):
    """internvl2 at mesh 1 x 2 with prefix batches: every group splits, and
    the run equals the JAX spmd Trainer's and the port's one-card run on
    the same batches."""
    jwant = jax_runs[VLM]
    cfg = _tcfg(_jcfg(VLM))
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    load_jax_params(tr.model, params[VLM])
    tr.reset_optimizer_state()
    with ranks.prefix_batches(cfg.model):
        want = tr.run(STEPS)
    for rk in tp_run["ranks"]:
        got = rk["vlm_gb0"]
        dims = got["dims"]
        assert dims["layers.0.attn.wq.w"] == 1
        assert dims["layers.0.mlp.w_up.w"] == 1
        assert dims["embed.embedding"] == 0 and dims["lm_head.w"] == 1
        assert got["sim_time"] == want.sim_time
        assert [m["selected"] for m in got["metrics"]] == \
            [m["selected"] for m in want.metrics]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in want.metrics],
                                   rtol=RTOL, atol=ATOL)
        for k, v in want.params.items():
            np.testing.assert_allclose(_np(got["params"][k]), _np(v),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert got["sim_time"] == jwant.sim_time
        assert [m["selected"] for m in got["metrics"]] == \
            [m["selected"] for m in jwant.metrics]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   [m["loss"] for m in jwant.metrics],
                                   rtol=RTOL, atol=ATOL)
        _close_state(got["params"], got["ema"], jwant)
