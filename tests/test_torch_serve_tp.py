"""Tensor-parallel serving (``ServeEngine(mesh_model=2)``) against one card
and the JAX engine.

* Over 2 spawned gloo ranks (``tests/torch_serve_tp_ranks.py``, one torch
  thread each), one spawn running every case: the qwen3 smoke with
  attention, the FFN and the vocabulary sharded, and the gemma3 smoke
  (kv = 1) with attention replicated and the FFN and the vocabulary
  sharded, each with fp and int8 pools. Both ranks' greedy tokens equal
  the port's ``mesh_model=1`` engine's and the JAX engine's on the same
  JAX parameters and trace; each rank's pool holds its kv heads.
* The reference's bar (``tests/test_serve_tp.py``): a checkpoint trained
  a few steps and restored through ``restore_params`` serves the same
  tokens at M = 2 and M = 1.
* Outside a world, ``mesh_model=2`` raises a ``ValueError`` naming the
  devices (ranks) it needs.
* The CLI at ``--mesh-model 2 --device cpu`` (spawned gloo ranks, rank 0
  prints) prints the one-process CLI's token rows, with ``tp=2``.
"""
import re

import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.serve import ServeEngine as JServeEngine

from repro_torch import configs as tconfigs
from repro_torch.configs import (AggregationConfig, CheckpointConfig,
                                 OptimizerConfig, ShapeConfig, TrainConfig)
from repro_torch.distributed import mesh
from repro_torch.launch import serve as tcli
from repro_torch.models import get_model, load_jax_params
from repro_torch.serve import ServeEngine, TraceConfig, make_trace
from repro_torch.train import loop as tloop

import torch_serve_tp_ranks as ranks

RANK_TIMEOUT_S = 120.0
ARCHS = ("qwen3-0.6b", "gemma3-1b")
CASES = [f"{arch}-{pool}" for arch in ARCHS for pool in ("fp", "int8")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the spawned ranks."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _trace(cfg, n=6, seed=3):
    return make_trace(TraceConfig(
        num_requests=n, rate=2.0, prompt_len_min=2, prompt_len_max=12,
        max_new_min=2, max_new_max=8, vocab=cfg.vocab_size, seed=seed))


def _one_card(arch, params, int8, trace):
    cfg = tconfigs.get_smoke_config(arch)
    model = load_jax_params(get_model(cfg, device="cpu"), params)
    return ServeEngine(cfg, model, device="cpu", cache_int8=int8,
                       **ranks.ENGINE_KW).run(trace).tokens_by_rid()


def _jax(arch, params, int8, trace):
    return JServeEngine(jconfigs.get_smoke_config(arch), params,
                        cache_int8=int8, **ranks.ENGINE_KW).run(
        trace).tokens_by_rid()


def _train_checkpoint(directory):
    """The reference test's run on the port: 3 sim steps of the qwen3
    smoke, full sync over 2 workers, momentum, then a checkpoint."""
    cfg = TrainConfig(
        model=tconfigs.get_smoke_config("qwen3-0.6b"),
        shape=ShapeConfig("tiny", 16, 8, "train"),
        aggregation=AggregationConfig(strategy="full_sync", num_workers=2),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                  scale_lr_with_workers=False),
        checkpoint=CheckpointConfig(directory=str(directory),
                                    every_steps=100),
        log_every=10)
    tr = tloop.Trainer(cfg, device="cpu")
    tr.init_state()
    tr.run(3)
    tr.save_checkpoint()


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """One spawn of 2 gloo ranks serving every case and the checkpoint;
    the inputs, and every rank's results."""
    root = tmp_path_factory.mktemp("serve_tp")
    cases = {}
    for arch in ARCHS:
        params = jget_model(jconfigs.get_smoke_config(arch)).init(
            jax.random.PRNGKey(1))
        trace = _trace(tconfigs.get_smoke_config(arch))
        for pool in ("fp", "int8"):
            cases[f"{arch}-{pool}"] = (arch, params, pool == "int8", trace)
    _train_checkpoint(root / "ck")
    ck_trace = _trace(tconfigs.get_smoke_config("qwen3-0.6b"), n=4, seed=0)
    mesh.spawn(ranks.serve_rank, 1, "cpu",
               args=(str(root), cases, str(root / "ck"), "qwen3-0.6b",
                     ck_trace),
               mesh_model=2, threads=1, timeout_s=RANK_TIMEOUT_S)
    return dict(cases=cases, root=root, ck_trace=ck_trace,
                ranks=[torch.load(root / f"rank{r}.pt", weights_only=False)
                       for r in range(2)])


@pytest.mark.parametrize("case", CASES)
def test_tp_tokens_equal_one_card_and_jax(tp_run, case):
    arch, params, int8, trace = tp_run["cases"][case]
    want = _one_card(arch, params, int8, trace)
    assert want == _jax(arch, params, int8, trace)
    assert len(want) == len(trace)
    cfg = tconfigs.get_smoke_config(arch)
    for r, got in enumerate(tp_run["ranks"]):
        res = got[case]
        assert got["model_index"] == r
        assert res["tokens"] == want, (case, r)
        plan = res["plan"]
        assert plan.ffn and plan.vocab
        # gemma3's single kv head keeps attention replicated
        assert plan.attn == (arch == "qwen3-0.6b")
        assert res["kv_heads"] == cfg.num_kv_heads // (2 if plan.attn
                                                        else 1)
        assert res["local_heads"] == cfg.num_heads // (2 if plan.attn
                                                        else 1)
        assert res["all_reduces"] > 0 and res["all_gathers"] > 0


def test_tp_checkpoint_serves_token_identically(tp_run):
    """A checkpoint trained 3 steps, restored through ``restore_params``,
    serves the same tokens at ``mesh_model`` 2 and 1."""
    from repro_torch.serve import restore_params
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    model, manifest = restore_params(str(tp_run["root"] / "ck"), cfg,
                                     device="cpu")
    assert manifest["step"] == 3
    want = ServeEngine(cfg, model, device="cpu", **ranks.ENGINE_KW).run(
        tp_run["ck_trace"]).tokens_by_rid()
    assert len(want) == 4
    for got in tp_run["ranks"]:
        assert got["ckpt"]["step"] == 3
        assert got["ckpt"]["plan"].any
        assert got["ckpt"]["tokens"] == want


def test_tp_engine_requires_devices():
    """Outside a world of 2 ranks ``mesh_model=2`` is a clear error, as in
    the reference (which counts devices)."""
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    model = get_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        ServeEngine(cfg, model, mesh_model=2, device="cpu",
                    **ranks.ENGINE_KW)


_ROW = re.compile(r"rid=(\d+) (\[.*\])")


def test_cli_mesh_model_2_on_cpu(capfd):
    """``--mesh-model 2 --device cpu`` spawns 2 gloo ranks; rank 0 alone
    prints, with ``tp=2``, and its token rows equal the one-process
    CLI's on the same seed."""
    argv = ["--device", "cpu", "--requests", "4", "--rate", "1000",
            "--max-new", "6"]
    out = {}
    for tag, extra in (("one", []), ("tp", ["--mesh-model", "2"])):
        tcli.main(argv + extra)
        out[tag] = capfd.readouterr().out
    assert out["tp"].count("[serve] qwen3-0.6b policy=continuous") == 1
    assert " tp=2 " in out["tp"] and " tp=" not in out["one"]
    rows = {t: dict(_ROW.findall(o)) for t, o in out.items()}
    assert rows["tp"] and rows["tp"] == rows["one"]
