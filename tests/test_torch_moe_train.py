"""The MoE family's trainer, checkpoints and CLIs against the JAX package,
on the CPU (the module, model, decode and paged engine are
``test_torch_moe.py``'s).

Parameters come from the JAX ``init`` (seed 0's, the trainers') and cross
by ``load_jax_params``. The smoke config at the full config's capacity
factor 1.25 (drops happen), remat full.

* ``run_experiment`` (backup 3 + 1, 4 steps, RMSProp eps 1e-3 for the
  reason ``test_torch_train.py`` gives) on sim against the JAX sim Trainer
  (capacity reckoned over the whole ``[W * b, S]`` batch) and on spmd at
  ``grad_batch`` 0 and 1 against the JAX spmd Trainer (capacity per
  worker): masks, ``selected`` and ``sim_time`` equal, losses, aux,
  params and EMA within rtol 2e-4 / atol 2e-5; checkpoints resume across
  packages both ways.
* The training CLI (``--arch qwen2-moe-a2.7b --smoke``, spmd) prints the
  JAX CLI's step line (loss within 2e-4); the serve CLI's request rows
  (paged engine) and token rows (``--toy``) equal the JAX CLI's on the
  same parameters.
* ``ServeEngine``, ``build_spmd_step`` and the trainer build at
  ``mesh_model=2`` on an MoE config (a world of 2 in this process, the
  ``fake`` backend; the spawned runs are ``test_torch_moe_tp.py``'s).
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import serve as jserve_cli
from repro.launch import train as jtrain_cli
from repro.train import loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.distributed import spmd_engine as tspmd
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import from_jax_tree, get_model, load_jax_params
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.serve import ServeEngine
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from torch_moe_common import (ARCH, jax_params, jitted_jax_init,  # noqa: F401
                              one_torch_thread, smoke_jcfg)
from torch_parity import fake_world_of_two  # noqa: F401 (fixture)
from torch_parity import port_config

TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


# ---------------------------------------------------------------------------
# The trainer on both backends, checkpoints across packages
# ---------------------------------------------------------------------------


def _train_jcfg(backend, directory, *, grad_batch=0, every=0, steps=4):
    return jbase.TrainConfig(
        model=dataclasses.replace(smoke_jcfg(1.25), remat="full"),
        shape=jbase.ShapeConfig("t", 16, 2 * 4, "train"),
        aggregation=jbase.AggregationConfig(strategy="backup", num_workers=3,
                                            backup_workers=1),
        # eps 1e-3 for the reason test_torch_train.py gives
        optimizer=jbase.OptimizerConfig(name="rmsprop_momentum",
                                        learning_rate=0.005, eps=1e-3,
                                        scale_lr_with_workers=True,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, use_kernel=True,
                                        grad_batch=grad_batch),
        seed=0, total_steps=steps, log_every=1)


def _port_cfg(jcfg):
    cfg = port_config(jcfg)
    # use_kernel=True asks for the backup_reduce CUDA kernel; the port's
    # auto rule (None) takes its plain twin on the CPU
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four-step runs from the JAX init (seed 0's, the trainers'): JAX sim
    and spmd, the port's sim and spmd at grad_batch 0 and 1; the sim runs
    checkpoint at steps 2 and 4."""
    params = jax_params(_train_jcfg("sim", "").model, 0)
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, params)
        self.reset_optimizer_state()

    root = tmp_path_factory.mktemp("moe_train")
    out = {"root": root}
    mp = pytest.MonkeyPatch()
    mp.setattr(tloop.Trainer, "init_state", init_state)
    try:
        for backend in ("sim", "spmd"):
            every = 2 if backend == "sim" else 0
            out["jax", backend] = jloop.run_experiment(
                _train_jcfg(backend, root / f"jax_{backend}", every=every))
        out["torch", "sim"] = tloop.run_experiment(_port_cfg(
            _train_jcfg("sim", root / "torch_sim", every=2)), device="cpu")
        for gb in (0, 1):
            out["torch", f"spmd gb{gb}"] = tloop.run_experiment(_port_cfg(
                _train_jcfg("spmd", root / f"torch_spmd{gb}",
                            grad_batch=gb)), device="cpu")
    finally:
        mp.undo()
    return out


def _np(v) -> np.ndarray:
    return v.detach().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _assert_state_close(params, ema, jparams, jema):
    for got, want in ((params, jparams), (ema, jema)):
        want = from_jax_tree(want)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_allclose(_np(v), np.asarray(want[k]),
                                       rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("run", ["sim", "spmd gb0", "spmd gb1"])
def test_run_experiment_matches_jax(runs, run):
    jres = runs["jax", run.split()[0]]
    tres = runs["torch", run]
    assert tres.steps == jres.steps == 4
    for key in ("selected", "sim_time", "lr"):
        assert [m[key] for m in tres.metrics] == \
            [m[key] for m in jres.metrics]
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose([m[key] for m in tres.metrics],
                                   [m[key] for m in jres.metrics],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert all(m["aux_loss"] > 0 for m in tres.metrics)
    _assert_state_close(tres.params, tres.ema, jres.params, jres.ema)


def test_jax_checkpoint_resumes_in_the_port(runs):
    tr = tloop.Trainer(_port_cfg(_train_jcfg("sim",
                                             runs["root"] / "jax_sim")),
                       device="cpu")
    tr.reset_optimizer_state()
    tr.restore_checkpoint(2)
    res = tr.run(2)
    jres = runs["jax", "sim"]
    assert tr.step == 4 and res.sim_time == jres.sim_time
    _assert_state_close(res.params, res.ema, jres.params, jres.ema)


def test_port_checkpoint_resumes_in_jax(runs):
    tdir = runs["root"] / "torch_sim"
    assert tckpt.available_steps(str(tdir)) == [2, 4]
    tr = jloop.Trainer(_train_jcfg("sim", tdir))
    tr.restore_checkpoint(2)
    res = tr.run(2)
    jres = runs["jax", "sim"]
    assert res.sim_time == jres.sim_time
    _assert_state_close(from_jax_tree(res.params), from_jax_tree(res.ema),
                        jres.params, jres.ema)


# ---------------------------------------------------------------------------
# The CLIs against the JAX CLIs
# ---------------------------------------------------------------------------


_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) sim\s+(\S+)s "
                   r"selected (\d+)")


def test_train_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """``--arch qwen2-moe-a2.7b --smoke`` on spmd, the port starting from
    the JAX CLI's init: the same step lines (loss within 2e-4)."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--seq", "8",
            "--batch-per-worker", "1", "--workers", "3", "--backups", "1",
            "--optimizer", "momentum", "--lr", "0.05", "--execution",
            "spmd"]
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):       # the JAX CLI's init, by key
        orig(self, seed)
        load_jax_params(self.model, jax_params(jconfigs.get_smoke_config(
            ARCH), self.cfg.seed))
        self.reset_optimizer_state()

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)
    lines = {}
    for tag, main in (("jax", jtrain_cli.main), ("torch", ttrain_cli.main)):
        extra = ["--device", "cpu"] if tag == "torch" else []
        main(argv + extra + ["--ckpt", str(tmp_path / tag)])
        lines[tag] = _LINE.findall(capsys.readouterr().out)
    assert len(lines["torch"]) == len(lines["jax"]) == 1
    for got, want in zip(lines["torch"], lines["jax"]):
        assert (got[0], got[2], got[3]) == (want[0], want[2], want[3])
        assert abs(float(got[1]) - float(want[1])) <= 2e-4


_RID = re.compile(r"^  rid=(\d+) (\[.*\])$", re.M)
_ROW = re.compile(r"^  (\[.*\])$", re.M)


@pytest.mark.parametrize("toy", [False, True], ids=["paged", "toy"])
def test_serve_cli_matches_jax_cli(toy, capsys, monkeypatch):
    """Both serve CLIs on the same JAX parameters (the JAX CLI's init by
    seed, loaded into the port's model): the paged engine's request rows,
    or the toy path's token rows (the port's prompt handed to the JAX
    CLI's ``jax.random.randint``), are equal."""
    # paged: every request arrives before the first admission (--rate
    # 1e12), so the admissions, and the order in which the requests
    # complete and print, depend on the decode steps alone, not on how fast
    # each CLI's wall clock reaches the arrivals
    argv = ["--arch", ARCH, "--seed", "3"] + (
        ["--toy", "--batch", "2", "--prompt-len", "4", "--tokens", "5"]
        if toy else ["--requests", "4", "--rate", "1e12", "--slots", "4",
                     "--max-prompt", "12", "--max-new", "6"])
    cfg = tconfigs.get_smoke_config(ARCH)
    params = jax_params(jconfigs.get_smoke_config(ARCH), 3)
    if toy:
        prompt = tserve_cli.toy_prompt(3, 2, 4, cfg.vocab_size)
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(prompt, jnp.int32))
    jserve_cli.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setattr(tserve_cli, "get_model", lambda c, device, generator:
                        load_jax_params(get_model(c, device=device), params))
    tserve_cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    pattern = _ROW if toy else _RID
    assert pattern.findall(got) == pattern.findall(want)
    assert len(pattern.findall(got)) == (2 if toy else 4)


def test_mesh_model_on_moe_is_not_ported(fake_world_of_two):
    """The three calls that refused ``mesh_model > 1`` on an MoE config
    until tensor parallelism of the MoE family was ported now build at
    ``mesh_model=2``, each holding a rank's slice: attention and the
    vocabulary split, the ``moe`` leaves whole."""
    cfg = tconfigs.get_smoke_config(ARCH)
    tmodel = get_model(cfg, device="cpu")
    full = {k: tuple(v.shape) for k, v in tmodel.named_parameters()}
    eng = ServeEngine(cfg, tmodel, device="cpu", mesh_model=2)
    assert eng.tp_plan.attn and eng.tp_plan.vocab
    assert eng.pool_cfg.kv_heads == cfg.num_kv_heads // 2
    opt_cfg = tconfigs.OptimizerConfig(name="momentum")
    opt = make_optimizer(opt_cfg, schedules.from_config(opt_cfg, 2))
    tmodel = get_model(cfg, device="cpu")
    step = tspmd.build_spmd_step(tmodel, opt, num_workers=2, n_aggregate=2,
                                 mesh_model=2, model_cfg=cfg)
    assert callable(step)
    local = {k: tuple(v.shape) for k, v in tmodel.named_parameters()}
    for k, shape in full.items():
        if ".moe." in k:
            assert local[k] == shape, k
    wq = "layers.0.attn.wq.w"
    assert local[wq] == (full[wq][0], full[wq][1] // 2)
    tcfg = _port_cfg(_train_jcfg("spmd", ""))
    tcfg = dataclasses.replace(tcfg, execution=dataclasses.replace(
        tcfg.execution, mesh_model=2))
    tr = tloop.Trainer(tcfg, device="cpu")
    assert tr.model.tp_slice[0].attn
