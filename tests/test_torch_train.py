"""The port's training path against the JAX reference, on the CPU.

Parameters come from the JAX model's ``init`` and cross by
``load_jax_params``; the optimizer state and the EMA are re-initialized
from them. qwen3 smoke config (f32, 2 layers).

* ``per_token_loss`` and its gradients vs ``jax.value_and_grad``, with
  ``remat`` "none", "full" and "dots", and through the chunked cross entropy
  (its switch lowered so the smoke vocab takes it): atol 1e-5.
  ``chunked_cross_entropy`` alone over ragged multi-chunk input: the same.
* The ``sim`` step with two microbatches (``_microbatch_split``, f32
  accumulation) against the reference's, one step: atol 1e-5.
* ``run_experiment``, backup 6+2, batch 2 per worker, seq 16, 4 steps, on
  the ``sim`` and the ``spmd`` backend, each against the same JAX run (the
  JAX ``spmd`` run at mesh 1x1 with ``use_kernel=True``: the Pallas kernel
  in interpret mode): ``selected`` and ``sim_time`` equal, loss within
  rtol 1e-5, final params and EMA within atol 1e-5.
* Checkpoints across packages: a JAX checkpoint at step 2 resumes in the
  port and a port checkpoint resumes in JAX; both end within atol 1e-5 of
  the uninterrupted 4-step JAX run.
* The trainer refuses a ``'data'`` or ``'model'`` axis without its world
  of ranks (naming ``mesh.spawn``) and a ``grad_batch`` that does not
  divide the local workers (listing the divisors); the options that later
  slices brought run, or raise the reference's own error: the device
  straggler backend at chunk size 1, faults (the recovery log equal to
  JAX's), an event strategy on the spmd backend (the reference's warning,
  then a sim run equal to JAX's), a plugin without spmd support, and
  ``kill_worker_at`` (held to JAX). The CLI refuses only ``--platform`` by
  name; ``--trace`` / ``--metrics`` write what the JAX CLI writes (span
  names and tree, metric names and counts), and the flags that later
  slices brought run or fail as the JAX CLI does; it runs with ``--device
  cpu`` and raises without a card otherwise.
"""
import contextlib
import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.models import common as jcommon
from repro.models import get_model as jget_model
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.launch import train as jcli
from repro.train import loop as jloop
from repro.train import train_step as jtrain_step

from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch.launch import train as tcli
from repro_torch.models import (TransformerLM, common as tcommon,
                                from_jax_tree, load_jax_params, to_jax_tree)
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import train_step as ttrain_step
from torch_parity import port_config

ARCH = "qwen3-0.6b"
ATOL = 1e-5


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


def _loss_inputs(vocab, b=4, s=16, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                        # masked positions
    return toks, labels


def _jax_loss_and_grads(jmodel, params, toks, labels):
    valid = jnp.asarray(labels >= 0, jnp.float32)

    def f(p):
        per_tok, _ = jmodel.per_token_loss(
            p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        return jnp.sum(per_tok * valid) / jnp.sum(valid), per_tok

    (val, per_tok), grads = jax.value_and_grad(f, has_aux=True)(params)
    return float(val), np.asarray(per_tok), from_jax_tree(grads)


@pytest.mark.parametrize("remat,chunked", [("none", False), ("full", False),
                                           ("full", True), ("dots", False)])
def test_loss_and_grads_match(remat, chunked, monkeypatch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), remat=remat)
    jmodel = jget_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    toks, labels = _loss_inputs(jcfg.vocab_size)
    jval, jper_tok, jgrads = _jax_loss_and_grads(jmodel, params, toks, labels)
    if chunked:       # the smoke vocab x seq is far below the real switch
        monkeypatch.setattr(ttransformer, "CHUNKED_CE_THRESHOLD", 0)
    tmodel = load_jax_params(TransformerLM(port_config(jcfg), device="cpu"),
                             params)
    per_tok, aux = tmodel.per_token_loss({"tokens": toks, "labels": labels})
    valid = torch.from_numpy(labels >= 0).float()
    val = torch.sum(per_tok * valid) / torch.sum(valid)
    val.backward()
    assert float(aux) == 0.0
    np.testing.assert_allclose(float(val.detach()), jval, rtol=1e-6)
    np.testing.assert_allclose(per_tok.detach().numpy(), jper_tok, atol=ATOL)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[name]),
                                   atol=ATOL, err_msg=name)


def test_chunked_cross_entropy_matches():
    rng = np.random.RandomState(2)
    x = rng.randn(20, 8).astype(np.float32)
    w = (0.5 * rng.randn(8, 48)).astype(np.float32)
    labels = rng.randint(0, 40, (20,)).astype(np.int32)

    def jf(x_, w_):
        return jnp.sum(jcommon.chunked_cross_entropy(
            x_, w_, jnp.asarray(labels), 40, chunk=8) * jnp.arange(20.0))

    jv, (jgx, jgw) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                            jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    loss = tcommon.chunked_cross_entropy(tx, tw, torch.from_numpy(labels),
                                         40, chunk=8)
    tv = torch.sum(loss * torch.arange(20.0))
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), atol=ATOL)


def test_microbatched_sim_step_matches_jax():
    jcfg = jconfigs.get_smoke_config(ARCH)
    jmodel = jget_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    ocfg = jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                 scale_lr_with_workers=False)
    kw = dict(num_workers=4, n_aggregate=3, ema_decay=0.9,
              num_microbatches=2)
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, 512, (8, 8)).astype(np.int32),
             "labels": rng.randint(0, 512, (8, 8)).astype(np.int32)}
    mask = np.array([1, 0, 1, 1], bool)
    jopt_ = jopt.make_optimizer(ocfg, jsched.from_config(ocfg))
    jstep = jtrain_step.build_train_step(jmodel, jopt_, **kw)
    jp, _, jema, jm = jstep(params, jopt_.init(params), params,
                            jnp.asarray(0, jnp.int32),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jnp.asarray(mask))
    tmodel = load_jax_params(TransformerLM(port_config(jcfg), device="cpu"),
                             params)
    topt_ = topt.make_optimizer(port_config(ocfg),
                                tsched.from_config(port_config(ocfg)))
    named = dict(tmodel.named_parameters())
    tema = {k: v.detach().clone() for k, v in named.items()}
    tm = ttrain_step.build_train_step(tmodel, topt_, **kw)(
        topt_.init(named), tema, topt_.scalars(0),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(mask))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    for got, want in ((named, jp), (tema, jema)):
        want = from_jax_tree(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(want[k]), atol=ATOL,
                                       rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# The trainer, both backends, and checkpoints across packages
# ---------------------------------------------------------------------------


def _jax_cfg(backend, directory, *, steps=4, every=0):
    return jbase.TrainConfig(
        model=dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                                  remat="full"),
        shape=jbase.ShapeConfig("t", 16, 2 * 8, "train"),
        aggregation=jbase.AggregationConfig(strategy="backup", num_workers=6,
                                            backup_workers=2),
        # the paper's optimizer with eps 1e-3: at the default 1e-8 the
        # first step's g / sqrt(0.1 g^2 + eps) multiplies the gradients'
        # rounding near g = 0 by up to lr / sqrt(eps) = 300 (the optimizer
        # itself is held to the reference on equal gradients in
        # test_torch_core.py)
        optimizer=jbase.OptimizerConfig(name="rmsprop_momentum",
                                        learning_rate=0.005, eps=1e-3,
                                        scale_lr_with_workers=True,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, use_kernel=True,
                                        grad_batch=1),
        seed=0, total_steps=steps, log_every=1)


def _port_cfg(jcfg):
    cfg = port_config(jcfg)
    # use_kernel=True means the CUDA kernel, which the CPU refuses: the
    # port's auto rule (None) takes the plain twin here
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


@pytest.fixture(scope="module")
def jax_params():
    return jget_model(_jax_cfg("sim", ".").model).init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_params):
    """Four-step runs per (package, backend); the sim runs checkpoint at
    steps 2 and 4. The port's ``Trainer.init_state`` loads the JAX init
    (the optimizer and the EMA re-initialized from it) for these runs
    only."""
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, jax_params)
        self.reset_optimizer_state()

    root = tmp_path_factory.mktemp("train")
    out = {"root": root}
    mp = pytest.MonkeyPatch()
    mp.setattr(tloop.Trainer, "init_state", init_state)
    try:
        for backend in ("sim", "spmd"):
            every = 2 if backend == "sim" else 0
            out["jax", backend] = jloop.run_experiment(
                _jax_cfg(backend, root / f"jax_{backend}", every=every))
            out["torch", backend] = tloop.run_experiment(_port_cfg(
                _jax_cfg(backend, root / f"torch_{backend}", every=every)),
                device="cpu")
    finally:
        mp.undo()
    return out


def _assert_state_close(tres, jparams, jema):
    for got, want in ((tres.params, jparams), (tres.ema, jema)):
        want = from_jax_tree(want)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]),
                                       atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("backend", ["sim", "spmd"])
def test_run_experiment_matches_jax(runs, backend):
    jres, tres = runs["jax", backend], runs["torch", backend]
    assert tres.steps == jres.steps == 4
    assert [m["selected"] for m in tres.metrics] == \
        [m["selected"] for m in jres.metrics]
    assert [m["sim_time"] for m in tres.metrics] == \
        [m["sim_time"] for m in jres.metrics]
    assert tres.sim_time == jres.sim_time
    assert tres.mean_selected == jres.mean_selected
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics], rtol=1e-5)
    np.testing.assert_allclose([m["lr"] for m in tres.metrics],
                               [m["lr"] for m in jres.metrics], rtol=0)
    _assert_state_close(tres, jres.params, jres.ema)


def test_jax_checkpoint_resumes_in_the_port(runs):
    jdir = runs["root"] / "jax_sim"
    assert tckpt.available_steps(str(jdir)) == [2, 4]
    tr = tloop.Trainer(_port_cfg(_jax_cfg("sim", jdir)), device="cpu")
    tr.reset_optimizer_state()
    tr.restore_checkpoint(2)
    assert tr.step == 2
    res = tr.run(2)
    jres = runs["jax", "sim"]
    assert res.sim_time == jres.sim_time
    _assert_state_close(res, jres.params, jres.ema)


def test_port_checkpoint_resumes_in_jax(runs):
    tdir = runs["root"] / "torch_sim"
    assert tckpt.verify(str(tdir), 2) and tckpt.find_good_step(str(tdir)) == 4
    tr = jloop.Trainer(_jax_cfg("sim", tdir))
    tr.restore_checkpoint(2)
    assert tr.step == 2
    res = tr.run(2)
    jres = runs["jax", "sim"]
    assert res.sim_time == jres.sim_time
    for a, b in ((res.params, jres.params), (res.ema, jres.ema)):
        for k, v in from_jax_tree(a).items():
            np.testing.assert_allclose(np.asarray(v),
                                       np.asarray(from_jax_tree(b)[k]),
                                       atol=ATOL, rtol=0, err_msg=k)


def test_checkpoint_bf16_roundtrip_and_corruption(tmp_path):
    named = {"layers.0.w": torch.randn(3, 2).to(torch.bfloat16),
             "layers.1.w": torch.randn(3, 2).to(torch.bfloat16),
             "embed.embedding": torch.randn(4, 2)}
    tree = {"params": to_jax_tree(named)}
    tckpt.save(str(tmp_path), 3, tree)
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert z["params/seg_dense/w"].dtype == np.dtype("V2")
    template = {"params": to_jax_tree(
        {k: torch.empty_like(v, device="meta") for k, v in named.items()})}
    back, manifest = tckpt.restore(str(tmp_path), template)
    assert manifest["step"] == 3
    for k, v in from_jax_tree(back["params"]).items():
        assert torch.equal(v, named[k])
    tckpt.save(str(tmp_path), 5, tree)
    with open(tmp_path / "step_00000005" / "arrays.npz", "r+b") as f:
        f.seek(-64, os.SEEK_END)
        f.write(b"\0" * 64)
    assert not tckpt.verify(str(tmp_path), 5)
    assert tckpt.find_good_step(str(tmp_path)) == 3
    _, manifest = tckpt.restore(str(tmp_path), template)
    assert manifest["step"] == 3


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change,err,match", [
    (dict(straggler_backend="device"), ValueError, "requires chunk_size > 1"),
    (dict(faults=jbase.FaultConfig(spec="crash@2:w1,slow@1:w3:d2")), None,
     "worker_crash"),
    (dict(execution=jbase.ExecutionConfig(backend="spmd", mesh_data=2,
                                          grad_batch=1)),
     RuntimeError, "mesh.spawn"),
    (dict(execution=jbase.ExecutionConfig(backend="spmd", mesh_model=2,
                                          grad_batch=1)),
     RuntimeError, "mesh.spawn"),
    (dict(execution=jbase.ExecutionConfig(backend="spmd", grad_batch=3)),
     ValueError, r"0 \(vmap all\) or one of \[1, 2, 4, 8\]"),
    (dict(execution=jbase.ExecutionConfig(backend="spmd", grad_batch=1,
                                          use_kernel=True)),
     ValueError, "needs the card"),
    (dict(aggregation=jbase.AggregationConfig(strategy="async",
                                              num_workers=8),
          execution=jbase.ExecutionConfig(backend="spmd", grad_batch=1)),
     None, "no SPMD support"),
    (dict(execution=jbase.ExecutionConfig(backend="tpu_pod")), ValueError,
     "unknown execution backend"),
])
def test_trainer_refuses_later_slices(tmp_path, change, err, match,
                                      jax_params, monkeypatch):
    """The refusals that stand, the reference's own errors, and (``err``
    None) the options that now run: each against the same JAX run from
    the same init (the log of a faulted run bit-identical; the async run
    on the spmd backend warns as the reference does and runs sim)."""
    jcfg = dataclasses.replace(_jax_cfg("sim", tmp_path / "jax"), **change)
    cfg = port_config(dataclasses.replace(_jax_cfg("sim", tmp_path),
                                          **change))
    if err is not None:
        with pytest.raises(err, match=match):
            tloop.Trainer(cfg, device="cpu")
        return
    cfg = _port_cfg(cfg)
    _load_jax_init(monkeypatch, jax_params)
    with pytest.warns(UserWarning, match=match) if "execution" in change \
            else _no_warning():
        want = jloop.run_experiment(jcfg)
        got = tloop.run_experiment(cfg, device="cpu")
    assert got.recovery_log == want.recovery_log
    assert [(m["step"], m["selected"], m["sim_time"]) for m in got.metrics] \
        == [(m["step"], m["selected"], m["sim_time"]) for m in want.metrics]
    np.testing.assert_allclose([m["loss"] for m in got.metrics],
                               [m["loss"] for m in want.metrics], rtol=1e-5)
    _assert_state_close(got, want.params, want.ema)


def _load_jax_init(monkeypatch, jax_params):
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, jax_params)
        self.reset_optimizer_state()
        if self.strategy.kind == "event":
            self._init_event_state()

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)


@contextlib.contextmanager
def _no_warning():
    yield


def test_spmd_refuses_a_strategy_it_does_not_take(tmp_path, monkeypatch):
    """A mask strategy that opts out of the spmd engine
    (``spmd_supported = False``) warns with the reference's text and runs
    on the sim backend: the same run as asking for sim."""
    from repro_torch.core import coordination, registry

    class SimOnly(coordination.BackupWorkers):
        spmd_supported = False

    monkeypatch.setitem(registry._BUILDERS, "sim_only",
                        lambda cfg: SimOnly(6, 2))
    agg = jbase.AggregationConfig(strategy="sim_only", num_workers=6,
                                  backup_workers=2)
    cfg = _port_cfg(dataclasses.replace(_jax_cfg("spmd", tmp_path),
                                        aggregation=agg))
    assert not registry.supports_spmd(registry.get_strategy(cfg.aggregation))
    assert tloop.falls_back_to_sim(cfg)
    with pytest.warns(UserWarning, match="'sim_only' has no SPMD support"):
        tr = tloop.Trainer(cfg, device="cpu")
    assert not tr._spmd
    tr.init_state()
    sim = tloop.Trainer(dataclasses.replace(cfg, execution=dataclasses.replace(
        cfg.execution, backend="sim")), device="cpu")
    sim.init_state()
    a, b = tr.run(2), sim.run(2)
    assert a.metrics == b.metrics
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k


def test_kill_injection_is_refused(tmp_path, jax_params, monkeypatch):
    """``kill_worker_at`` (a list and a scalar) against the JAX run from
    the same init: the two kills leave 6 live workers of 8, N = 6, so the
    protocol absorbs them."""
    kills = {1: [3], 2: 5}
    _load_jax_init(monkeypatch, jax_params)
    want = jloop.run_experiment(_jax_cfg("sim", tmp_path / "jax"),
                                kill_worker_at=kills)
    tr = tloop.Trainer(_port_cfg(_jax_cfg("sim", tmp_path)), device="cpu")
    tr.init_state()
    got = tr.run(4, kill_worker_at=kills)
    assert list(np.nonzero(tr.sim.dead)[0]) == [3, 5] and got.restarts == 0
    assert [(m["selected"], m["sim_time"]) for m in got.metrics] == \
        [(m["selected"], m["sim_time"]) for m in want.metrics]
    _assert_state_close(got, want.params, want.ema)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

_CLI = ["--smoke", "--steps", "4", "--seq", "8", "--batch-per-worker", "1",
        "--workers", "3", "--backups", "1", "--ckpt-every", "2"]


@pytest.mark.parametrize("backend", ["sim", "spmd"])
def test_cli_runs_on_cpu_and_resumes(tmp_path, capsys, backend):
    argv = _CLI + ["--device", "cpu", "--ckpt", str(tmp_path),
                   "--execution", backend]
    tcli.main(argv)
    out = capsys.readouterr().out
    assert "[train] step     4 loss" in out and "done: 4 steps" in out
    assert tckpt.latest_step(str(tmp_path)) == 4
    tcli.main(argv + ["--resume"])
    out = capsys.readouterr().out
    assert "resumed at step 4" in out and "done: 8 steps" in out


@pytest.mark.parametrize("extra", [
    ["--trace", "t.json"], ["--metrics", "m.jsonl"], ["--platform", "gpu"],
])
def test_cli_refuses_deferred_flags(tmp_path, capsys, extra):
    """``--platform`` stays refused by name. ``--trace`` and ``--metrics``
    run through both CLIs (files under ``tmp_path``): the same printed
    trace / metrics line shape, the same span-name multiset and span tree
    shape, the same metric names and step counts."""
    if extra[0] == "--platform":
        with pytest.raises(SystemExit):
            tcli.main(_CLI + ["--device", "cpu", "--ckpt", str(tmp_path)]
                      + extra)
        err = capsys.readouterr().err
        assert "not ported" in err and \
            "PyTorch picks the card by --device" in err
        return
    got = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        path = str(tmp_path / f"{tag}_{extra[1]}")
        argv = _CLI + ["--ckpt", str(tmp_path / tag), extra[0], path]
        main(argv + (["--device", "cpu"] if tag == "torch" else []))
        out = capsys.readouterr().out
        assert f"[train] {extra[0][2:]}: {path} (" in out
        assert re.search(r"\[train\] wall \S+s \(ckpt_s \S+s data_s \S+s "
                         r"dispatch_s \S+s\)", out)
        if extra[0] == "--trace":
            events = tobs.load_trace(path)["traceEvents"]

            def shape(n):
                return (n["name"], tuple(shape(c) for c in n["children"]))

            got[tag] = (sorted(e["name"] for e in events),
                        [shape(r) for r in tobs.span_tree(events)])
        else:
            rows = tobs.load_jsonl(path)
            got[tag] = ([r["name"] for r in rows],
                        [r.get("count") for r in rows],
                        [r["value"] for r in rows
                         if r["name"] == "train/steps"])
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("extra", [
    ["--straggler-backend", "device"],
    ["--straggler-backend", "device", "--chunk-size", "2"],
    ["--strategy", "dynamic_backup"],
    ["--strategy", "dynamic_backup", "--latency-source", "measured",
     "--dynamic-window", "8"],
    ["--strategy", "async", "--execution", "spmd"],
    ["--strategy", "softsync", "--straggler-backend", "device"],
    ["--dynamic-window", "8"], ["--strategy", "softsync", "--faults", "x"],
    ["--latency-source", "measured"], ["--faults", "crash@2:w1"],
    ["--fault-seed", "1"], ["--supervise"], ["--max-restarts", "2"],
    ["--faults", "crash@1:w0", "--straggler-backend", "device"],
    ["--strategy", "dynamic_backup", "--straggler-backend", "device"],
])
def test_cli_runs_the_flags_of_later_slices(tmp_path, capsys, extra):
    """The flags the port used to refuse: each runs, or fails with the JAX
    CLI's own error (a usage error with its message, or the trainer's
    exception with its text)."""
    def outcome(main, argv):
        try:
            main(argv)
        except SystemExit as e:
            return "usage", capsys.readouterr().err.splitlines()[-1]
        except (ValueError, NotImplementedError) as e:
            capsys.readouterr()
            return type(e).__name__, str(e)
        return "ran", capsys.readouterr().out

    want = outcome(jcli.main, _CLI + ["--ckpt", str(tmp_path / "jax")]
                   + extra)
    got = outcome(tcli.main, _CLI + ["--device", "cpu", "--ckpt",
                                     str(tmp_path / "torch")] + extra)
    assert got[0] == want[0]
    if got[0] != "ran":
        assert got[1].replace("repro_torch.launch.train",
                              "repro.launch.train") == want[1]
        return
    assert "done: 4 steps" in got[1]
    rec = [ln for ln in got[1].splitlines() if "recovery:" in ln]
    assert rec == [ln for ln in want[1].splitlines() if "recovery:" in ln]


def test_cli_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(_CLI + ["--ckpt", str(tmp_path)])
