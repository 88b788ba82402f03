"""Mamba's SSD and hymba-1.5b (the hybrid family) against the JAX package,
on the CPU.

Inputs are made with numpy from a seed; parameters come from the JAX
``init`` and cross by ``load_jax_params`` (a bare SSD mixer's, by name).
f32, TF32 off (``torch_parity``), one intra-op thread. The smoke config: 2 layers, d_model 80, 5 / 1 heads of 16
(``q_per_kv`` 5), SSD state 4, window 8.

* ``ssd_project``, ``ssd_scan`` and ``ssd_chunked`` (a ragged S, chunks
  of 16 and 64, with and without a carried state) against the JAX
  functions, atol 1e-5; ``ssd_chunked`` against ``ssd_scan`` at the
  reference's own 1e-4.
* The configs, and the full config's parameter count (1,299,664,064)
  against the reference's.
* ``forward``, ``per_token_loss`` and its gradients, ``prefill``, atol
  1e-5 (gradients rtol 1e-4).
* ``decode_step`` stepped over 13 tokens (the ring of 8 wraps) against
  ``forward`` (the reference's own check, rtol / atol 2e-3) and against
  the JAX ``decode_step`` (fp and int8 caches, the SSD states too);
  ``greedy_generate`` against the JAX loop, fp and int8.
* ``run_experiment`` (remat full): backup 3 + 1 on sim, and on spmd at
  ``grad_batch`` 0 (``torch.func.vmap`` through the SSD and ``common.
  Remat``) and 1, against the JAX sim Trainer; async over 4 workers per
  arrival against the JAX async run: losses rtol 2e-4, ``sim_time``,
  ``selected`` and staleness equal, params and EMA within rtol 2e-4 /
  atol 2e-5; checkpoints cross both ways.
* The ``--toy`` serve CLI's token rows (int8 cache) equal the JAX CLI's.
"""
import dataclasses
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import serve as jserve_cli
from repro.models import get_model as jget_model
from repro.models import mamba as jmamba
from repro.models import registry as jregistry
from repro.train import loop as jloop
from repro.train import serve_step as jserve_step

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import (from_jax_tree, get_model, load_jax_params,
                                param_count)
from repro_torch.models import mamba as tmamba
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import serve_step as tserve_step
from torch_moe_common import one_torch_thread  # noqa: F401
from torch_parity import port_config, t2n

ARCH = "hymba-1.5b"
TOL = 1e-5
DECODE_TOL = 2e-3          # the reference's stepped-vs-forward check
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _jit_params(jcfg, seed):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jget_model(jcfg).init)(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params as numpy, the port's model on them)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = _jit_params(jcfg, 2)
    return jget_model(jcfg), params, load_jax_params(
        get_model(port_config(jcfg), device="cpu"), params)


# ---------------------------------------------------------------------------
# The SSD mixer
# ---------------------------------------------------------------------------


def _ssd_inputs(seed, b=2, s=45, h=3, p=8, n=4):
    rng = np.random.RandomState(seed)
    xv, bb, cc = (0.5 * rng.randn(b, s, h, k) for k in (p, n, n))
    dt = np.log1p(np.exp(rng.randn(b, s, h)))
    decay = np.exp(-dt * np.exp(0.3 * rng.randn(h)))
    d_skip = 1.0 + 0.1 * rng.randn(h, p)
    state = 0.5 * rng.randn(b, h, n, p)
    return [a.astype(np.float32) for a in (xv, bb, cc, dt, decay, d_skip,
                                           state)]


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_ssd_scan_and_chunked_match_jax(chunk, carried):
    *args, state = _ssd_inputs(1)
    st = state if carried else None
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    jst = None if st is None else jnp.asarray(st)
    tst = None if st is None else torch.from_numpy(st)
    jy, js = jmamba.ssd_scan(*jargs, state=jst)
    ty, ts = tmamba.ssd_scan(*targs, state=tst)
    np.testing.assert_allclose(t2n(ty), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(t2n(ts), np.asarray(js), rtol=0, atol=TOL)
    jy, js = jmamba.ssd_chunked(*jargs, state=jst, chunk=chunk)
    cy, cs = tmamba.ssd_chunked(*targs, state=tst, chunk=chunk)
    np.testing.assert_allclose(t2n(cy), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(t2n(cs), np.asarray(js), rtol=0, atol=TOL)
    # the chunked form against the scan, the reference's own tolerance
    np.testing.assert_allclose(t2n(cy), t2n(ty), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t2n(cs), t2n(ts), rtol=1e-4, atol=1e-4)


def test_ssd_project_and_apply_match_jax():
    cfg = jconfigs.get_smoke_config(ARCH)
    h, hd, n = cfg.num_heads, cfg.resolved_head_dim, cfg.ssm.state_dim
    params = jax.tree_util.tree_map(np.asarray, jmamba.ssd_init(
        jax.random.PRNGKey(3), cfg.d_model, h, hd, n))
    params["a_log"] = np.full((h,), 0.3, np.float32)      # not the init's 0
    params["dt_bias"] = np.linspace(-1, 1, h).astype(np.float32)
    module = tmamba.ssd_init(torch.Generator(), cfg.d_model, h, hd, n)
    with torch.no_grad():
        for name, prm in module.named_parameters():
            *path, leaf = name.split(".")
            node = params
            for key in path:
                node = node[key]
            prm.copy_(torch.from_numpy(np.array(node[leaf])))
    x = np.random.RandomState(4).randn(2, 11, cfg.d_model).astype(np.float32)
    want = jmamba.ssd_project(params, jnp.asarray(x), h, hd, n)
    got = tmamba.ssd_project(module, torch.from_numpy(x), h, hd, n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=0, atol=TOL)
    for chunked in (True, False):
        wy, ws = jmamba.ssd_apply(params, jnp.asarray(x), h, hd, n,
                                  chunked=chunked)
        gy, gs = tmamba.ssd_apply(module, torch.from_numpy(x), h, hd, n,
                                  chunked=chunked)
        np.testing.assert_allclose(t2n(gy), np.asarray(wy), rtol=0, atol=TOL)
        np.testing.assert_allclose(t2n(gs), np.asarray(ws), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# Config, parameter count, the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_reference(getter):
    j = getattr(jconfigs, getter)(ARCH)
    t = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.family == "hybrid" and t.q_per_kv == 5


def test_param_count_matches_reference():
    """At full width the reference's count (``repro.models.registry.
    param_count``), on the smoke config its function."""
    assert param_count(port_config(jconfigs.get_config(ARCH))) == \
        1_299_664_064
    smoke = jconfigs.get_smoke_config(ARCH)
    assert param_count(port_config(smoke)) == jregistry.param_count(smoke)


def _batch(cfg, b=2, s=20, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": labels}


def test_forward_loss_grads_and_prefill_match_jax(pair):
    jmodel, params, tmodel = pair
    tmodel.zero_grad()
    batch = _batch(jmodel.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(prm):
        per_tok, _ = jmodel.per_token_loss(prm, jbatch)
        return jnp.sum(per_tok), per_tok

    (_, jper_tok), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    per_tok, aux = tmodel.per_token_loss(batch)
    assert per_tok.shape == (2, 20) and float(aux) == 0.0
    np.testing.assert_allclose(t2n(per_tok), np.asarray(jper_tok), rtol=0,
                               atol=TOL)
    per_tok.sum().backward()
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(want) == sorted(dict(tmodel.named_parameters()))
    for k, prm in tmodel.named_parameters():
        g = want[k]
        np.testing.assert_allclose(t2n(prm.grad), g, rtol=1e-4,
                                   atol=1e-5 * (np.abs(g).max() + 1e-6),
                                   err_msg=k)
    tmodel.zero_grad()
    toks = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        logits = tmodel(toks)
        last = tmodel.prefill(toks)
    np.testing.assert_allclose(
        t2n(logits), np.asarray(jax.jit(jmodel.forward)(
            params, jnp.asarray(batch["tokens"]))), rtol=0, atol=TOL)
    np.testing.assert_array_equal(t2n(last), t2n(logits[:, -1]))


# ---------------------------------------------------------------------------
# Decode: the ring past the window, the carried SSD state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jstep(pair):
    return jax.jit(pair[0].decode_step)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_decode_step_matches_forward_and_jax(pair, jstep, int8):
    """13 tokens through a cache of 13 positions: each layer's ring holds
    the window's 8 and wraps; the stepped logits equal ``forward``'s (fp,
    the reference's 2e-3) and the JAX ``decode_step``'s, and so do the SSD
    states and the ring's K/V."""
    jmodel, params, tmodel = pair
    cfg = jmodel.cfg
    toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 13))
    dt = torch.int8 if int8 else None
    cache = tmodel.init_cache(2, 13, dt)
    assert cache["attn"][0]["k"].shape[1] == cfg.sliding_window
    jcache = jmodel.init_cache(2, 13, jnp.int8 if int8 else None)
    got, want = [], []
    for i in range(13):
        lg, cache = tmodel.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                       cache)
        jlg, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                            jcache)
        got.append(t2n(lg))
        want.append(np.asarray(jlg))
    assert cache["lens"] == 13
    tol = 1e-4 if int8 else TOL
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1), rtol=0,
                               atol=tol)
    for layer in range(cfg.num_layers):
        np.testing.assert_allclose(t2n(cache["ssd"][layer]),
                                   np.asarray(jcache["ssd"][layer]), rtol=0,
                                   atol=tol)
        for k, v in cache["attn"][layer].items():
            np.testing.assert_allclose(t2n(v),
                                       j2f(jcache["attn"][layer][k]),
                                       rtol=0, atol=0 if int8 else TOL,
                                       err_msg=k)
    if not int8:
        with torch.no_grad():
            full = tmodel(torch.from_numpy(toks))
        np.testing.assert_allclose(np.stack(got, 1), t2n(full),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)


def j2f(a):
    return np.asarray(a).astype(np.float32)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_greedy_generate_matches_jax(pair, jstep, int8):
    jmodel, params, tmodel = pair
    prompt = np.random.RandomState(6).randint(0, jmodel.cfg.vocab_size,
                                              (2, 5))
    got = tserve_step.greedy_generate(
        tmodel, torch.from_numpy(prompt), 6, 12,
        cache_dtype=torch.int8 if int8 else None)
    # the JAX loop has no cache dtype: the model it is handed makes the
    # cache (and steps through the jitted decode_step)
    jloop_model = types.SimpleNamespace(
        init_cache=lambda b, n: jmodel.init_cache(
            b, n, jnp.int8 if int8 else None), decode_step=jstep)
    want = jserve_step.greedy_generate(jloop_model, params,
                                       jnp.asarray(prompt, jnp.int32), 6, 12)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _train_jcfg(backend, directory, *, every=0, grad_batch=1, steps=4,
                strategy="backup"):
    agg = (jbase.AggregationConfig(strategy="async", num_workers=4)
           if strategy == "async" else
           jbase.AggregationConfig(strategy="backup", num_workers=3,
                                   backup_workers=1))
    return jbase.TrainConfig(
        model=dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                                  remat="full"),
        shape=jbase.ShapeConfig("t", 16, 2 * 4, "train"),
        aggregation=agg,
        optimizer=jbase.OptimizerConfig(
            name="momentum", learning_rate=0.05,
            scale_lr_with_workers=strategy != "async", ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, use_kernel=True,
                                        grad_batch=grad_batch),
        seed=0, total_steps=steps, log_every=1)


def _port_cfg(jcfg):
    cfg = port_config(jcfg)
    # use_kernel=True asks for the backup_reduce CUDA kernel; None takes
    # its plain twin on the CPU
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four-step runs from the JAX init (seed 0's): the JAX sim Trainer
    (checkpoints at 2 and 4) and an async run over 4 workers per arrival;
    the port's sim (checkpoints at 2 and 4), spmd at grad_batch 0 and 1
    (held to the JAX sim run: hymba has no aux loss, so each worker's
    mean equals its share of the sim loss) and async."""
    params = _jit_params(_train_jcfg("sim", "").model, 0)
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, params)
        self.reset_optimizer_state()
        if self.strategy.kind == "event":      # the workers' read copies
            self._init_event_state()

    root = tmp_path_factory.mktemp("hymba_train")
    out = {"root": root}
    mp = pytest.MonkeyPatch()
    mp.setattr(tloop.Trainer, "init_state", init_state)
    try:
        out["jax", "sim"] = jloop.run_experiment(
            _train_jcfg("sim", root / "jax_sim", every=2))
        out["jax", "async"] = jloop.run_experiment(
            _train_jcfg("sim", "", strategy="async"))
        out["torch", "sim"] = tloop.run_experiment(_port_cfg(
            _train_jcfg("sim", root / "torch_sim", every=2)), device="cpu")
        for gb in (0, 1):
            out["torch", f"spmd gb{gb}"] = tloop.run_experiment(_port_cfg(
                _train_jcfg("spmd", root / f"torch_spmd{gb}",
                            grad_batch=gb)), device="cpu")
        out["torch", "async"] = tloop.run_experiment(_port_cfg(
            _train_jcfg("sim", "", strategy="async")), device="cpu")
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


@pytest.mark.parametrize("run", ["sim", "spmd gb0", "spmd gb1", "async"])
def test_run_experiment_matches_jax(runs, run):
    jres = runs["jax", "async" if run == "async" else "sim"]
    tres = runs["torch", run]
    assert tres.steps == jres.steps == 4
    for key in ("selected", "sim_time", "lr", "staleness"):
        assert [m.get(key) for m in tres.metrics] == \
            [m.get(key) for m in jres.metrics]
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
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


def test_port_checkpoint_restores_in_jax(runs):
    """The port's step-4 checkpoint, read by the JAX Trainer, holds the
    JAX sim run's state (the SSD leaves stacked under ``blocks/ssd``)."""
    tdir = runs["root"] / "torch_sim"
    assert tckpt.available_steps(str(tdir)) == [2, 4]
    tr = jloop.Trainer(_train_jcfg("sim", tdir))
    tr.restore_checkpoint(4)
    assert tr.step == 4
    assert tr.params["blocks"]["ssd"]["a_log"].shape == (2, 5)
    jres = runs["jax", "sim"]
    _assert_state_close(from_jax_tree(tr.params), from_jax_tree(tr.ema),
                        jres.params, jres.ema)


# ---------------------------------------------------------------------------
# The toy serve CLI
# ---------------------------------------------------------------------------


_ROW = re.compile(r"^  (\[.*\])$", re.M)


def test_toy_serve_cli_matches_jax_cli(capsys, monkeypatch):
    """Both toy serve CLIs on the same JAX parameters (the JAX CLI's init
    by seed, loaded into the port's model) and prompt, with the int8
    cache, the ring wrapping (4 + 9 tokens past the window of 8): the
    token rows are equal."""
    argv = ["--arch", ARCH, "--seed", "3", "--toy", "--batch", "2",
            "--prompt-len", "4", "--tokens", "9", "--cache-int8"]
    cfg = tconfigs.get_smoke_config(ARCH)
    params = _jit_params(jconfigs.get_smoke_config(ARCH), 3)
    prompt = tserve_cli.toy_prompt(3, 2, 4, cfg.vocab_size)
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(prompt, jnp.int32))
    jserve_cli.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setattr(tserve_cli, "get_model", lambda c, device, generator:
                        load_jax_params(get_model(c, device=device), params))
    tserve_cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _ROW.findall(got) == _ROW.findall(want)
    assert len(_ROW.findall(got)) == 2
    assert got.split(" prefill ")[0] == want.split(" prefill ")[0]
