"""MLA and deepseek-v2-lite-16b against the JAX package, on the CPU.

Inputs are made with numpy from a seed; parameters come from the JAX
``init`` and cross by ``load_jax_params`` (or ``torch_parity.to_module``
for a bare attention subtree). f32, TF32 off (``torch_parity``). The smoke
config: 3 layers (a dense one, then 2 MoE of 8 experts top-2), d_model
64, 4 heads, kv_lora 32, rope 8, nope 16, v 16, capacity factor 8.

* ``mla_init`` (leaf names and shapes), ``_mla_qkv``, ``_mla_expand_kv``,
  ``mla_attend``, ``mla_init_cache`` and ``mla_decode`` against the JAX
  functions of those names, atol 1e-5, with the full-rank query and with
  the low-rank one (``q_lora_rank`` 16); above ``MLA_DENSE_MAX_LEN``
  tokens (lowered by the test) ``mla_attend``'s blocked path equals the
  dense one.
* The config and the full config's parameter counts (15,706,484,224,
  2,661,150,208 active) equal the reference's.
* ``per_token_loss`` and its gradients against ``jax.value_and_grad``,
  ``forward``; ``decode_step`` stepped over a prompt against ``forward``
  and the JAX ``decode_step``; an ``int8`` cache request gives bf16 latents
  whatever the model dtype, as in the reference; ``greedy_generate``'s
  tokens equal the JAX loop's, fp and int8.
* ``run_experiment`` (backup 3 + 1, remat full) on sim against the JAX sim
  Trainer and on spmd at ``grad_batch`` 0 and 1 against the JAX spmd
  Trainer: losses and aux rtol 2e-4, ``sim_time`` and ``selected`` equal,
  params and EMA within rtol 2e-4 / atol 2e-5; checkpoints cross both
  ways.
* ``ServeEngine`` refuses MLA with the reference's message (and so does
  the serve CLI without ``--toy``); the training CLI's step line and the
  toy serve CLI's token rows equal the JAX CLIs'.
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
from repro.models import attention as jattention
from repro.models import get_model as jget_model
from repro.models import registry as jregistry
from repro.serve.paged_model import supports_paged as jsupports_paged
from repro.train import loop as jloop
from repro.train import serve_step as jserve_step

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve_cli
from repro_torch.launch import train as ttrain_cli
from repro_torch.models import (from_jax_tree, get_model, load_jax_params,
                                param_count)
from repro_torch.models import attention as tattention
from repro_torch.serve import ServeEngine
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import serve_step as tserve_step
from torch_moe_common import (jax_params, jitted_jax_init,  # noqa: F401
                              one_torch_thread)
from torch_parity import port_config, t2n, to_module

ARCH = "deepseek-v2-lite-16b"
TOL = 1e-5
DECODE_TOL = 1e-4
# bf16 latents: the latent context is rounded to bf16 in both packages,
# by products that round in their own order
INT8_TOL = 2e-3
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _smoke(q_lora=0):
    cfg = jconfigs.get_smoke_config(ARCH)
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, q_lora_rank=q_lora))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params as numpy, the port's model on them)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = jax_params(jcfg, 2)
    return jget_model(jcfg), params, load_jax_params(
        get_model(port_config(jcfg), device="cpu"), params)


# ---------------------------------------------------------------------------
# Config and parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_reference(getter):
    j = getattr(jconfigs, getter)(ARCH)
    t = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.attention_kind == "mla" and t.moe.first_dense == 1


def test_param_counts_match_reference():
    """At full width the reference's counts (``repro.models.registry.
    param_count``, total and active), on the smoke config its function."""
    full = port_config(jconfigs.get_config(ARCH))
    assert param_count(full) == 15_706_484_224
    assert param_count(full, active_only=True) == 2_661_150_208
    smoke = jconfigs.get_smoke_config(ARCH)
    assert param_count(port_config(smoke)) == jregistry.param_count(smoke)


# ---------------------------------------------------------------------------
# The MLA functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[0, 16], ids=["q_full", "q_lora16"])
def mla(request):
    """(JAX config, port config, JAX MLA params as numpy, the port's module
    on them, x [2, 12, d], positions)."""
    jcfg = _smoke(request.param)
    params = jax.tree_util.tree_map(np.asarray, jattention.mla_init(
        jax.random.PRNGKey(3), jcfg))
    x = np.random.RandomState(4).randn(2, 12, jcfg.d_model).astype(
        np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(12), (2, 12)))
    return jcfg, port_config(jcfg), params, to_module(params), x, pos


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else
                   {path: tuple(v.shape)})
    return out


def test_mla_init_leaves_match_jax(mla):
    jcfg, tcfg, params, _, _, _ = mla
    module = tattention.mla_init(torch.Generator().manual_seed(0), tcfg)
    got = {k: tuple(v.shape) for k, v in module.named_parameters()}
    assert got == _leaves(params)
    assert ("wq_a.w" in got) == bool(jcfg.mla.q_lora_rank) != ("wq.w" in got)


def test_mla_qkv_and_expand_match_jax(mla):
    jcfg, tcfg, params, module, x, pos = mla
    want = jattention._mla_qkv(params, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tattention._mla_qkv(module, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos))
    assert got[3].shape == (2, 12, 1, jcfg.mla.qk_rope_dim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=0, atol=TOL)
    want = jattention._mla_expand_kv(params, jcfg, want[2])
    got = tattention._mla_expand_kv(module, tcfg, got[2])
    for g, w in zip(got, want):
        np.testing.assert_allclose(t2n(g), np.asarray(w), rtol=0, atol=TOL)


def test_mla_attend_matches_jax(mla):
    jcfg, tcfg, params, module, x, pos = mla
    want = jattention.mla_attend(params, jcfg, jnp.asarray(x),
                                 jnp.asarray(pos))
    got = tattention.mla_attend(module, tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)


def test_mla_decode_matches_jax(mla):
    """Every step's output and the latent cache it leaves; the cache holds
    only ``c_kv`` and ``k_rope``."""
    jcfg, tcfg, params, module, x, _ = mla
    jcache = jattention.mla_init_cache(jcfg, 2, 16, jnp.float32)
    cache = tattention.mla_init_cache(tcfg, 2, 16, torch.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()} == \
        {"c_kv": (2, 16, 32), "k_rope": (2, 16, 8)}
    jdecode = jax.jit(jattention.mla_decode, static_argnums=1)
    for i in range(x.shape[1]):
        want, jcache = jdecode(params, jcfg, jnp.asarray(x[:, i:i + 1]),
                               jcache, i)
        got, cache = tattention.mla_decode(module, tcfg,
                                           torch.from_numpy(x[:, i:i + 1]),
                                           cache, i)
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0,
                                   atol=TOL, err_msg=f"step {i}")
    for k in cache:
        np.testing.assert_allclose(t2n(cache[k]), np.asarray(jcache[k]),
                                   rtol=0, atol=TOL, err_msg=k)


def test_mla_attend_refuses_past_the_dense_length(mla, monkeypatch):
    """Past ``MLA_DENSE_MAX_LEN`` (lowered to 12 here) ``mla_attend`` runs
    the blocked core (chunks of 8, so 20 tokens cross blocks): its output
    equals the dense path's on the same input, and the JAX dense
    ``mla_attend``'s."""
    jcfg, tcfg, params, module, _, _ = mla
    x = np.random.RandomState(7).randn(2, 20, tcfg.d_model).astype(
        np.float32)
    pos = torch.arange(20).expand(2, 20)
    dense = tattention.mla_attend(module, tcfg, torch.from_numpy(x), pos)
    monkeypatch.setattr(tattention, "MLA_DENSE_MAX_LEN", 12)
    core = tattention.chunked_attention_core
    calls = []
    monkeypatch.setattr(tattention, "chunked_attention_core",
                        lambda *a, **k: calls.append(1) or core(
                            *a, **k, q_chunk=8, kv_chunk=8))
    got = tattention.mla_attend(module, tcfg, torch.from_numpy(x), pos)
    assert calls == [1]
    np.testing.assert_allclose(t2n(got), t2n(dense), rtol=0, atol=TOL)
    want = jattention.mla_attend(params, jcfg, jnp.asarray(x),
                                 jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# The model: loss and gradients, decode, the toy path
# ---------------------------------------------------------------------------


def _batch(vocab, b=2, s=20, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                        # masked positions
    return {"tokens": toks, "labels": labels}


def test_loss_and_grads_match_jax(pair):
    jmodel, params, tmodel = pair
    tmodel.zero_grad()
    batch = _batch(jmodel.cfg.vocab_size)
    n = float((batch["labels"] >= 0).sum())

    def jloss(p):
        per_tok, aux = jmodel.per_token_loss(
            p, {k: jnp.asarray(v) for k, v in batch.items()})
        return jnp.sum(per_tok) / n + aux, aux

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    per_tok, aux = tmodel.per_token_loss(batch)
    tl = per_tok.sum() / n + aux
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=TOL)
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jg))
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    assert tmodel.kinds == ["dense", "moe", "moe"]
    for k, g in want.items():
        np.testing.assert_allclose(
            t2n(got[k]), g, rtol=1e-4,
            atol=1e-5 * (np.abs(g).max() + 1e-6), err_msg=k)
    tmodel.zero_grad()
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(batch["tokens"]).long())
    np.testing.assert_allclose(
        t2n(logits), np.asarray(jax.jit(jmodel.forward)(
            params, jnp.asarray(batch["tokens"]))), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def jstep(pair):
    """The JAX ``decode_step``, jitted once for the decode and toy tests."""
    return jax.jit(pair[0].decode_step)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_decode_step_matches_forward_and_jax(pair, jstep, int8):
    jmodel, params, tmodel = pair
    toks = np.random.RandomState(1).randint(
        0, jmodel.cfg.vocab_size, (2, 10)).astype(np.int32)
    with torch.no_grad():
        full = t2n(tmodel(torch.from_numpy(toks).long()))
    cache = tmodel.init_cache(2, 16, torch.int8 if int8 else None)
    jcache = jmodel.init_cache(2, 16, jnp.int8 if int8 else None)
    assert sorted(cache) == sorted(jcache) == ["lens", "seg_dense",
                                               "seg_moe"]
    want_dtype = torch.bfloat16 if int8 else torch.float32
    for seg in ("seg_dense", "seg_moe"):
        for c in cache[seg]:
            assert sorted(c) == ["c_kv", "k_rope"]
            assert {t.dtype for t in c.values()} == {want_dtype}
    assert jcache["seg_moe"][0]["c_kv"].dtype == \
        (jnp.bfloat16 if int8 else jnp.float32)
    tol = INT8_TOL if int8 else DECODE_TOL
    for i in range(toks.shape[1]):
        logits, cache = tmodel.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                           cache)
        jlogits, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1]),
                                jcache)
        if not int8:             # bf16 latents are not the f32 forward's
            np.testing.assert_allclose(t2n(logits), full[:, i],
                                       atol=DECODE_TOL, rtol=DECODE_TOL)
        np.testing.assert_allclose(t2n(logits), np.asarray(jlogits),
                                   atol=tol, rtol=tol)


class _JaxToy:
    """The JAX model as the reference's ``greedy_generate`` drives it."""

    def __init__(self, model, decode_step, cache_dtype=None):
        self.model, self.cache_dtype = model, cache_dtype
        self.decode_step = decode_step

    def init_cache(self, batch, max_len):
        return self.model.init_cache(batch, max_len, dtype=self.cache_dtype)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_greedy_generate_matches_jax(pair, jstep, int8):
    jmodel, params, tmodel = pair
    # batch 2 and a 16-slot cache: the decode test's shapes
    prompt = np.random.RandomState(2).randint(
        0, jmodel.cfg.vocab_size, (2, 5)).astype(np.int32)
    want = jserve_step.greedy_generate(
        _JaxToy(jmodel, jstep, jnp.int8 if int8 else None), params,
        jnp.asarray(prompt), 6, 12)
    got = tserve_step.greedy_generate(
        tmodel, torch.from_numpy(prompt), 6, 12,
        cache_dtype=torch.int8 if int8 else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_refuses_mla_with_the_references_message(pair):
    _, _, tmodel = pair
    cfg = tconfigs.get_smoke_config(ARCH)
    _, why = jsupports_paged(jconfigs.get_smoke_config(ARCH))
    with pytest.raises(ValueError) as err:
        ServeEngine(cfg, tmodel, device="cpu", clock="virtual")
    assert str(err.value) == f"paged serving unsupported: {why}"
    with pytest.raises(ValueError, match="paged serving unsupported"):
        tserve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests",
                         "2"])


# ---------------------------------------------------------------------------
# The trainer on both backends, checkpoints across packages
# ---------------------------------------------------------------------------


def _train_jcfg(backend, directory, *, grad_batch=0, every=0, steps=4):
    return jbase.TrainConfig(
        model=dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                                  remat="full"),
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
    # use_kernel=True asks for the backup_reduce CUDA kernel; None takes
    # its plain twin on the CPU
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Four-step runs from the JAX init (seed 0's): JAX sim (checkpoints
    at 2 and 4) and spmd, the port's sim (checkpoints at 2 and 4) and spmd
    at grad_batch 0 and 1."""
    params = jax_params(_train_jcfg("sim", "").model, 0)
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, params)
        self.reset_optimizer_state()

    root = tmp_path_factory.mktemp("mla_train")
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


def test_port_checkpoint_restores_in_jax(runs):
    """The port's step-4 checkpoint, read by the JAX Trainer, holds the
    JAX sim run's state (MLA leaves under ``seg_dense`` / ``seg_moe``)."""
    tdir = runs["root"] / "torch_sim"
    assert tckpt.available_steps(str(tdir)) == [2, 4]
    tr = jloop.Trainer(_train_jcfg("sim", tdir))
    tr.restore_checkpoint(4)
    assert tr.step == 4
    assert "wkv_b" in tr.params["seg_moe"]["attn"]
    jres = runs["jax", "sim"]
    _assert_state_close(from_jax_tree(tr.params), from_jax_tree(tr.ema),
                        jres.params, jres.ema)


# ---------------------------------------------------------------------------
# The CLIs against the JAX CLIs
# ---------------------------------------------------------------------------


_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) sim\s+(\S+)s "
                   r"selected (\d+)")


def test_train_cli_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """``--arch deepseek-v2-lite-16b --smoke`` on spmd, the port starting
    from the JAX CLI's init: the same step lines (loss within 2e-4)."""
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


_ROW = re.compile(r"^  (\[.*\])$", re.M)


def test_toy_serve_cli_matches_jax_cli(capsys, monkeypatch):
    """Both toy serve CLIs on the same JAX parameters (the JAX CLI's init
    by seed, loaded into the port's model) and prompt, with ``--cache-int8``
    (bf16 latents): the token rows are equal."""
    argv = ["--arch", ARCH, "--seed", "3", "--toy", "--batch", "2",
            "--prompt-len", "4", "--tokens", "5", "--cache-int8"]
    cfg = tconfigs.get_smoke_config(ARCH)
    params = jax_params(jconfigs.get_smoke_config(ARCH), 3)
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
