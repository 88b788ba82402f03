"""whisper-tiny (the audio family, encoder-decoder) against the JAX
package, on the CPU; and what the hybrid and audio families share: the
paged engine's refusal and the tensor-parallel fallback.

Inputs (tokens, encoder frames) are made with numpy from a seed;
parameters come from the JAX ``init`` and cross by ``load_jax_params``.
f32, TF32 off (``torch_parity``), one intra-op thread. The smoke config:
2 + 2 layers, d_model 64, 4 heads of 16, 16 encoder frames, biases.

* The configs, and the full config's parameter count (62,263,296) against
  the reference's.
* ``encode``, ``forward``, ``per_token_loss`` and its gradients,
  ``prefill``, atol 1e-5 (gradients rtol 1e-4, atol 1e-5 of the largest
  gradient entry).
* ``prime_cross_cache`` and ``decode_step`` stepped over 12 tokens against
  the JAX functions, fp and int8: the reference's int8 cache (values cast
  to int8 with no scales, the self-attention's probabilities cast to
  int8) is reproduced, caches bit-equal; fp stepped logits against
  ``forward`` (the reference's own check, rtol / atol 2e-3);
  ``greedy_generate`` with ``encoder_frames`` against the JAX loop.
* Training through the ``batch_fn`` override (batches with frames), the
  reference's only route for this family: async over 4 workers per
  arrival and in chunks of 4 updates against the JAX Trainer per
  arrival (losses rtol 2e-4, params and EMA within rtol 2e-4 / atol
  2e-5); event checkpoints cross both ways; a mask strategy refuses the
  override with the reference's message.
* The ``--toy`` serve CLI's token rows equal the JAX CLI's, fp and int8,
  the frames handed over (``toy_frames``).
* Both families: ``ServeEngine`` refuses them with the reference's
  message; at ``mesh_model=2`` the TP plan shards nothing (as the
  reference's) and the trainer warns and carries the axis replicated.
"""
import dataclasses
import re
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.distributed import sharding as jsharding
from repro.launch import serve as jserve_cli
from repro.models import get_model as jget_model
from repro.models import registry as jregistry
from repro.serve.paged_model import supports_paged as jsupports_paged
from repro.train import loop as jloop
from repro.train import serve_step as jserve_step

from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed import spmd_engine as tspmd
from repro_torch.launch import serve as tserve_cli
from repro_torch.models import (from_jax_tree, get_model, load_jax_params,
                                param_count)
from repro_torch.serve import ServeEngine
from repro_torch.train import loop as tloop
from repro_torch.train import serve_step as tserve_step
from torch_moe_common import one_torch_thread  # noqa: F401
from torch_parity import fake_world_of_two  # noqa: F401 (fixture)
from torch_parity import port_config, t2n

ARCH = "whisper-tiny"
TOL = 1e-5
DECODE_TOL = 2e-3          # the reference's stepped-vs-forward check
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5


def _jit_params(jcfg, seed):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jget_model(jcfg).init)(jax.random.PRNGKey(seed)))


def _frames(seed, b, cfg, scale=0.5):
    return (scale * np.random.RandomState(seed).randn(
        b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params as numpy, the port's model on them)."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = _jit_params(jcfg, 2)
    return jget_model(jcfg), params, load_jax_params(
        get_model(port_config(jcfg), device="cpu"), params)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_reference(getter):
    j = getattr(jconfigs, getter)(ARCH)
    t = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.family == "audio" and t.use_bias and t.is_encoder_decoder


def test_param_count_matches_reference():
    """At full width the reference's count (``repro.models.registry.
    param_count``; ``pos_dec`` 65,536 x 384 is 40% of it), on the smoke
    config its function."""
    assert param_count(port_config(jconfigs.get_config(ARCH))) == 62_263_296
    smoke = jconfigs.get_smoke_config(ARCH)
    assert param_count(port_config(smoke)) == jregistry.param_count(smoke)


def _batch(cfg, b=2, s=12, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": labels, "encoder_frames": _frames(seed + 1, b, cfg)}


def test_encode_forward_loss_grads_match_jax(pair):
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
    assert per_tok.shape == (2, 12) and float(aux) == 0.0
    np.testing.assert_allclose(t2n(per_tok), np.asarray(jper_tok), rtol=0,
                               atol=TOL)
    per_tok.sum().backward()
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jg))
    assert sorted(want) == sorted(dict(tmodel.named_parameters()))
    # atol against the whole gradient's scale: the key biases' gradients
    # are 0 up to rounding (softmax ignores a shift common to every key)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for k, prm in tmodel.named_parameters():
        np.testing.assert_allclose(t2n(prm.grad), want[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)
    tmodel.zero_grad()
    toks = torch.from_numpy(batch["tokens"])
    frames = torch.from_numpy(batch["encoder_frames"])
    with torch.no_grad():
        enc = tmodel.encode(frames)
        logits = tmodel(toks, encoder_frames=frames)
        via_prefix = tmodel(toks, prefix_embeds=frames)
        last = tmodel.prefill(toks, encoder_frames=frames)
    np.testing.assert_allclose(
        t2n(enc), np.asarray(jax.jit(jmodel.encode)(
            params, jbatch["encoder_frames"])), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        t2n(logits), np.asarray(jax.jit(jmodel.forward)(
            params, jbatch["tokens"], jbatch["encoder_frames"])),
        rtol=0, atol=TOL)
    np.testing.assert_array_equal(t2n(via_prefix), t2n(logits))
    np.testing.assert_array_equal(t2n(last), t2n(logits[:, -1]))


# ---------------------------------------------------------------------------
# Decode: the cross caches primed once, the self caches stepped
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jfns(pair):
    jmodel = pair[0]
    return (jax.jit(jmodel.prime_cross_cache),
            jax.jit(jmodel.decode_step))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_prime_and_decode_match_forward_and_jax(pair, jfns, int8):
    """``prime_cross_cache`` then 12 steps: the cross K/V, the self
    caches and every step's logits equal the JAX functions' (int8: the
    reference's scale-less casts, the caches bit-equal); fp, the stepped
    logits equal ``forward``'s within the reference's 2e-3."""
    jmodel, params, tmodel = pair
    jprime, jstep = jfns
    cfg = jmodel.cfg
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, (2, 12))
    frames = _frames(4, 2, cfg, scale=1.0)
    dt = torch.int8 if int8 else None
    cache = tmodel.prime_cross_cache(tmodel.init_cache(2, 12, dt),
                                     torch.from_numpy(frames))
    jcache = jprime(params, jmodel.init_cache(2, 12, jnp.int8 if int8
                                              else None),
                    jnp.asarray(frames))
    for key in ("cross_k", "cross_v"):
        for i in range(cfg.num_layers):
            assert cache[key][i].dtype == (torch.int8 if int8
                                           else torch.float32)
            np.testing.assert_allclose(t2n(cache[key][i]).astype(np.float32),
                                       np.asarray(jcache[key][i],
                                                  np.float32),
                                       rtol=0, atol=0 if int8 else TOL)
    got, want = [], []
    for i in range(12):
        lg, cache = tmodel.decode_step(torch.from_numpy(toks[:, i:i + 1]),
                                       cache)
        jlg, jcache = jstep(params, jnp.asarray(toks[:, i:i + 1], jnp.int32),
                            jcache)
        got.append(t2n(lg))
        want.append(np.asarray(jlg))
    assert cache["lens"] == 12
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1), rtol=0,
                               atol=1e-4 if int8 else TOL)
    for i in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                t2n(cache["self"][i][key]).astype(np.float32),
                np.asarray(jcache["self"][i][key], np.float32), rtol=0,
                atol=0 if int8 else TOL, err_msg=f"layer {i} {key}")
    if not int8:
        with torch.no_grad():
            full = tmodel(torch.from_numpy(toks),
                          encoder_frames=torch.from_numpy(frames))
        np.testing.assert_allclose(np.stack(got, 1), t2n(full),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_greedy_generate_matches_jax(pair, jfns, int8):
    """``greedy_generate(encoder_frames=)`` primes the cross cache first,
    as the reference's loop does: the tokens are the JAX loop's."""
    jmodel, params, tmodel = pair
    jprime, jstep = jfns
    cfg = jmodel.cfg
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 5))
    frames = _frames(6, 2, cfg, scale=1.0)
    got = tserve_step.greedy_generate(
        tmodel, torch.from_numpy(prompt), 6, 12,
        cache_dtype=torch.int8 if int8 else None,
        encoder_frames=torch.from_numpy(frames))
    jloop_model = types.SimpleNamespace(
        init_cache=lambda b, n: jmodel.init_cache(
            b, n, jnp.int8 if int8 else None),
        prime_cross_cache=jprime, decode_step=jstep)
    want = jserve_step.greedy_generate(jloop_model, params,
                                       jnp.asarray(prompt, jnp.int32), 6, 12,
                                       encoder_frames=jnp.asarray(frames))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Training through the batch_fn override
# ---------------------------------------------------------------------------


def _train_jcfg(strategy, directory="", *, every=0, chunk=1, steps=6):
    workers, backups = (4, 0) if strategy == "async" else (3, 1)
    return jbase.TrainConfig(
        model=jconfigs.get_smoke_config(ARCH),
        shape=jbase.ShapeConfig("t", 12, 2 * (workers + backups), "train"),
        aggregation=jbase.AggregationConfig(strategy=strategy,
                                            num_workers=workers,
                                            backup_workers=backups),
        optimizer=jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                        scale_lr_with_workers=False,
                                        ema_decay=0.9),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(use_kernel=True),
        seed=0, total_steps=steps, log_every=1, chunk_size=chunk)


def _port_cfg(jcfg):
    cfg = port_config(jcfg)
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


def _batch_fn(worker, draw):
    """2 sequences of 12 tokens and 16 frames, from (worker, draw)."""
    return _batch(jconfigs.get_smoke_config(ARCH), b=2, s=12,
                  seed=100 * draw + worker)


def _jbatch_fn(worker, draw):
    return {k: jnp.asarray(v) for k, v in _batch_fn(worker, draw).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Six async updates from the JAX init (seed 0's): the JAX Trainer per
    arrival (a checkpoint at 3), the port per arrival (a checkpoint at 3)
    and in chunks of 4."""
    params = _jit_params(jconfigs.get_smoke_config(ARCH), 0)
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, params)
        self.reset_optimizer_state()
        self._init_event_state()

    root = tmp_path_factory.mktemp("whisper_train")
    out = {"root": root}
    mp = pytest.MonkeyPatch()
    mp.setattr(tloop.Trainer, "init_state", init_state)
    try:
        out["jax"] = jloop.run_experiment(
            _train_jcfg("async", root / "jax", every=3),
            batch_fn=_jbatch_fn)
        out["torch", 1] = tloop.run_experiment(
            _port_cfg(_train_jcfg("async", root / "torch", every=3)),
            batch_fn=_batch_fn, device="cpu")
        out["torch", 4] = tloop.run_experiment(
            _port_cfg(_train_jcfg("async", chunk=4)), batch_fn=_batch_fn,
            device="cpu")
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


@pytest.mark.parametrize("chunk", [1, 4], ids=["per_arrival", "chunk4"])
def test_async_batch_fn_run_matches_jax(runs, chunk):
    jres, tres = runs["jax"], runs["torch", chunk]
    assert tres.steps == jres.steps == 6
    for key in ("sim_time", "staleness"):
        assert [m.get(key) for m in tres.metrics] == \
            [m.get(key) for m in jres.metrics]
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    _assert_state_close(tres.params, tres.ema, jres.params, jres.ema)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_event_checkpoints_interchange(runs, direction):
    """The step-3 checkpoint of one package, resumed for 3 more updates
    in the other, against the JAX run's straight 6."""
    jres = runs["jax"]
    if direction == "port-to-jax":
        tr = jloop.Trainer(_train_jcfg("async", runs["root"] / "torch"),
                           batch_fn=_jbatch_fn)
        tr.restore_checkpoint(3)
        res = tr.run(3)
        params, ema = from_jax_tree(res.params), from_jax_tree(res.ema)
    else:
        tr = tloop.Trainer(_port_cfg(_train_jcfg("async",
                                                 runs["root"] / "jax")),
                           batch_fn=_batch_fn, device="cpu")
        tr.reset_optimizer_state()
        tr.restore_checkpoint(3)
        res = tr.run(3)
        params, ema = res.params, res.ema
    assert tr.step == 6 and res.sim_time == jres.sim_time
    _assert_state_close(params, ema, jres.params, jres.ema)


def test_mask_strategy_refuses_batch_fn():
    """The override serves the event strategies only, as in the reference
    (whose synthetic pipeline makes no frames either)."""
    jcfg = _train_jcfg("backup")
    with pytest.raises(ValueError) as want:
        jloop.Trainer(jcfg, batch_fn=_jbatch_fn).init_state()
    with pytest.raises(ValueError) as got:
        tloop.Trainer(_port_cfg(jcfg), batch_fn=_batch_fn, device="cpu")
    assert str(got.value) == str(want.value)
    assert "event strategies" in str(got.value)


# ---------------------------------------------------------------------------
# The toy serve CLI
# ---------------------------------------------------------------------------


_ROW = re.compile(r"^  (\[.*\])$", re.M)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_toy_serve_cli_matches_jax_cli(capsys, monkeypatch, int8):
    """Both toy serve CLIs on the same JAX parameters (the JAX CLI's init
    by seed, loaded into the port's model), prompt and frames (the port's
    ``toy_prompt`` and ``toy_frames`` handed to the JAX CLI's
    ``jax.random.randint`` and ``jax.random.normal``): the token rows are
    equal."""
    argv = ["--arch", ARCH, "--seed", "3", "--toy", "--batch", "2",
            "--prompt-len", "4", "--tokens", "5"] + (
                ["--cache-int8"] if int8 else [])
    cfg = tconfigs.get_smoke_config(ARCH)
    params = _jit_params(jconfigs.get_smoke_config(ARCH), 3)
    prompt = tserve_cli.toy_prompt(3, 2, 4, cfg.vocab_size)
    frames = tserve_cli.toy_frames(2, cfg.encoder_seq_len, cfg.d_model)
    assert frames.shape == (2, 16, 64) and frames.dtype == np.float32
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(prompt, jnp.int32))
    monkeypatch.setattr(jax.random, "normal",
                        lambda *a, **k: jnp.asarray(frames))
    jserve_cli.main(argv)
    want = capsys.readouterr().out
    monkeypatch.setattr(tserve_cli, "get_model", lambda c, device, generator:
                        load_jax_params(get_model(c, device=device), params))
    tserve_cli.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _ROW.findall(got) == _ROW.findall(want)
    assert len(_ROW.findall(got)) == 2
    assert got.split(" prefill ")[0] == want.split(" prefill ")[0]


# ---------------------------------------------------------------------------
# Both families: no paged engine, no tensor-parallel plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["hymba-1.5b", ARCH])
def test_engine_refuses_the_family_with_the_references_message(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    ok, why = jsupports_paged(jcfg)
    assert not ok
    model = get_model(port_config(jcfg), device="cpu")
    with pytest.raises(ValueError) as got:
        ServeEngine(port_config(jcfg), model, device="cpu")
    assert why in str(got.value)


@pytest.mark.parametrize("arch", ["hymba-1.5b", ARCH])
def test_mesh_model_falls_back_to_a_carried_axis(arch, fake_world_of_two):
    """At ``mesh_model=2`` neither family shards (the reference's plan:
    its TP hooks live in the transformer blocks; whisper has biases too):
    ``resolve_tp`` warns, and the spmd trainer builds with the axis
    carried, every parameter whole."""
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = port_config(jcfg)
    jplan = jsharding.tp_plan(jcfg, 2)
    plan = tsharding.tp_plan(tcfg, 2)
    assert (plan.size, plan.attn, plan.ffn, plan.vocab) == \
        (jplan.size, jplan.attn, jplan.ffn, jplan.vocab) == \
        (2, False, False, False)
    with pytest.warns(UserWarning, match="carried"):
        tspmd.resolve_tp(tcfg, 2)
    base = _port_cfg(_train_jcfg("backup"))
    cfg = dataclasses.replace(
        base, model=tcfg, execution=dataclasses.replace(
            base.execution, backend="spmd", mesh_model=2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = tloop.Trainer(cfg, device="cpu")
    assert any("carried" in str(w.message) for w in caught)
    full = {k: tuple(v.shape) for k, v in get_model(
        tcfg, device="cpu").named_parameters()}
    assert {k: tuple(v.shape) for k, v in tr.model.named_parameters()} == \
        full
