"""The vlm family (internvl2-2b: a prefix of precomputed embeddings ahead
of the text) against the JAX package, on the CPU.

Parameters come from the JAX ``init`` and cross by ``load_jax_params``;
the prefix embeddings and the tokens are made with numpy from a seed. f32,
TF32 off (``torch_parity``). The smoke config: 2 layers, d_model 64, 4 / 2
heads, a prefix of 8.

* The config and the full config's parameter count (1,889,634,304) equal
  the reference's.
* ``forward``, ``per_token_loss`` (``[2, 8 + 16]``, 0 over the prefix)
  and its gradients, and ``prefill`` with ``prefix_embeds`` against the JAX
  functions, atol 1e-5; ``embed_scale`` scales the tokens only.
* Trainer runs whose batches carry ``prefix_embeds``, against the JAX
  Trainer on the same batches: on sim, async (4 workers, per arrival)
  through ``batch_fn=``, the reference's batch override (it takes one for
  event strategies only); on the spmd engine, backup 3 + 1 at
  ``grad_batch`` 0, the synthetic pipeline's batches given a prefix in
  both packages. Losses rtol 2e-4, ``sim_time`` equal, params within rtol
  2e-4 / atol 2e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.data import synthetic_lm as jdata
from repro.models import get_model as jget_model
from repro.models import registry as jregistry
from repro.train import loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.data import synthetic_lm as tdata
from repro_torch.models import (from_jax_tree, get_model, load_jax_params,
                                param_count)
from repro_torch.train import loop as tloop
from torch_moe_common import one_torch_thread  # noqa: F401
from torch_parity import port_config, t2n

ARCH = "internvl2-2b"
TOL = 1e-5
TRAIN_RTOL, TRAIN_ATOL = 2e-4, 2e-5
STEPS = 3


def _prefix(seed, b, cfg):
    """[b, P, d] prefix embeddings of unit scale, from ``seed``."""
    return np.random.RandomState(seed).randn(
        b, cfg.num_prefix_embeds, cfg.d_model).astype(np.float32)


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -1
    return {"tokens": rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": labels, "prefix_embeds": _prefix(seed + 1, b, cfg)}


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get_smoke_config(ARCH)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jget_model(jcfg).init)(jax.random.PRNGKey(2)))
    return jget_model(jcfg), params, load_jax_params(
        get_model(port_config(jcfg), device="cpu"), params)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_reference(getter):
    j = getattr(jconfigs, getter)(ARCH)
    t = getattr(tconfigs, getter)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.family == "vlm" and t.num_prefix_embeds > 0


def test_param_count_matches_reference():
    """At full width the reference's count (``repro.models.registry.
    param_count``), on the smoke config its function."""
    assert param_count(port_config(jconfigs.get_config(ARCH))) == \
        1_889_634_304
    smoke = jconfigs.get_smoke_config(ARCH)
    assert param_count(port_config(smoke)) == jregistry.param_count(smoke)


def test_forward_loss_grads_and_prefill_match_jax(pair):
    jmodel, params, tmodel = pair
    tmodel.zero_grad()
    batch = _batch(jmodel.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    p = jmodel.cfg.num_prefix_embeds

    def jloss(prm):
        per_tok, _ = jmodel.per_token_loss(prm, jbatch)
        return jnp.sum(per_tok), per_tok

    (_, jper_tok), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    per_tok, aux = tmodel.per_token_loss(batch)
    assert per_tok.shape == (2, p + 16) and float(aux) == 0.0
    assert not per_tok[:, :p].any()
    np.testing.assert_allclose(t2n(per_tok), np.asarray(jper_tok), rtol=0,
                               atol=TOL)
    per_tok.sum().backward()
    want = from_jax_tree(jax.tree_util.tree_map(np.asarray, jg))
    for k, prm in tmodel.named_parameters():
        g = want[k]
        np.testing.assert_allclose(t2n(prm.grad), g, rtol=1e-4,
                                   atol=1e-5 * (np.abs(g).max() + 1e-6),
                                   err_msg=k)
    tmodel.zero_grad()
    toks, prefix = batch["tokens"], batch["prefix_embeds"]
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(toks), torch.from_numpy(prefix))
        last = tmodel.prefill(torch.from_numpy(toks),
                              torch.from_numpy(prefix))
    assert logits.shape == (2, p + 16, jmodel.cfg.padded_vocab)
    np.testing.assert_allclose(
        t2n(logits), np.asarray(jax.jit(jmodel.forward)(
            params, jnp.asarray(toks), jnp.asarray(prefix))),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        t2n(last), np.asarray(jax.jit(jmodel.prefill)(
            params, jnp.asarray(toks), jnp.asarray(prefix))),
        rtol=0, atol=TOL)
    np.testing.assert_array_equal(t2n(last), t2n(logits[:, -1]))


def test_embed_scale_leaves_the_prefix_alone(pair):
    _, params, _ = pair
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               embed_scale=3.0)
    tmodel = load_jax_params(get_model(port_config(jcfg), device="cpu"),
                             params)
    batch = _batch(jcfg)
    toks = torch.from_numpy(batch["tokens"])
    prefix = torch.from_numpy(batch["prefix_embeds"])
    with torch.no_grad():
        x = tmodel._embed_inputs(toks, prefix)
        plain = tmodel._embed_inputs(toks)
    p = jcfg.num_prefix_embeds
    assert torch.equal(x[:, :p], prefix) and torch.equal(x[:, p:], plain)
    np.testing.assert_array_equal(
        t2n(plain), 3.0 * params["embed"]["embedding"][batch["tokens"]])
    want = jget_model(jcfg)._embed_inputs(params, jnp.asarray(toks.numpy()),
                                          jnp.asarray(prefix.numpy()))
    np.testing.assert_array_equal(t2n(x), np.asarray(want))


# ---------------------------------------------------------------------------
# Trainer runs whose batches carry a prefix
# ---------------------------------------------------------------------------


def _jcfg(strategy, workers, backups, backend):
    return jbase.TrainConfig(
        model=jconfigs.get_smoke_config(ARCH),
        shape=jbase.ShapeConfig("t", 16, 2 * (workers + backups), "train"),
        aggregation=jbase.AggregationConfig(strategy=strategy,
                                            num_workers=workers,
                                            backup_workers=backups),
        optimizer=jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                        scale_lr_with_workers=False),
        execution=jbase.ExecutionConfig(backend=backend, use_kernel=True),
        seed=0, total_steps=STEPS, log_every=1)


def _tcfg(jcfg):
    cfg = port_config(jcfg)
    return dataclasses.replace(
        cfg, execution=dataclasses.replace(cfg.execution, use_kernel=None))


def _with_prefix(global_batch, cfg):
    """``global_batch`` of a synthetic pipeline, each step's batch given a
    seeded prefix."""
    def batch(data_cfg, step):
        out = dict(global_batch(data_cfg, step))
        out["prefix_embeds"] = _prefix(1000 + step, out["tokens"].shape[0],
                                       cfg)
        return out
    return batch


def _event_batch_fn(cfg):
    """The async runs' ``batch_fn(worker, draw)``: 2 sequences of 16 and a
    prefix, from (worker, draw)."""
    def batch_fn(worker, draw):
        return _batch(cfg, b=2, s=16, seed=100 * draw + worker)
    return batch_fn


RUNS = ("async batch_fn", "backup spmd")


@pytest.fixture(scope="module")
def runs():
    """Each run in both packages from the JAX init (seed 0's)."""
    cfg = jconfigs.get_smoke_config(ARCH)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jget_model(cfg).init)(jax.random.PRNGKey(0)))
    out = {}
    mp = pytest.MonkeyPatch()
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, params)
        self.reset_optimizer_state()
        if self.strategy.kind == "event":      # the workers' read copies
            self._init_event_state()

    mp.setattr(tloop.Trainer, "init_state", init_state)
    mp.setattr(jdata, "global_batch", _with_prefix(jdata.global_batch, cfg))
    mp.setattr(tdata, "global_batch", _with_prefix(tdata.global_batch, cfg))
    fn = _event_batch_fn(cfg)
    try:
        for run in RUNS:
            strategy, backend = run.split()
            if strategy == "async":
                jcfg, kw = _jcfg("async", 4, 0, "sim"), dict(batch_fn=fn)
                jkw = dict(batch_fn=lambda w, d: {
                    k: jnp.asarray(v) for k, v in fn(w, d).items()})
            else:
                jcfg, kw, jkw = _jcfg("backup", 3, 1, backend), {}, {}
            out["jax", run] = jloop.run_experiment(jcfg, **jkw)
            out["torch", run] = tloop.run_experiment(_tcfg(jcfg),
                                                     device="cpu", **kw)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("run", RUNS)
def test_prefix_trainer_runs_match_jax(runs, run):
    jres, tres = runs["jax", run], runs["torch", run]
    assert tres.steps == jres.steps
    assert tres.sim_time == jres.sim_time
    assert [m.get("selected") for m in tres.metrics] == \
        [m.get("selected") for m in jres.metrics]
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics],
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    want = from_jax_tree(jres.params)
    assert sorted(tres.params) == sorted(want)
    for k, v in tres.params.items():
        np.testing.assert_allclose(t2n(v), np.asarray(want[k]),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=k)
