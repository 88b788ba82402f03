"""The port's host-side training pieces against the JAX reference.

* Straggler samples (every latency model), the mask strategies' masks and
  iteration times and the ``StragglerSimulator``'s ``sim_time``, for
  full_sync, backup and timeout: bit for bit (pure numpy on both sides).
* Synthetic LM batches (``worker_batch``, ``global_batch``, the pipeline
  across a save/restore): bit for bit.
* The registry refuses the strategies of later slices by name.
* Optimizers (all five, plus rmsprop without momentum), schedules, EMA,
  ``clip_by_global_norm`` and the masked-loss weights: f32 on the same
  inputs, atol 1e-6 over 5 steps (one f32 rounding per operation, in the
  reference's order; XLA may fuse a multiply-add where torch rounds twice).
* A JAX config converts into the port's through its fields alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import base as jbase
from repro.core import ema as jema
from repro.core import events as jevents
from repro.core import registry as jregistry
from repro.core import straggler as jstraggler
from repro.core import sync_backup as jsync
from repro.data import synthetic_lm as jdata
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched

from repro_torch.configs import base as tbase
from repro_torch.core import ema as tema
from repro_torch.core import events as tevents
from repro_torch.core import registry as tregistry
from repro_torch.core import straggler as tstraggler
from repro_torch.core import sync_backup as tsync
from repro_torch.data import synthetic_lm as tdata
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from torch_parity import port_config

LATENCIES = {
    "paper": dict(),
    "lognormal": dict(median=1.2, sigma=0.3),
    "deterministic": dict(slow_workers=(1, 4), slowdown=3.0),
    "uniform": dict(lo=0.5, hi=2.5),
}
_LAT_CLS = {"paper": "PaperCalibrated", "lognormal": "LogNormal",
            "deterministic": "DeterministicStragglers", "uniform": "Uniform"}


def _latency_pair(name):
    cls = _LAT_CLS[name]
    kw = LATENCIES[name]
    return getattr(jstraggler, cls)(**kw), getattr(tstraggler, cls)(**kw)


# ---------------------------------------------------------------------------
# Straggler models, masks, sim_time: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LATENCIES))
def test_latency_samples_bit_exact(name):
    jl, tl = _latency_pair(name)
    a = jl.sample(np.random.RandomState(3), (40, 8))
    b = tl.sample(np.random.RandomState(3), (40, 8))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        np.stack(jstraggler.mean_median_time_to_k(a)),
        np.stack(tstraggler.mean_median_time_to_k(b)))
    grid = np.linspace(0.5, 5.0, 7)
    np.testing.assert_array_equal(jstraggler.cdf_of_time_to_k(a, 3, grid),
                                  tstraggler.cdf_of_time_to_k(b, 3, grid))


@pytest.mark.parametrize("strategy,kw", [
    ("full_sync", dict(num_workers=8)),
    ("backup", dict(num_workers=6, backup_workers=2)),
    ("timeout", dict(num_workers=8, deadline_s=0.15)),
])
@pytest.mark.parametrize("latency", ["paper", "deterministic"])
def test_masks_and_sim_time_bit_exact(strategy, kw, latency):
    agg = dict(strategy=strategy, **kw)
    js = jregistry.get_strategy(jbase.AggregationConfig(**agg))
    ts = tregistry.get_strategy(tbase.AggregationConfig(**agg))
    jl, tl = _latency_pair(latency)
    jsim = jevents.StragglerSimulator(js, jl, seed=5)
    tsim = tevents.StragglerSimulator(ts, tl, seed=5)
    jsim.kill_worker(2)
    tsim.kill_worker(2)
    jt = tt = 0.0
    for _ in range(60):
        a, b = jsim.next_event(), tsim.next_event()
        assert a.step == b.step
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_array_equal(a.arrivals, b.arrivals)
        assert a.iteration_time == b.iteration_time
        jt += a.iteration_time
        tt += b.iteration_time
    assert jt == tt
    assert ts.effective_n() == js.effective_n()
    jsim.reset_to_step(7)
    tsim.reset_to_step(7)
    np.testing.assert_array_equal(jsim.next_event().mask,
                                  tsim.next_event().mask)


def test_registry_refuses_unported_strategies():
    """Every strategy of the reference is built now (``dynamic_backup``
    with its window, floor and latency source); an unknown name raises the
    reference's ValueError, listing the valid ones."""
    dyn = tregistry.get_strategy(tbase.AggregationConfig(
        strategy="dynamic_backup", num_workers=5, backup_workers=3,
        dynamic_window=7, dynamic_min_workers=2, latency_source="measured"))
    assert (dyn.name, dyn.total_workers, dyn.window, dyn.min_alive,
            dyn.latency_source) == ("dynamic_backup", 8, 7, 2, "measured")
    with pytest.raises(ValueError, match="valid strategies") as got:
        tregistry.get_strategy(tbase.AggregationConfig(strategy="nope"))
    with pytest.raises(ValueError) as want:
        jregistry.get_strategy(jbase.AggregationConfig(strategy="nope"))
    # the lists after it name what each process registered
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]
    backup = tregistry.get_strategy(tbase.AggregationConfig(
        strategy="backup", num_workers=3, backup_workers=1))
    assert tregistry.supports_spmd(backup)
    for name in ("async", "softsync", "staleness"):
        event = tregistry.get_strategy(tbase.AggregationConfig(strategy=name))
        assert event.kind == "event" and not tregistry.supports_spmd(event)
    assert tregistry.available() == [
        "async", "backup", "dynamic_backup", "full_sync", "softsync",
        "staleness", "timeout"]


# ---------------------------------------------------------------------------
# Synthetic batches: bit for bit
# ---------------------------------------------------------------------------


def test_synthetic_batches_bit_exact():
    kw = dict(vocab_size=512, seq_len=16, global_batch=16, num_workers=8,
              seed=3)
    jc, tc = jdata.SyntheticLMConfig(**kw), tdata.SyntheticLMConfig(**kw)
    for step in (0, 1, 17):
        for w in (0, 5):
            a, b = jdata.worker_batch(jc, w, step), tdata.worker_batch(tc, w,
                                                                       step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    jp, tp = jdata.SyntheticLMPipeline(jc), tdata.SyntheticLMPipeline(tc)
    for _ in range(3):
        a, b = jp.next(), tp.next()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    tp2 = tdata.SyntheticLMPipeline(
        tc, tdata.PipelineState.restore(tp.state.save()))
    np.testing.assert_array_equal(jp.next()["labels"], tp2.next()["labels"])


# ---------------------------------------------------------------------------
# Masked-loss weights
# ---------------------------------------------------------------------------


def test_masked_loss_weights_match():
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    per_ex = np.random.RandomState(0).rand(12).astype(np.float32)
    np.testing.assert_allclose(
        tsync.per_example_weights(torch.from_numpy(mask), 12, 4).numpy(),
        np.asarray(jsync.per_example_weights(jnp.asarray(mask), 12, 4)),
        rtol=0, atol=0)
    np.testing.assert_allclose(
        float(tsync.weighted_loss(torch.from_numpy(per_ex),
                                  torch.from_numpy(mask), 4)),
        float(jsync.weighted_loss(jnp.asarray(per_ex), jnp.asarray(mask), 4)),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers, schedules, EMA, clipping
# ---------------------------------------------------------------------------

_SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.randn(*s)).astype(np.float32)
            for k, s in _SHAPES.items()}


@pytest.mark.parametrize("name", ["sgd", "momentum", "rmsprop_momentum",
                                  "rmsprop", "adam", "adagrad"])
def test_optimizers_match_five_steps(name):
    kw = dict(name=name, learning_rate=0.01, scale_lr_with_workers=True,
              steps_per_epoch=3, weight_decay=0.01 if name == "adam" else 0.0)
    jcfg, tcfg = jbase.OptimizerConfig(**kw), tbase.OptimizerConfig(**kw)
    jo = jopt.make_optimizer(jcfg, jsched.from_config(jcfg, 4))
    to = topt.make_optimizer(tcfg, tsched.from_config(tcfg, 4))
    rng = np.random.RandomState(0)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert sorted(js) == sorted(ts)
    for step in range(5):
        g = _tree(rng, scale=0.1)
        jp, js, jstats = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                  js, jnp.asarray(step, jnp.int32))
        scalars = to.scalars(step)
        to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts,
                 scalars)
        # f32 pow on either side: may differ in the last ulp
        np.testing.assert_allclose(scalars["lr"], float(jstats["lr"]),
                                   rtol=2e-7)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
        for s in js:
            np.testing.assert_allclose(ts[s][k].numpy(),
                                       np.asarray(js[s][k]), atol=1e-6,
                                       rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.3),
    dict(learning_rate=0.3, steps_per_epoch=7),
    dict(learning_rate=0.3, linear_anneal_steps=20, linear_anneal_from=5),
    dict(learning_rate=0.3, warmup_steps=6, steps_per_epoch=4),
])
def test_schedules_match(kw):
    jf = jsched.from_config(jbase.OptimizerConfig(**kw), 5)
    tf = tsched.from_config(tbase.OptimizerConfig(**kw), 5)
    for step in (0, 1, 3, 6, 10, 25):
        np.testing.assert_allclose(tf(step),
                                   float(jf(jnp.asarray(step, jnp.int32))),
                                   rtol=2e-7)


def test_ema_and_clip_match():
    rng = np.random.RandomState(2)
    p0, p1 = _tree(rng), _tree(rng)
    je = jema.update(jema.init({k: jnp.asarray(v) for k, v in p0.items()}),
                     {k: jnp.asarray(v) for k, v in p1.items()}, 0.999)
    te = tema.init((k, torch.from_numpy(v)) for k, v in p0.items())
    tema.update(te, ((k, torch.from_numpy(v)) for k, v in p1.items()), 0.999)
    for k in p0:
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                   atol=1e-7, rtol=0)
    for max_norm in (0.5, 100.0):
        jg, jn = jopt.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in p1.items()}, max_norm)
        tg, tn = topt.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in p1.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in p1:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                       atol=1e-6)


def test_train_config_converts_through_fields():
    jcfg = jbase.TrainConfig(
        aggregation=jbase.AggregationConfig(strategy="timeout",
                                            deadline_s=0.3),
        execution=jbase.ExecutionConfig(backend="spmd", grad_batch=1),
        shape=jbase.ShapeConfig("t", 16, 8, "train"))
    tcfg = port_config(jcfg)
    assert isinstance(tcfg, tbase.TrainConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tbase.TrainConfig()) == \
        dataclasses.asdict(jbase.TrainConfig())
