"""The port's event regimes (ROADMAP Queue 1 item 6) on the CPU, against the
JAX reference: async (paper Alg. 1/2), softsync and the §2.1 staleness rig.

* The host half, bit for bit: ``plan_events`` column by column (dtypes
  too) for async, softsync (c in {1, 3}) and staleness (tau, ramp and
  jitter), over chunks of several lengths, with the schedulers' state,
  the plan state (strategy RNG included) and the ``on_arrival`` verdicts
  of both packages; ``SerialScheduler`` and ``staleness_schedule``.
* ``VersionedReads``: the same count of distinct versions as the
  reference's store after every write, shared copies, and a held read
  copy that an in-place update does not move.
* ``run_events`` port against JAX in f32 (tiny LM, RMSProp eps 1e-3, the
  JAX init): updates, staleness and sim_time equal, losses within rtol
  1e-5, parameters and EMA within rel 1e-5 per tensor (max |diff| <=
  1e-5 x max |reference|), the bound of the existing trainer parity
  tests.
* The trainer in event mode (qwen3 smoke and the rwkv6 smoke's plain
  twin): per arrival against the JAX ``chunk_size=1`` run (records equal
  but the loss, within rtol 1e-5; parameters within rel 1e-5 per
  tensor), and the chunked path at chunk 4 against the per-arrival path,
  bit for bit, with ragged chunks at a checkpoint cadence.
* The MNIST rig: ``make_dataset`` and ``batches`` bit-equal, ``MnistCNN``
  logits and loss within atol 1e-5, the staleness rig through
  ``run_experiment`` with the model and batch_fn overrides at chunk 1
  and chunk 4 (bit-equal) and against the JAX chunk-1 run.
* Checkpoints: a port event checkpoint continued by the JAX trainer
  equals the JAX straight run, and the reverse (rel 1e-5 per tensor);
  port resume equals the straight run bit for bit; a checkpoint inside a
  softsync window is refused.
* The CLI at ``--strategy async`` (per arrival and at ``--chunk-size 4``)
  and ``--strategy softsync --softsync-c 2`` prints the JAX CLI's step,
  sim_time, selected and staleness, losses within 2e-4. Refusals name
  their ROADMAP item, and a plugin without the plan/scan protocol warns
  and runs per arrival at ``chunk_size > 1``.

The card's side (the CUDA graphs of the chunked path) is in
``tests/test_torch_cuda.py``.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from benchmarks.common import tiny_lm_config
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import coordination as jcoord
from repro.core import registry as jregistry
from repro.core.straggler import Uniform as JUniform
from repro.data import mnist_like as jmnist
from repro.data import synthetic_lm as jdata
from repro.launch import train as jcli
from repro.models import get_model as jget_model
from repro.models import mnist_cnn as jcnn
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import schedules as jschedules
from repro.train import loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import coordination as tcoord
from repro_torch.core import registry as tregistry
from repro_torch.core.straggler import Uniform
from repro_torch.data import mnist_like as tmnist
from repro_torch.data import synthetic_lm as tdata
from repro_torch.launch import train as tcli
from repro_torch.models import (from_jax_tree, get_model, load_jax_params,
                                mnist_cnn as tcnn)
from repro_torch.optim import make_optimizer, schedules
from repro_torch.train import loop as tloop
from torch_parity import port_config

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel tier-1 run (as in
    tests/test_torch_chunk.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_close_per_tensor(got, want, rel=REL):
    """Port ``{name: tensor}`` against a JAX tree: max |diff| <= rel x
    max |reference| for every tensor."""
    want = from_jax_tree(want)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = _np(want[k])
        diff = np.abs(_np(v) - w).max()
        assert diff <= rel * max(np.abs(w).max(), 1e-30), (k, diff)


def _assert_same(a, b):
    """Two port ``{name: tensor}`` dicts, bit for bit."""
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k


# ---------------------------------------------------------------------------
# The host half, bit for bit
# ---------------------------------------------------------------------------

_AGG = {
    "async": dict(strategy="async", num_workers=4),
    "softsync-c1": dict(strategy="softsync", num_workers=4, softsync_c=1),
    "softsync-c3": dict(strategy="softsync", num_workers=5, softsync_c=3),
    "staleness": dict(strategy="staleness", num_workers=1, staleness_tau=3,
                      staleness_ramp_steps=6, staleness_jitter=1),
}


def _pair(name, seed=3):
    ts = tregistry.get_strategy(tbase.AggregationConfig(**_AGG[name]))
    js = jregistry.get_strategy(jbase.AggregationConfig(**_AGG[name]))
    if ts.uses_clock:
        scheds = (tcoord.EventScheduler(ts.total_workers, Uniform(1.0, 2.0),
                                        seed),
                  jcoord.EventScheduler(js.total_workers,
                                        JUniform(1.0, 2.0), seed))
    else:
        scheds = (tcoord.SerialScheduler(), jcoord.SerialScheduler())
    return (ts, js), scheds


def _plan_state_dict(s):
    if s is None:
        return None
    d = dict(vars(s))
    if "rng" in d:
        d["rng"] = tcoord.encode_rng(d["rng"])
    return d


@pytest.mark.parametrize("name", list(_AGG))
def test_plan_events_bit_equal_to_jax(name):
    (ts, js), (tsched, jsched) = _pair(name)
    assert type(ts).__name__ == type(js).__name__
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert (ts.uses_clock, ts.stals_per_arrival, ts.losses_per_arrival,
            ts.scan_supported, ts.total_workers) == \
        (js.uses_clock, js.stals_per_arrival, js.losses_per_arrival,
         js.scan_supported, js.total_workers)
    w = ts.total_workers
    tstate, jstate = ts.init_plan_state(3), js.init_plan_state(3)
    rv = [np.zeros(w, np.int64) for _ in range(2)]
    dr = [np.zeros(w, np.int64) for _ in range(2)]
    version = arrival = 0
    for u in (5, 1, 7):
        kw = dict(version0=version, arrival0=arrival, num_updates=u)
        got = tcoord.plan_events(ts, tsched, tstate, rv[0], dr[0], **kw)
        want = jcoord.plan_events(js, jsched, jstate, rv[1], dr[1], **kw)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert got.apply[-1] and got.updates == u
        version += u
        arrival += len(got)
        for a, b in zip(rv + dr, [rv[1], rv[1], dr[1], dr[1]]):
            np.testing.assert_array_equal(a, b)
        assert tsched.state_dict() == jsched.state_dict()
        assert _plan_state_dict(tstate) == _plan_state_dict(jstate)


def _verdicts(strategy, sched, grad, seed=3, arrivals=24):
    """``on_arrival``'s (apply, staleness, selected) per arrival, driven
    by the scheduler host-side (read-after-update, as run_events)."""
    state = strategy.init_state(seed)
    read = np.zeros(strategy.total_workers, np.int64)
    version, out = 0, []
    for i in range(arrivals):
        t, wk = sched.pop()
        ready = strategy.on_arrival(state, grad(i), jcoord.Arrival(
            index=i, worker=wk, time=t, staleness=int(version - read[wk]),
            version=version))
        out.append((ready is not None,
                    ready.staleness if ready else None,
                    ready.selected if ready else None))
        version += ready is not None
        read[wk] = version
        sched.push(t, wk)
    return out


@pytest.mark.parametrize("name", list(_AGG))
def test_on_arrival_verdicts_and_rng_order_match_jax(name):
    """The per-arrival verdicts (strategy RNG draws included) equal the
    reference's and the plan's."""
    (ts, js), (tsched, jsched) = _pair(name)
    got = _verdicts(ts, tsched, lambda i: {"w": torch.tensor([float(i)])})
    want = _verdicts(js, jsched, lambda i: {"w": jnp.asarray([float(i)])})
    assert got == want
    (ts, _), (sched, _) = _pair(name)
    plan = tcoord.plan_events(ts, sched, ts.init_plan_state(3),
                              np.zeros(ts.total_workers, np.int64),
                              np.zeros(ts.total_workers, np.int64),
                              version0=0, arrival0=0,
                              num_updates=sum(a for a, _, _ in got))
    n = len(plan)
    assert [a for a, _, _ in got[:n]] == plan.apply.tolist()
    assert [s for a, s, _ in got[:n] if a] == \
        plan.update_staleness[plan.apply].tolist()
    assert [k for a, _, k in got[:n] if a] == \
        plan.selected[plan.apply].tolist()


def test_serial_scheduler_and_staleness_schedule_match_jax():
    t, j = tcoord.SerialScheduler(), jcoord.SerialScheduler()
    for _ in range(5):
        assert t.pop() == j.pop()
        t.push(0.0, 0)
        j.push(0.0, 0)
    assert t.state_dict() == j.state_dict() == {"t": 5}
    t.load_state_dict({"t": 2})
    assert t.pop() == (2.0, 0)
    with pytest.raises(ValueError, match="single logical worker"):
        t.drop_worker(0)
    for step in range(12):
        for target, ramp in ((0, 5), (3, 0), (4, 5), (50, 7)):
            assert tcoord.staleness_schedule(step, target, ramp) == \
                jcoord.staleness_schedule(step, target, ramp)


# ---------------------------------------------------------------------------
# VersionedReads
# ---------------------------------------------------------------------------


def test_versioned_reads_share_like_the_reference():
    store = tcoord.VersionedReads({"w": torch.zeros(3)}, num_workers=100)
    ref = jcoord.VersionedReads({"w": jnp.zeros(3)}, num_workers=100)
    live = {"w": torch.zeros(3)}
    writes = ([(0, 1)] + [(w, 1) for w in range(1, 100)] + [(3, 1)]
              + [(5, 2), (6, 2), (5, 3), (7, 4), (6, 5)])
    for w, v in writes:
        live["w"].fill_(v)
        store.write(w, live, v)
        ref.write(w, {"w": jnp.full(3, float(v))}, v)
        assert store.distinct_versions == ref.distinct_versions
        np.testing.assert_array_equal(store.version, ref.version)
        assert torch.equal(store.read(w)["w"], torch.full((3,), float(v)))
    assert store.read(8) is store.read(50)          # shared, one copy
    assert len(store._free) + store.distinct_versions <= 100


def test_versioned_reads_are_clones_not_aliases():
    """An in-place update of the live parameters leaves a held read copy
    as it was: the reference's stored reference would move with it."""
    ocfg = tbase.OptimizerConfig(name="rmsprop_momentum", eps=1e-3,
                                 learning_rate=0.1)
    update = tcoord.make_update_fn(
        make_optimizer(ocfg, schedules.from_config(ocfg, 2)))
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    opt_state = update.init_opt_state(params)
    store = tcoord.VersionedReads(params, num_workers=2)
    held = store.read(0)["w"].clone()
    update(params, opt_state, {"w": torch.ones(2, 3)}, 0)
    assert not torch.equal(params["w"], held)
    assert torch.equal(store.read(0)["w"], held)
    store.write(1, params, 1)
    assert store.read(1)["w"] is not params["w"]
    assert torch.equal(store.read(1)["w"], params["w"])
    update(params, opt_state, {"w": torch.ones(2, 3)}, 1)
    assert torch.equal(store.read(0)["w"], held)
    assert not torch.equal(store.read(1)["w"], params["w"])


def test_registry_capabilities_match_jax():
    for name in ("full_sync", "backup", "timeout", "async", "softsync",
                 "staleness"):
        agg = dict(strategy=name, num_workers=4, backup_workers=1)
        ts = tregistry.get_strategy(tbase.AggregationConfig(**agg))
        js = jregistry.get_strategy(jbase.AggregationConfig(**agg))
        for ex in (None, tbase.ExecutionConfig(mesh_model=2)):
            assert tregistry.supports_spmd(ts, ex) == \
                jregistry.supports_spmd(js, ex)
        assert tregistry.supports_event_scan(ts) == \
            jregistry.supports_event_scan(js)

    class NoSpmd(tcoord.FullSync):
        spmd_supported = False

    class NoTp(tcoord.FullSync):
        spmd_tp_supported = False

    assert not tregistry.supports_spmd(NoSpmd(4))
    assert tregistry.supports_spmd(NoTp(4))
    assert not tregistry.supports_spmd(NoTp(4),
                                       tbase.ExecutionConfig(mesh_model=2))


# ---------------------------------------------------------------------------
# run_events against the reference (f32, tiny LM)
# ---------------------------------------------------------------------------

_RUN_EVENTS = {"async": (jcoord.Async(4), tcoord.Async(4)),
               "softsync": (jcoord.SoftSync(4, 2), tcoord.SoftSync(4, 2)),
               "staleness": (jcoord.Staleness(2, 4, 1),
                             tcoord.Staleness(2, 4, 1))}


@pytest.mark.parametrize("name", list(_RUN_EVENTS))
def test_run_events_matches_jax(name):
    jstrat, tstrat = _RUN_EVENTS[name]
    jmodel_cfg = tiny_lm_config()
    ocfg = dict(name="rmsprop_momentum", learning_rate=0.01, eps=1e-3,
                scale_lr_with_workers=False)
    jopt = jmake_optimizer(jbase.OptimizerConfig(**ocfg),
                           jschedules.from_config(
                               jbase.OptimizerConfig(**ocfg)))
    topt = make_optimizer(tbase.OptimizerConfig(**ocfg),
                          schedules.from_config(tbase.OptimizerConfig(**ocfg)))
    jmodel = jget_model(jmodel_cfg)
    params0 = jmodel.init(jax.random.PRNGKey(1))
    model = load_jax_params(
        get_model(port_config(jmodel_cfg), device="cpu"), params0)
    data = tdata.SyntheticLMConfig(vocab_size=64, seq_len=16, global_batch=8,
                                   num_workers=tstrat.total_workers, seed=1)
    common = dict(num_updates=10, seed=3, ema_decay=0.99)
    want = jcoord.run_events(
        jstrat, jcoord.make_grad_fn(jmodel), jcoord.make_update_fn(jopt),
        params0, lambda w, d: {k: jnp.asarray(v) for k, v in
                               tdata.worker_batch(data, w, d).items()},
        latency=JUniform(1.0, 2.0), **common)
    got = tcoord.run_events(
        tstrat, tcoord.make_grad_fn(model), tcoord.make_update_fn(topt),
        dict(model.named_parameters()),
        lambda w, d: {k: torch.from_numpy(v) for k, v in
                      tdata.worker_batch(data, w, d).items()},
        latency=Uniform(1.0, 2.0), **common)
    assert got.updates == want.updates == 10
    np.testing.assert_array_equal(got.staleness, want.staleness)
    np.testing.assert_array_equal(got.sim_time, want.sim_time)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    _assert_close_per_tensor(got.params, want.params)
    _assert_close_per_tensor(got.ema, want.ema)


# ---------------------------------------------------------------------------
# The trainer in event mode
# ---------------------------------------------------------------------------

_TRAIN = {
    "qwen3-async": ("qwen3-0.6b", dict(strategy="async", num_workers=4)),
    "qwen3-softsync": ("qwen3-0.6b", dict(strategy="softsync", num_workers=4,
                                          softsync_c=2)),
    "qwen3-staleness": ("qwen3-0.6b", dict(
        strategy="staleness", num_workers=1, staleness_tau=2,
        staleness_ramp_steps=3, staleness_jitter=1)),
    "rwkv6-async": ("rwkv6-1.6b", dict(strategy="async", num_workers=4)),
}
_JAX_PARAMS = {}


def _jax_cfg(arch, agg, chunk=1, *, directory="", every=0, steps=7):
    model = dataclasses.replace(jconfigs.get_smoke_config(arch), remat="full")
    return jbase.TrainConfig(
        model=model, shape=jbase.ShapeConfig("t", 16, 8, "train"),
        aggregation=jbase.AggregationConfig(**agg),
        # eps 1e-3 for the reason tests/test_torch_train.py gives
        optimizer=jbase.OptimizerConfig(name="rmsprop_momentum",
                                        learning_rate=0.005, eps=1e-3,
                                        scale_lr_with_workers=True,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=directory,
                                          every_steps=every),
        seed=0, total_steps=steps, log_every=1, chunk_size=chunk)


def _jax_params(model_cfg):
    if model_cfg.name not in _JAX_PARAMS:
        _JAX_PARAMS[model_cfg.name] = jget_model(model_cfg).init(
            jax.random.PRNGKey(0))
    return _JAX_PARAMS[model_cfg.name]


@pytest.fixture
def jax_init(monkeypatch):
    """The port's trainers start from the JAX init of their config's model
    (``_JAX_PARAMS`` by model name; the MNIST rig sets its own)."""
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, _JAX_PARAMS[self.cfg.model.name])
        self.reset_optimizer_state()
        if self.strategy.kind == "event":
            self._init_event_state()

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)


def _port_run(cfg, steps=None, **kw):
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu", **kw)
    tr.init_state()
    return tr, tr.run(cfg.total_steps if steps is None else steps)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX per-arrival (chunk_size=1) run of every ``_TRAIN`` case."""
    out = {}
    for key, (arch, agg) in _TRAIN.items():
        cfg = _jax_cfg(arch, agg)
        _jax_params(cfg.model)
        out[key] = jloop.run_experiment(cfg, latency=JUniform(1.0, 2.0))
    return out


@pytest.fixture(scope="module")
def per_arrival_runs(jax_runs):
    """The port's per-arrival run of every ``_TRAIN`` case, from the JAX
    init."""
    mp = pytest.MonkeyPatch()
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, _JAX_PARAMS[self.cfg.model.name])
        self.reset_optimizer_state()
        self._init_event_state()

    mp.setattr(tloop.Trainer, "init_state", init_state)
    try:
        return {key: _port_run(port_config(_jax_cfg(arch, agg)))
                for key, (arch, agg) in _TRAIN.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("key", list(_TRAIN))
def test_per_arrival_trainer_matches_jax(jax_runs, per_arrival_runs, key):
    want = jax_runs[key]
    _, got = per_arrival_runs[key]
    assert got.steps == want.steps == 7
    assert len(got.metrics) == len(want.metrics) == 7
    for a, b in zip(got.metrics, want.metrics):
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k != "loss"} == \
            {k: v for k, v in b.items() if k != "loss"}
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    assert got.sim_time == want.sim_time
    assert got.mean_selected == want.mean_selected
    assert got.mean_staleness == want.mean_staleness
    _assert_close_per_tensor(got.params, want.params)
    _assert_close_per_tensor(got.ema, want.ema)


@pytest.mark.parametrize("key", list(_TRAIN))
def test_chunked_event_path_bit_equal_to_per_arrival(per_arrival_runs,
                                                     jax_init, tmp_path, key):
    """Chunk 4 with a checkpoint every 5 updates (chunks of 4, 1, 2)."""
    arch, agg = _TRAIN[key]
    tr1, r1 = per_arrival_runs[key]
    tr2, r2 = _port_run(port_config(_jax_cfg(
        arch, agg, 4, directory=str(tmp_path), every=5)))
    assert r2.metrics == r1.metrics
    assert (r2.sim_time, r2.mean_selected, r2.mean_staleness, r2.arrivals) \
        == (r1.sim_time, r1.mean_selected, r1.mean_staleness, r1.arrivals)
    _assert_same(tr2.params, tr1.params)
    _assert_same(tr2.ema, tr1.ema)
    for s, sub in tr1.opt_state.items():
        _assert_same(tr2.opt_state[s], sub)
    if tr1.strategy.uses_clock:
        for w in range(tr1.strategy.total_workers):
            _assert_same({k: v[w] for k, v in tr2._workers_stacked.items()},
                         tr1._reads.read(w))


# ---------------------------------------------------------------------------
# The §2.1 rig: MNIST-like data and the weight-normalised CNN
# ---------------------------------------------------------------------------

_WIDTHS = (4, 4, 8, 8)


def test_mnist_like_bit_equal_to_jax():
    kw = dict(num_train=96, num_test=32, seed=2)
    got = tmnist.make_dataset(tmnist.MnistLikeConfig(**kw))
    want = jmnist.make_dataset(jmnist.MnistLikeConfig(**kw))
    for g, w in zip(got, want):
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    for g, w in zip(tmnist.batches(got[0], 16, seed=3, steps=4),
                    jmnist.batches(want[0], 16, seed=3, steps=4)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _jax_cnn():
    """The JAX MnistCNN with a jitted init (the eager one compiles each
    truncated normal on its own: ~10 s on the CPU) and its params."""
    jmodel = jcnn.make(widths=_WIDTHS)
    jmodel.init = jax.jit(jmodel.init)
    _JAX_PARAMS["mnist_cnn"] = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, _JAX_PARAMS["mnist_cnn"]


def test_mnist_cnn_matches_jax():
    train, _ = jmnist.make_dataset(jmnist.MnistLikeConfig(num_train=32,
                                                          num_test=8))
    jmodel, params = _jax_cnn()
    model = load_jax_params(tcnn.make(widths=_WIDTHS, device="cpu"), params)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    batch = {k: v[:16] for k, v in train.items()}
    logits, loss = jax.jit(lambda p, b: (
        jmodel.forward(p, b["images"]), jmodel.per_example_loss(p, b)))(
            params, batch)
    np.testing.assert_allclose(model(batch["images"]).detach().numpy(),
                               np.asarray(logits), atol=1e-5, rtol=0)
    np.testing.assert_allclose(model.per_example_loss(batch).detach().numpy(),
                               np.asarray(loss), atol=1e-5, rtol=0)


def _mnist_rig():
    data_cfg = jmnist.MnistLikeConfig(num_train=256, num_test=64)
    train, _ = jmnist.make_dataset(data_cfg)

    def batch_fn(worker, draw):
        idx = np.random.RandomState(draw).randint(0, data_cfg.num_train,
                                                  size=16)
        return {"images": train["images"][idx],
                "labels": train["labels"][idx]}

    def cfg(chunk):
        return dataclasses.replace(
            _jax_cfg("qwen3-0.6b", dict(strategy="staleness", num_workers=1,
                                        staleness_tau=2,
                                        staleness_ramp_steps=5),
                     chunk, steps=10),
            model=jbase.ModelConfig(name="mnist_cnn"),
            shape=jbase.ShapeConfig("mnist", 1, 16, "train"))
    return batch_fn, cfg


def test_mnist_staleness_rig_through_run_experiment(jax_init):
    batch_fn, cfg = _mnist_rig()
    jmodel, _ = _jax_cnn()
    want = jloop.run_experiment(
        cfg(1), model=jmodel,
        batch_fn=lambda w, d: {k: jnp.asarray(v)
                               for k, v in batch_fn(w, d).items()})
    runs = [tloop.run_experiment(port_config(cfg(chunk)), device="cpu",
                                 model=tcnn.make(widths=_WIDTHS,
                                                 device="cpu"),
                                 batch_fn=batch_fn) for chunk in (1, 4)]
    assert runs[0].metrics == runs[1].metrics
    _assert_same(runs[0].params, runs[1].params)
    stal = [m["staleness"] for m in runs[0].metrics]
    assert stal == [m["staleness"] for m in want.metrics]
    assert max(stal) == 2.0
    for a, b in zip(runs[0].metrics, want.metrics):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    _assert_close_per_tensor(runs[0].params, want.params)
    with pytest.raises(ValueError, match="event strategies"):
        tloop.Trainer(port_config(dataclasses.replace(
            cfg(1), aggregation=jbase.AggregationConfig(strategy="backup",
                                                        num_workers=1))),
            device="cpu", batch_fn=batch_fn)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

_CKPT = {"async": ("qwen3-async", 1), "staleness-chunked": (
    "qwen3-staleness", 3)}


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
@pytest.mark.parametrize("case", list(_CKPT))
def test_event_checkpoints_interchange(jax_runs, per_arrival_runs, jax_init,
                                       tmp_path, case, direction):
    """4 updates in one package with a checkpoint at 4, the last 3 in the
    other, against the other package's straight 7 (the JAX one, or the
    port's per-arrival run: the chunked path is bit-equal to it)."""
    key, chunk = _CKPT[case]
    arch, agg = _TRAIN[key]
    # the JAX side runs per arrival (its chunked MNIST-rig test fails on
    # the seed, ROADMAP Queue 3); the port's side at ``chunk``
    jcfg = _jax_cfg(arch, agg, 1, directory=str(tmp_path), every=4)
    pcfg = port_config(dataclasses.replace(jcfg, chunk_size=chunk))
    if direction == "port-to-jax":
        _port_run(pcfg, 4)
        tr = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0))
        tr.restore_checkpoint()
        assert tr.step == 4
        res = tr.run(3)
        want = jax_runs[key]
        _assert_close_per_tensor(
            {k: torch.tensor(np.asarray(v, np.float32))
             for k, v in from_jax_tree(res.params).items()}, want.params)
    else:
        tr = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0))
        tr.init_state()
        tr.run(4)
        port = tloop.Trainer(pcfg, latency=Uniform(1.0, 2.0), device="cpu")
        port.reset_optimizer_state()
        port.restore_checkpoint()
        assert port.step == 4
        res = port.run(3)
        _assert_close_per_tensor(res.params,
                                 jax_runs[key].params)
    assert [m["staleness"] for m in res.metrics] == \
        [m["staleness"] for m in jax_runs[key].metrics[4:]]
    assert res.sim_time == jax_runs[key].sim_time


@pytest.mark.parametrize("key,chunk", [("qwen3-async", 1), ("qwen3-async", 3),
                                       ("qwen3-staleness", 1),
                                       ("qwen3-staleness", 3)])
def test_event_resume_equals_straight_run(per_arrival_runs, jax_init,
                                          tmp_path, key, chunk):
    arch, agg = _TRAIN[key]
    cfg = port_config(_jax_cfg(arch, agg, chunk, directory=str(tmp_path),
                               every=2))
    _port_run(cfg, 4)
    resumed = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    resumed.reset_optimizer_state()
    resumed.restore_checkpoint(4)
    res = resumed.run(3)
    tr1, r1 = per_arrival_runs[key]
    assert res.metrics == r1.metrics[4:]
    assert res.sim_time == r1.sim_time
    _assert_same(res.params, tr1.params)
    _assert_same(res.ema, tr1.ema)


def test_checkpoint_inside_a_softsync_window_is_refused(tmp_path):
    cfg = port_config(_jax_cfg("qwen3-0.6b", dict(
        strategy="softsync", num_workers=2, softsync_c=3),
        directory=str(tmp_path)))
    tr, _ = _port_run(cfg, 1)
    tr._ev_state.pending_stals.append(0)
    with pytest.raises(RuntimeError, match="softsync window"):
        tr.save_checkpoint()


# ---------------------------------------------------------------------------
# CLI and refusals
# ---------------------------------------------------------------------------

_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) sim\s+(\S+)s "
                   r"selected (\d+) staleness (\S+)")


@pytest.mark.parametrize("extra,port_extra", [
    (["--strategy", "async"], []),
    (["--strategy", "softsync", "--softsync-c", "2"], []),
    (["--strategy", "async"], ["--chunk-size", "4"]),
], ids=["async", "softsync", "async-port-chunk4"])
def test_cli_event_strategies_match_jax_cli(tmp_path, capsys, monkeypatch,
                                            extra, port_extra):
    """The port's CLI (per arrival, or in chunks of 4 updates) against the
    JAX CLI per arrival, from the JAX init."""
    argv = ["--smoke", "--steps", "10", "--seq", "8", "--batch-per-worker",
            "1", "--workers", "4", "--optimizer", "momentum", "--lr", "0.05",
            "--ckpt-every", "4"] + extra
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):       # the JAX CLI's init, by key
        orig(self, seed)
        load_jax_params(self.model, jget_model(
            jconfigs.get_smoke_config("qwen3-0.6b")).init(
                jax.random.PRNGKey(self.cfg.seed)))
        self.reset_optimizer_state()
        self._init_event_state()

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)
    lines = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        dev = ["--device", "cpu"] + port_extra if tag == "torch" else []
        main(argv + dev + ["--ckpt", str(tmp_path / tag)])
        lines[tag] = _LINE.findall(capsys.readouterr().out)
    assert len(lines["torch"]) == len(lines["jax"]) == 1
    for got, want in zip(lines["torch"], lines["jax"]):
        assert got[0] == want[0] and got[2:] == want[2:]
        assert abs(float(got[1]) - float(want[1])) <= 2e-4


def _refusal_cfg(tmp_path, **change):
    return port_config(dataclasses.replace(_jax_cfg(
        "qwen3-0.6b", dict(strategy="async", num_workers=4),
        directory=str(tmp_path)), **change))


@pytest.mark.parametrize("change,match", [
    (dict(execution=jbase.ExecutionConfig(backend="spmd", grad_batch=1)),
     "no SPMD support"),
    (dict(straggler_backend="device"), "must be 'host'"),
])
def test_event_refusals(tmp_path, change, match):
    """As in the reference: the spmd backend warns and falls back to sim
    (the run equals a sim run), the device straggler backend raises its
    ValueError."""
    cfg = _refusal_cfg(tmp_path, **change)
    if "execution" not in change:
        with pytest.raises(ValueError, match=match):
            tloop.Trainer(cfg, device="cpu")
        return
    with pytest.warns(UserWarning, match=match):
        tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    assert not tr._spmd
    tr.init_state()
    _, sim = _port_run(_refusal_cfg(tmp_path / "sim"), steps=3)
    _assert_same(tr.run(3).params, sim.params)


def test_event_kill_injection_is_refused(tmp_path, jax_init):
    """A kill at update 2 (a list: worker 1) and update 4 (a scalar:
    worker 3) through ``kill_worker_at``, per arrival and chunked, against
    the JAX Trainer: the killed workers leave the scheduler."""
    kills = {2: [1], 4: 3}
    jcfg = _jax_cfg("qwen3-0.6b", dict(strategy="async", num_workers=4),
                    steps=6)
    _jax_params(jcfg.model)
    want = jloop.run_experiment(jcfg, latency=JUniform(1.0, 2.0),
                                kill_worker_at=kills)
    for chunk in (1, 3):
        tr = tloop.Trainer(port_config(dataclasses.replace(
            jcfg, chunk_size=chunk)), latency=Uniform(1.0, 2.0),
            device="cpu")
        tr.init_state()
        got = tr.run(6, kill_worker_at=kills)
        assert tr._event_dead == {1, 3}
        assert [(m["step"], m["sim_time"], m["staleness"])
                for m in got.metrics] == [(m["step"], m["sim_time"],
                                           m["staleness"])
                                          for m in want.metrics]
        np.testing.assert_allclose([m["loss"] for m in got.metrics],
                                   [m["loss"] for m in want.metrics],
                                   rtol=1e-5)
        _assert_close_per_tensor(got.params, want.params)


def test_plugin_without_the_scan_protocol_runs_per_arrival(tmp_path,
                                                           monkeypatch):
    """As in the reference: a warning at chunk_size > 1, then the
    per-arrival path."""

    @dataclasses.dataclass(frozen=True)
    class PlainAsync(tcoord.EventStrategy):
        num_workers: int
        name = "plain_async"

        @property
        def total_workers(self):
            return self.num_workers

        def on_arrival(self, state, grads, arrival):
            return tcoord.ReadyUpdate(grads, float(arrival.staleness), 1)

    monkeypatch.setitem(tregistry._BUILDERS, "plain_async",
                        lambda cfg: PlainAsync(cfg.num_workers))
    runs = []
    for chunk in (1, 3):
        cfg = dataclasses.replace(_refusal_cfg(tmp_path, chunk_size=chunk),
                                  aggregation=tbase.AggregationConfig(
                                      strategy="plain_async", num_workers=4))
        if chunk > 1:
            with pytest.warns(UserWarning, match="per-arrival path"):
                tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0),
                                   device="cpu")
            assert not tr._event_fused
        else:
            tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
        tr.init_state()
        runs.append(tr.run(3))
    assert runs[0].metrics == runs[1].metrics
    _assert_same(runs[0].params, runs[1].params)
