"""The device straggler backend on the CPU: ``repro_torch.core.
straggler_device``, ``data.synthetic_lm.device_batch_fn``, the mask
strategies' ``select_device`` and the trainer's device chunk.

* The four samplers at 2^23 f32 draws against the numpy ``LatencyModel``s
  (2^23 draws): mean, std and the 0.1 / 0.5 / 0.9 / 0.99 quantiles within
  rel 0.05 (a distribution match: the streams differ, as JAX's do; at
  2^20 draws PaperCalibrated's 0.99 quantile alone spreads by ~3% from
  seed to seed, so the gate would test the sample, not the sampler);
  ``sampler_for`` / ``register_sampler`` with the reference's error;
  ``step_arrivals`` with dead workers at +inf; a chunk's draws equal its
  steps drawn one by one.
* ``select_device`` against the JAX ``select_jax`` (vmapped) on the same
  f32 arrivals, with ties and +inf rows: masks bit-equal, times equal; and
  against the host ``select`` on the same values, row by row (and the
  JAX ``select_batch``).
* ``device_batch_fn``: at noise 0 the affine chain of ``_chain_tables``,
  the noise rate at 0.3, the reference's 46340 refusal.
* The trainer at ``straggler_backend='device'``: 8 steps as chunks of 4 + 4
  and as one of 8 bit-equal, a resume through a chunk bit-equal to the
  straight run, each step's ``selected`` and ``sim_time`` equal to the host
  ``BackupWorkers.select`` of the same draws; the reference's
  refusals with its messages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from benchmarks.common import tiny_lm_config as jtiny_lm_config
from repro.configs import base as jbase
from repro.core import coordination as jcoord
from repro.core import straggler_jax
from repro.data import synthetic_lm as jdata
from repro.train import loop as jloop

from repro_torch.core import coordination as tcoord
from repro_torch.core import straggler as tstraggler
from repro_torch.core import straggler_device as sd
from repro_torch.data import synthetic_lm as tdata
from repro_torch.train import loop as tloop
from torch_parity import port_config

N_DRAWS = 2 ** 23
MODELS = [
    tstraggler.Uniform(1.0, 2.0),
    tstraggler.LogNormal(median=1.4, sigma=0.15),
    tstraggler.PaperCalibrated(),
    tstraggler.DeterministicStragglers(slow_workers=(2,), slowdown=5.0),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _summary(x):
    x = np.asarray(x, np.float64).ravel()
    return [x.mean(), x.std()] + [np.quantile(x, q)
                                  for q in (0.1, 0.5, 0.9, 0.99)]


@pytest.mark.parametrize("model", MODELS, ids=lambda m: type(m).__name__)
def test_samplers_match_numpy_models(model):
    w = 8
    gen = torch.Generator().manual_seed(0)
    got = sd.sampler_for(model)(gen, (N_DRAWS // w, w))
    assert got.dtype == torch.float32 and bool((got > 0).all())
    want = model.sample(np.random.RandomState(0), (N_DRAWS // w, w))
    np.testing.assert_allclose(_summary(got.numpy()), _summary(want),
                               rtol=0.05)
    if isinstance(model, tstraggler.PaperCalibrated):
        assert float(got.max()) <= model.cap
    if isinstance(model, tstraggler.DeterministicStragglers):
        assert got[:, 2].mean() > 4 * got[:, 0].mean()


def test_sampler_registry():
    class Weird(tstraggler.LatencyModel):
        pass

    with pytest.raises(NotImplementedError) as got:
        sd.sampler_for(Weird())
    with pytest.raises(NotImplementedError) as want:
        straggler_jax.sampler_for(Weird())
    assert str(got.value) == str(want.value)

    class Constant(tstraggler.LatencyModel):
        pass

    sd.register_sampler(Constant, lambda m, gen, shape: torch.full(shape,
                                                                   2.5))
    out = sd.sampler_for(Constant())(torch.Generator(), (3,))
    np.testing.assert_allclose(out.numpy(), 2.5)


def test_step_arrivals_dead_and_chunk_partition():
    model = tstraggler.Uniform(1.0, 2.0)
    dead = torch.tensor([False, True, False, False])
    arr = sd.step_arrivals(model, 0, 3, 4, dead=dead, device="cpu")
    assert torch.isinf(arr[1]) and bool(torch.isfinite(arr[[0, 2, 3]]).all())
    fn = sd.sampler_for(model)
    whole = sd.chunk_arrivals(fn, 5, range(2, 10), 4, dead=[0, 0, 1, 0],
                              device="cpu")
    parts = torch.cat([sd.chunk_arrivals(fn, 5, range(2, 6), 4,
                                         dead=[0, 0, 1, 0], device="cpu"),
                       sd.chunk_arrivals(fn, 5, range(6, 10), 4,
                                         dead=[0, 0, 1, 0], device="cpu")])
    assert torch.equal(whole, parts)
    for i, s in enumerate(range(2, 10)):
        assert torch.equal(whole[i], sd.step_arrivals(
            model, 5, s, 4, dead=[0, 0, 1, 0], device="cpu"))
    assert not torch.equal(whole[0], whole[1])
    assert sd.mix_seed(0, sd.ARRIVAL_TAG, 1) != sd.mix_seed(
        0, sd.DATA_TAG, 1)


def _select_arrivals():
    """[K, 8] f32 rows: random, with ties, with dead +inf workers."""
    rng = np.random.RandomState(0)
    rows = rng.uniform(0.5, 5.0, size=(30, 8)).astype(np.float32)
    rows[5] = 1.0
    rows[6, ::2] = 2.0
    rows[7, [1, 4]] = np.inf
    rows[8, :] = np.round(rows[8] * 2) / 2
    rows[9, [0, 3, 5]] = np.inf
    rows[10, [2, 3]] = rows[10, 6]
    return rows


@pytest.mark.parametrize("name,args", [
    ("FullSync", (8,)), ("BackupWorkers", (6, 2)), ("BackupWorkers", (3, 5)),
    ("Timeout", (8, 0.5)), ("Timeout", (8, 0.0))])
def test_select_device_matches_select_jax(name, args):
    rows = _select_arrivals()
    jm, jt = jax.vmap(getattr(jcoord, name)(*args).select_jax)(
        jnp.asarray(rows))
    strategy = getattr(tcoord, name)(*args)
    tm, tt = strategy.select_device(torch.from_numpy(rows))
    assert tm.dtype == torch.bool and tt.dtype == torch.float32
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    host = [strategy.select(r) for r in rows.astype(np.float64)]
    np.testing.assert_array_equal(tm.numpy(), [m for m, _ in host])
    jhm, jht = getattr(jcoord, name)(*args).select_batch(
        rows.astype(np.float64))
    np.testing.assert_array_equal(tm.numpy(), jhm)
    np.testing.assert_array_equal([t for _, t in host], jht)


def test_device_batch_fn_chain_noise_and_refusal():
    cfg = tdata.SyntheticLMConfig(vocab_size=509, seq_len=24, global_batch=6,
                                  seed=3, noise=0.0)
    b = tdata.device_batch_fn(cfg, "cpu")(7)
    assert b["tokens"].dtype == torch.int32 and b["tokens"].shape == (6, 24)
    a, c = tdata._transition(509, 3)
    seq = torch.cat([b["tokens"], b["labels"][:, -1:]], 1).numpy()
    np.testing.assert_array_equal(seq[:, 1:], (a * seq[:, :-1] + c) % 509)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    again = tdata.device_batch_fn(cfg, "cpu")(7)
    assert torch.equal(again["tokens"], b["tokens"])
    assert not torch.equal(tdata.device_batch_fn(cfg, "cpu")(8)["tokens"],
                           b["tokens"])
    noisy = dataclasses.replace(cfg, noise=0.3, global_batch=512,
                                seq_len=128)
    nb = tdata.device_batch_fn(noisy, "cpu")(0)
    seq = torch.cat([nb["tokens"], nb["labels"][:, -1:]], 1).numpy()
    off = np.mean(seq[:, 1:] != (a * seq[:, :-1] + c) % 509)
    # a position breaks the chain when it or its predecessor is noise,
    # unless the noise hits the chain's own token
    assert abs(off - (1 - 0.7 ** 2)) < 0.01
    big = dataclasses.replace(cfg, vocab_size=46341)
    with pytest.raises(NotImplementedError) as got:
        tdata.device_batch_fn(big, "cpu")
    with pytest.raises(NotImplementedError) as want:
        jdata.device_batch_fn(jdata.SyntheticLMConfig(
            vocab_size=46341, seq_len=24, global_batch=6))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("call", [
    lambda: sd.step_arrivals(tstraggler.Uniform(1.0, 2.0), 0, 0, 4),
    lambda: sd.chunk_arrivals(sd.sampler_for(tstraggler.Uniform(1.0, 2.0)),
                              0, range(2), 4),
    lambda: tdata.device_batch_fn(tdata.SyntheticLMConfig(
        vocab_size=509, seq_len=24, global_batch=6)),
], ids=["step_arrivals", "chunk_arrivals", "device_batch_fn"])
def test_device_draws_default_to_the_card(monkeypatch, call):
    """Without ``device`` the draws go to the card, as the port's entry
    points do: with no card they raise, naming ``device='cpu'``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


# ---------------------------------------------------------------------------
# The trainer's device chunk
# ---------------------------------------------------------------------------


def _jcfg(tmp_path, chunk=4, every=0, steps=8, **change):
    cfg = jbase.TrainConfig(
        model=jtiny_lm_config(),
        shape=jbase.ShapeConfig("t", 8, 8, "train"),
        aggregation=jbase.AggregationConfig(strategy="backup", num_workers=6,
                                            backup_workers=2),
        optimizer=jbase.OptimizerConfig(name="rmsprop_momentum",
                                        learning_rate=0.005, eps=1e-3,
                                        scale_lr_with_workers=True,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(directory=str(tmp_path),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(grad_batch=1),
        seed=0, total_steps=steps, log_every=1, chunk_size=chunk,
        straggler_backend="device")
    return dataclasses.replace(cfg, **change)


def _run(cfg, steps, resume_at=None):
    tr = tloop.Trainer(port_config(cfg), device="cpu")
    tr.init_state()
    if resume_at is None:
        return tr, tr.run(steps)
    tr.run(resume_at)
    back = tloop.Trainer(port_config(cfg), device="cpu")
    back.reset_optimizer_state()
    back.restore_checkpoint()
    assert back.step == resume_at
    return back, back.run(steps - resume_at)


def _same(a, b):
    assert [(m["step"], m["selected"], m["sim_time"], m["loss"])
            for m in a.metrics] == [(m["step"], m["selected"], m["sim_time"],
                                     m["loss"]) for m in b.metrics]
    assert a.sim_time == b.sim_time and a.mean_selected == b.mean_selected
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    for k, v in a.ema.items():
        assert torch.equal(v, b.ema[k]), k


def test_device_chunks_partition_and_resume_bit_equal(tmp_path):
    """8 steps as 4 + 4 (the checkpoint cadence cuts the chunk of 8) and
    as one chunk of 8; a resume from the step-3 checkpoint through a
    chunk; each step's masks from the host rule on the same draws."""
    tr8, one = _run(_jcfg(tmp_path / "a", chunk=8), 8)
    _, two = _run(_jcfg(tmp_path / "b", chunk=8, every=4), 8)
    _same(one, two)
    back, res = _run(_jcfg(tmp_path / "c", chunk=4, every=3), 8, resume_at=3)
    assert [m["loss"] for m in res.metrics] == \
        [m["loss"] for m in one.metrics[3:]]
    assert res.sim_time == one.sim_time
    for k, v in res.params.items():
        assert torch.equal(v, one.params[k]), k
    assert back.pipeline.state.step == back.sim.step == 8
    strategy = tcoord.BackupWorkers(6, 2)
    arrivals = sd.chunk_arrivals(sd.sampler_for(tr8.latency), 0, range(8),
                                 8, device="cpu").numpy().astype(np.float64)
    host = [strategy.select(a) for a in arrivals]
    masks, times = [m for m, _ in host], [t for _, t in host]
    assert [m["selected"] for m in one.metrics] == \
        [int(r.sum()) for r in masks]
    total = 0.0
    for t in times:
        total += float(t)
    assert one.sim_time == total
    assert np.isfinite([m["loss"] for m in one.metrics]).all()


def test_device_chunk_with_dead_workers(tmp_path):
    """A worker killed before the chunk arrives at +inf and is never
    selected: the full-sync time is +inf, as in the reference."""
    tr = tloop.Trainer(port_config(_jcfg(tmp_path)), device="cpu")
    tr.init_state()
    tr.sim.kill_worker(3)
    res = tr.run(4)
    assert [m["selected"] for m in res.metrics] == [6] * 4
    full = tloop.Trainer(port_config(_jcfg(
        tmp_path, aggregation=jbase.AggregationConfig(
            strategy="full_sync", num_workers=8))), device="cpu")
    full.sim.kill_worker(0)
    arr = sd.chunk_arrivals(sd.sampler_for(full.latency), 0, range(2), 8,
                            dead=full.sim.dead, device="cpu")
    masks, times = full.strategy.select_device(arr)
    assert bool(masks.all()) and bool(torch.isinf(times).all())


@pytest.mark.parametrize("change,spec", [
    (dict(chunk_size=1), ""),
    (dict(execution=jbase.ExecutionConfig(backend="spmd", grad_batch=1)),
     ""),
    (dict(), "crash@3:w0"),
    (dict(aggregation=jbase.AggregationConfig(strategy="async",
                                              num_workers=4)), ""),
    (dict(aggregation=jbase.AggregationConfig(strategy="dynamic_backup",
                                              num_workers=6,
                                              backup_workers=2)), ""),
    (dict(straggler_backend="gpu"), ""),
], ids=["chunk1", "spmd", "faults", "event", "dynamic_backup", "unknown"])
def test_device_backend_refusals_match_jax(tmp_path, change, spec):
    jcfg = _jcfg(tmp_path, **change)
    jcfg = dataclasses.replace(jcfg, faults=jbase.FaultConfig(spec=spec))
    with pytest.raises(ValueError) as want:
        jloop.run_experiment(jcfg)
    with pytest.raises(ValueError) as got:
        tloop.run_experiment(port_config(jcfg), device="cpu")
    assert str(got.value) == str(want.value)
