"""The port's chunked trainer (ROADMAP Queue 1 item 3) on the CPU, against
its own per-step path and against the JAX reference's chunked loop.

On the card a chunk replays one captured CUDA graph per step; on the CPU
the same chunk step is a Python loop over the step, which is what runs
here (``tests/test_torch_cuda.py`` holds the graph to the eager loop).

* ``StragglerSimulator.next_events(k)`` against the JAX ``next_events(k)``
  and against k ``next_event()`` calls, for backup, full_sync and timeout
  with a dead worker: masks, times and arrivals bit-equal.
* ``chunk_batches`` and the ``ChunkPrefetcher`` (speculation hit, miss and
  fallback; depth 2 against depth 1) against the JAX versions and the
  per-step pipeline: bit-equal (the reference's
  ``tests/test_chunked_loop.py`` cases).
* The chunk path against the per-step path over 7 steps, qwen3 and rwkv6
  smoke, ``sim`` and ``spmd``, at chunk 4 with a checkpoint every step
  (chunks of one step), chunk 3 and chunk 4 with a checkpoint every 5
  (ragged chunks at the boundary): parameters, optimizer state, EMA,
  metrics, ``sim_time`` and the masks bit-equal. A run resumed from a
  checkpoint inside a chunked run equals the straight run; Adam's staged
  bias corrections are the per-step values and its chunked run equals its
  per-step run.
* The chunk path against the JAX ``chunk_size=4`` run (host backend,
  RMSProp eps 1e-3, the JAX init): ``selected`` and ``sim_time`` equal,
  losses within rtol 1e-5, parameters and EMA within atol 1e-5 (the
  tolerances of ``tests/test_torch_train.py``).
* The CLI at ``--chunk-size 4 --prefetch-depth 2`` (from the JAX init)
  prints the JAX CLI's step, ``sim_time`` and ``selected`` values, losses
  within 2e-4 (two units of the printed fourth decimal).
* Every optimizer gives the same update from staged 0-dim tensors as from
  floats; remat "dots" gives "full"'s and "none"'s loss and gradients bit
  for bit with fewer matmuls in backward, and no remat policy draws a
  random number; ``StepGraph`` refuses the CPU, and so does graph decode.
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
from repro.core import events as jevents
from repro.core import registry as jregistry
from repro.core.straggler import Uniform as JUniform
from repro.data import synthetic_lm as jdata
from repro.launch import train as jcli
from repro.models import get_model as jget_model
from repro.train import loop as jloop

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import registry as tregistry
from repro_torch.core import step_graph
from repro_torch.core.events import StragglerSimulator
from repro_torch.core.straggler import Uniform
from repro_torch.data import synthetic_lm as tdata
from repro_torch.kernels import counters
from repro_torch.launch import train as tcli
from repro_torch.models import from_jax_tree, get_model, load_jax_params
from repro_torch.optim import make_optimizer, schedules
from repro_torch.optim.optimizers import stage_scalars
from repro_torch.serve import ServeEngine
from repro_torch.train import loop as tloop
from torch_parity import port_config

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke-size trainer runs here take one intra-op thread each: under
    the parallel tier-1 run, torch's default of one thread per core in every
    worker multiplies their time several-fold."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Events and batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["backup", "full_sync", "timeout"])
def test_next_events_match_jax_and_per_step(strategy):
    agg = dict(strategy=strategy, num_workers=5, backup_workers=2,
               deadline_s=0.3)
    sims = [StragglerSimulator(tregistry.get_strategy(
                tbase.AggregationConfig(**agg)), Uniform(1.0, 2.0), seed=3)
            for _ in range(2)]
    jsim = jevents.StragglerSimulator(jregistry.get_strategy(
        jbase.AggregationConfig(**agg)), JUniform(1.0, 2.0), seed=3)
    for s in sims + [jsim]:
        s.kill_worker(1)
    for start, k in ((0, 4), (4, 1), (5, 6)):
        got, want = sims[0].next_events(k), jsim.next_events(k)
        steps = [sims[1].next_event() for _ in range(k)]
        assert got.start_step == want.start_step == start
        for a, b in ((got.masks, want.masks), (got.times, want.times),
                     (got.arrivals, want.arrivals)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.masks, [e.mask for e in steps])
        np.testing.assert_array_equal(got.times,
                                      [e.iteration_time for e in steps])
        np.testing.assert_array_equal(got.arrivals,
                                      [e.arrivals for e in steps])
        assert not got.masks[:, 1].any()


def _data_cfgs():
    kw = dict(vocab_size=64, seq_len=8, global_batch=8, num_workers=2)
    return tdata.SyntheticLMConfig(**kw), jdata.SyntheticLMConfig(**kw)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_chunk_batches_match_jax_and_per_step():
    tcfg, jcfg = _data_cfgs()
    chunk = tdata.chunk_batches(tcfg, 5, 3)
    assert chunk["tokens"].shape == (3, 8, 8)
    _same(chunk, jdata.chunk_batches(jcfg, 5, 3))
    for i, s in enumerate(range(5, 8)):
        _same({k: v[i] for k, v in chunk.items()},
              tdata.global_batch(tcfg, s))


def test_prefetcher_speculation_and_fallback():
    tcfg, jcfg = _data_cfgs()
    pf = tdata.ChunkPrefetcher(tcfg)
    for step in (0, 4, 8):                  # hints hit
        _same(pf.get(step, 4, next_k=4), jdata.chunk_batches(jcfg, step, 4))
    # a misprediction (another step and length) falls back, still right
    _same(pf.get(17, 3, next_k=5), jdata.chunk_batches(jcfg, 17, 3))
    _same(pf.get(20, 5), jdata.chunk_batches(jcfg, 20, 5))   # ragged hit
    assert not pf._pending                  # no hint: nothing in flight
    with pytest.raises(ValueError, match="depth"):
        tdata.ChunkPrefetcher(tcfg, depth=-1)


def test_prefetcher_depth_two_identical_batches():
    tcfg, jcfg = _data_cfgs()
    walk = [(0, 4), (4, 4), (8, 2), (10, 4), (14, 4),   # ragged boundary
            (21, 3), (24, 3)]                           # misprediction jump
    pf1 = tdata.ChunkPrefetcher(tcfg, depth=1)
    pf2 = tdata.ChunkPrefetcher(tcfg, depth=2)
    jpf = jdata.ChunkPrefetcher(jcfg, depth=2)
    for i, (step, k) in enumerate(walk):
        ahead = walk[i + 1:i + 3]
        got1 = pf1.get(step, k, next_specs=ahead[:1])
        got2 = pf2.get(step, k, next_specs=ahead)
        _same(got1, got2)
        _same(got2, jpf.get(step, k, next_specs=ahead))
    assert len(pf2._pending) <= 2


# ---------------------------------------------------------------------------
# The chunk path against the per-step path
# ---------------------------------------------------------------------------


def _cfg(arch, backend, chunk, *, every=0, directory="", optimizer=None):
    return tbase.TrainConfig(
        model=dataclasses.replace(tconfigs.get_smoke_config(arch),
                                  remat="full"),
        shape=tbase.ShapeConfig("t", 16, 12, "train"),
        aggregation=tbase.AggregationConfig(strategy="backup", num_workers=4,
                                            backup_workers=2),
        optimizer=optimizer or tbase.OptimizerConfig(
            name="momentum", learning_rate=0.05, scale_lr_with_workers=False,
            ema_decay=0.99),
        checkpoint=tbase.CheckpointConfig(directory=directory,
                                          every_steps=every),
        execution=tbase.ExecutionConfig(backend=backend, grad_batch=1),
        seed=0, log_every=1, chunk_size=chunk, prefetch_depth=2)


def _run(cfg, steps, masks=None):
    """A trainer's run; ``masks`` collects the mask every step was given."""
    tr = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    if masks is not None:
        step = tr.chunk_step if cfg.chunk_size > 1 else tr.train_step

        def spy(*args):
            m = args[4]
            masks.extend(m if m.dim() == 2 else [m])
            return step(*args)

        setattr(tr, "chunk_step" if cfg.chunk_size > 1 else "train_step",
                spy)
    return tr, tr.run(steps)


def _assert_same_state(a, b):
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    assert sorted(a.opt_state) == sorted(b.opt_state)
    for s, sub in a.opt_state.items():
        for k, v in sub.items():
            assert torch.equal(v, b.opt_state[s][k]), (s, k)
    for k, v in a.ema.items():
        assert torch.equal(v, b.ema[k]), k


@pytest.fixture(scope="module")
def per_step_runs(tmp_path_factory):
    """The per-step reference run of each (arch, backend), 7 steps."""
    out = {}
    for arch in ("qwen3-0.6b", "rwkv6-1.6b"):
        for backend in ("sim", "spmd"):
            masks = []
            out[arch, backend] = (*_run(_cfg(arch, backend, 1), 7, masks),
                                  masks)
    return out


@pytest.mark.parametrize("chunk,every", [(4, 1), (3, 5), (4, 5)],
                         ids=["k1", "k3-ragged", "k4-ragged"])
@pytest.mark.parametrize("backend", ["sim", "spmd"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_chunk_path_bit_equal_to_per_step(per_step_runs, tmp_path, arch,
                                          backend, chunk, every):
    tr1, r1, masks1 = per_step_runs[arch, backend]
    masks = []
    tr2, r2 = _run(_cfg(arch, backend, chunk, every=every,
                        directory=str(tmp_path)), 7, masks)
    assert r2.metrics == r1.metrics
    assert r2.sim_time == r1.sim_time and r2.steps == 7
    assert r2.mean_selected == r1.mean_selected
    assert len(masks) == len(masks1) == 7
    for a, b in zip(masks, masks1):
        assert torch.equal(a, b)
    _assert_same_state(tr1, tr2)


@pytest.mark.parametrize("backend", ["sim", "spmd"])
def test_resume_inside_a_chunked_run_equals_straight(tmp_path, backend):
    cfg = _cfg("qwen3-0.6b", backend, 3, every=2, directory=str(tmp_path))
    straight, res = _run(cfg, 7)
    resumed = tloop.Trainer(cfg, latency=Uniform(1.0, 2.0), device="cpu")
    resumed.reset_optimizer_state()
    resumed.restore_checkpoint(4)
    assert resumed.step == 4
    res2 = resumed.run(3)
    assert res2.sim_time == res.sim_time
    assert res2.metrics == res.metrics[4:]
    _assert_same_state(straight, resumed)


def test_adam_staged_bias_corrections(tmp_path):
    ocfg = tbase.OptimizerConfig(name="adam", learning_rate=0.01,
                                 scale_lr_with_workers=False,
                                 steps_per_epoch=3, ema_decay=0.99)
    opt = make_optimizer(ocfg, schedules.from_config(ocfg))
    steps = list(range(5, 12))
    staged = stage_scalars(opt, steps, "cpu")
    assert sorted(staged) == ["bc1", "bc2", "lr"]
    for i, s in enumerate(steps):
        per_step = opt.scalars(s)
        # the reference's f32 math on the device, 1 - beta ** (step + 1)
        # (f32 pow on either side: may differ in the last ulp)
        t = jnp.asarray(s, jnp.float32) + 1.0
        for name, beta in (("bc1", 0.9), ("bc2", 0.999)):
            np.testing.assert_allclose(per_step[name],
                                       float(1 - jnp.float32(beta) ** t),
                                       rtol=2e-7)
        for name, v in staged.items():
            assert v.dtype == torch.float32 and v[i].item() == per_step[name]
    runs = [_run(_cfg("qwen3-0.6b", "sim", chunk, optimizer=ocfg,
                      every=4, directory=str(tmp_path / str(chunk))), 6)
            for chunk in (1, 4)]
    assert runs[0][1].metrics == runs[1][1].metrics
    _assert_same_state(runs[0][0], runs[1][0])


@pytest.mark.parametrize("name", ["sgd", "momentum", "rmsprop_momentum",
                                  "rmsprop", "adam", "adagrad"])
def test_optimizers_take_staged_scalars(name):
    """``make_optimizer``'s every optimizer: the step from staged 0-dim f32
    tensors equals the step from the host floats, bit for bit."""
    ocfg = tbase.OptimizerConfig(name=name, learning_rate=0.01,
                                 steps_per_epoch=3, weight_decay=0.01)
    opt = make_optimizer(ocfg, schedules.from_config(ocfg, 4))
    rng = np.random.RandomState(0)
    p0 = {k: rng.randn(*s).astype(np.float32)
          for k, s in {"a": (5, 3), "b": (7,)}.items()}
    trees = [{k: torch.from_numpy(v.copy()) for k, v in p0.items()}
             for _ in range(2)]
    states = [opt.init(t) for t in trees]
    staged = stage_scalars(opt, range(4), "cpu")
    for step in range(4):
        g = {k: torch.from_numpy(0.1 * rng.randn(*v.shape).astype(
            np.float32)) for k, v in p0.items()}
        opt.apply(trees[0], g, states[0], opt.scalars(step))
        opt.apply(trees[1], g, states[1],
                  {n: v[step] for n, v in staged.items()})
    for k in p0:
        assert torch.equal(trees[0][k], trees[1][k])
        for s in states[0]:
            assert torch.equal(states[0][s][k], states[1][s][k])


# ---------------------------------------------------------------------------
# Against the JAX chunked loop
# ---------------------------------------------------------------------------


def _jax_cfg(backend, chunk):
    return jbase.TrainConfig(
        model=dataclasses.replace(jconfigs.get_smoke_config("qwen3-0.6b"),
                                  remat="full"),
        shape=jbase.ShapeConfig("t", 16, 2 * 8, "train"),
        aggregation=jbase.AggregationConfig(strategy="backup", num_workers=6,
                                            backup_workers=2),
        # eps 1e-3 for the reason tests/test_torch_train.py gives
        optimizer=jbase.OptimizerConfig(name="rmsprop_momentum",
                                        learning_rate=0.005, eps=1e-3,
                                        scale_lr_with_workers=True,
                                        ema_decay=0.99),
        checkpoint=jbase.CheckpointConfig(every_steps=0),
        execution=jbase.ExecutionConfig(backend=backend, use_kernel=True,
                                        grad_batch=1),
        seed=0, total_steps=4, log_every=1, chunk_size=chunk)


@pytest.mark.parametrize("backend", ["sim", "spmd"])
def test_chunk_path_matches_jax_chunk(monkeypatch, backend):
    jcfg = _jax_cfg(backend, 4)
    params = jget_model(jcfg.model).init(jax.random.PRNGKey(0))
    jres = jloop.run_experiment(jcfg)
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, params)
        self.reset_optimizer_state()

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)
    cfg = port_config(jcfg)
    cfg = dataclasses.replace(cfg, execution=dataclasses.replace(
        cfg.execution, use_kernel=None))
    tres = tloop.run_experiment(cfg, device="cpu")
    assert [m["selected"] for m in tres.metrics] == \
        [m["selected"] for m in jres.metrics]
    assert [m["sim_time"] for m in tres.metrics] == \
        [m["sim_time"] for m in jres.metrics]
    assert tres.sim_time == jres.sim_time
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics], rtol=1e-5)
    np.testing.assert_allclose([m["lr"] for m in tres.metrics],
                               [m["lr"] for m in jres.metrics], rtol=0)
    for got, want in ((tres.params, jres.params), (tres.ema, jres.ema)):
        want = from_jax_tree(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]),
                                       atol=ATOL, rtol=0, err_msg=k)


_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) sim\s+(\S+)s "
                   r"selected (\d+)")


def test_cli_chunk_size_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """The README's backup 6 + 2 run through the CLI at --chunk-size 4
    (qwen3 smoke, momentum, 10 steps in chunks of 4, 4 and 2: the line of
    step 10) against the JAX CLI with the same flags, the port starting
    from the JAX init (ROADMAP Queue 1 item 4's acceptance at chunk K, on
    the CPU)."""
    argv = ["--smoke", "--steps", "10", "--seq", "8", "--batch-per-worker",
            "1", "--strategy", "backup", "--workers", "6", "--backups", "2",
            "--optimizer",
            "momentum", "--lr", "0.05", "--ckpt-every", "4", "--chunk-size",
            "4", "--prefetch-depth", "2"]
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):       # the JAX CLI's init, by key
        orig(self, seed)
        jcfg = jconfigs.get_smoke_config("qwen3-0.6b")
        load_jax_params(self.model, jget_model(jcfg).init(
            jax.random.PRNGKey(self.cfg.seed)))
        self.reset_optimizer_state()

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)
    lines = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        extra = ["--device", "cpu"] if tag == "torch" else []
        main(argv + extra + ["--ckpt", str(tmp_path / tag)])
        lines[tag] = _LINE.findall(capsys.readouterr().out)
    assert len(lines["torch"]) == len(lines["jax"]) == 1
    for got, want in zip(lines["torch"], lines["jax"]):
        assert (got[0], got[2], got[3]) == (want[0], want[2], want[3])
        assert abs(float(got[1]) - float(want[1])) <= 2e-4


# ---------------------------------------------------------------------------
# Remat, RNG, the graph helper on the CPU
# ---------------------------------------------------------------------------


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
def test_remat_dots_equals_full_and_none(arch):
    """Loss and gradients bit-equal across the three policies (f32, CPU);
    'dots' recomputes no matmul in backward ('full' recomputes them all);
    no policy draws a random number."""
    base = tconfigs.get_smoke_config(arch)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, base.vocab_size, (2, 16)),
             "labels": rng.randint(0, base.vocab_size, (2, 16))}
    runs = {}
    for remat in ("none", "full", "dots"):
        model = get_model(dataclasses.replace(base, remat=remat),
                          device="cpu",
                          generator=torch.Generator().manual_seed(1))
        rng_before = torch.get_rng_state()
        per_tok, _ = model.per_token_loss(batch)
        with _CountMM() as count:
            per_tok.mean().backward()
        assert torch.equal(torch.get_rng_state(), rng_before)
        runs[remat] = (per_tok.detach(), dict(model.named_parameters()),
                       count.mm)
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0])
        for k, p in runs[remat][1].items():
            assert torch.equal(p.grad, runs["none"][1][k].grad), (remat, k)
    assert runs["dots"][2] == runs["none"][2] < runs["full"][2]


def test_graphs_refuse_the_cpu():
    with pytest.raises(ValueError, match="on the card"):
        step_graph.StepGraph(lambda static: {}, "cpu")
    cfg = tconfigs.get_smoke_config("qwen3-0.6b")
    model = get_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="on the card"):
        ServeEngine(cfg, model, device="cpu", decode_graph=True)


def test_launch_counts_move_as_one_vector(monkeypatch):
    from repro_torch.kernels import backup_reduce, rwkv6_scan
    monkeypatch.setattr(backup_reduce, "launches", 5)
    monkeypatch.setattr(rwkv6_scan, "launches_bwd", 7)
    before = counters.read()
    n = len(counters.COUNTERS)  # the kernels', tp.all_reduces, all_gathers
    assert n == 8
    counters.add(tuple(i + 1 for i in range(n)))
    assert counters.since(before) == tuple(range(1, n + 1))
    assert backup_reduce.launches == 8 and rwkv6_scan.launches_bwd == 13
    counters.write(before)
    assert counters.read() == before
