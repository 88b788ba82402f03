"""The port's fault tolerance against the JAX reference, on the CPU.

The chaos engine (``repro_torch.core.faults``), the trainer's fault path,
the elastic rescale, the recovery supervisor, ``dynamic_backup`` and the
measured-latency pieces (``repro_torch.obs``), each held to the
reference:

* ``plan_from_spec`` on every case of ``tests/test_faults.py``'s grammar:
  the same plan, or the same error text; the injector's
  ``upcoming_steps``, ``take_due`` and ``defer`` step for step;
* faulted runs (crashes, a slowdown, a restart, ``ckpt_io``, ``preempt``,
  a rescale when the live workers fall below N) in mask mode (sim per
  step and chunked, spmd at mesh 1 x 1) and event mode (async per arrival
  and chunked), plain and under ``run_supervised``: the recovery log
  bit-identical to the JAX Trainer's, ``selected`` and ``sim_time``
  equal, losses and the final parameters and EMA within rtol 2e-4 / atol
  2e-5 (the port starting from the JAX init);
* ``kill_worker_at`` with lists and scalars, and ``Trainer.rescale``
  (plan, config and state) against JAX;
* the supervisor on the cases of ``tests/test_supervisor.py`` (port
  only, the reference test's assertions);
* ``dynamic_backup``: adapted n and ``state_dict`` equal to JAX's on the
  same rows, a run's n at the same seed, resume keeps n, the device
  backend refused; ``windowed_quantile`` / ``WindowedQuantile`` /
  ``EmpiricalLatencyModel`` bit-equal;
* a crash and a slowdown at ``mesh_data`` 2 over two spawned gloo ranks
  (``tests/torch_mesh_ranks.py``) against the JAX sim Trainer, and a
  rescale there that shrinks the data axis (2 -> 1, rank 1 idle, through
  checkpoints, a preemption and the supervisor's restore);
* ``run_supervised(tracer=, metrics=)`` against the JAX supervisor's
  trace and registry;
* the CLI with ``--faults ... --supervise`` against the JAX CLI;
* ``chip_smoke.py`` phase 21's recovery-log literal, from JAX and the
  port on its plan and layout.
"""
import dataclasses
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from benchmarks.common import tiny_lm_config as jtiny_lm_config
from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import faults as jfaults
from repro.core import registry as jregistry
from repro.core.straggler import DeterministicStragglers as JDeterministic
from repro.core.straggler import Uniform as JUniform
from repro.launch import train as jcli
from repro.models import get_model as jget_model
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Tracer as JTracer
from repro.obs import latency as jlatency
from repro.obs import quantiles as jquantiles
from repro.train import elastic as jelastic
from repro.train import loop as jloop
from repro.train import supervisor as jsupervisor

from repro_torch.core import faults as tfaults
from repro_torch.core import registry as tregistry
from repro_torch.core.coordination import DynamicBackup
from repro_torch.core.straggler import DeterministicStragglers, Uniform
from repro_torch.distributed import mesh
from repro_torch.launch import train as tcli
from repro_torch import obs as tobs
from repro_torch.models import from_jax_tree, load_jax_params
from repro_torch.obs import latency as tlatency
from repro_torch.obs import quantiles as tquantiles
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic
from repro_torch.train import loop as tloop
from repro_torch.train import supervisor as tsupervisor
import torch_mesh_ranks as ranks
from torch_parity import port_config

RTOL, ATOL = 2e-4, 2e-5
SPEC = "crash@5:w1,slow@3:w0,ckpt_io@7,preempt@10"
# crashes past the backup pool: a rescale at step 9
RESCALE_SPEC = "crash@3:w1,slow@2:w0:x3:d4,crash@6:w2,crash@9:w3"
EVENT_SPEC = "crash@5:w1,slow@3:w0,restart@9:w1,preempt@12"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_JPARAMS = {}


def _jax_params(model_cfg=None, seed=0):
    """The JAX init of the tiny model (or of the qwen3 smoke model, whose
    port config is ``model_cfg``) from ``seed``."""
    jcfg = jtiny_lm_config()
    smoke = jconfigs.get_smoke_config("qwen3-0.6b")
    if model_cfg is not None and (model_cfg.vocab_size, model_cfg.d_model) \
            == (smoke.vocab_size, smoke.d_model):
        jcfg = smoke
    key = (repr(jcfg), seed)
    if key not in _JPARAMS:
        _JPARAMS[key] = jget_model(jcfg).init(jax.random.PRNGKey(seed))
    return _JPARAMS[key]


@pytest.fixture(autouse=True)
def _jax_init(monkeypatch):
    """The port's ``init_state`` loads the JAX init of its model (the
    optimizer state and the EMA re-initialized from it), as the JAX
    Trainer draws it from the seed."""
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, _jax_params(
            self.cfg.model, self.cfg.seed if seed is None else seed))
        self.reset_optimizer_state()
        if self.strategy.kind == "event":
            self._init_event_state()       # the read copies of that init

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)


def _jcfg(tmp_path, strategy="backup", spec="", chunk=4, steps=16,
          every=4, backend="sim", max_restarts=3, workers=4, **agg):
    """The reference tests' config (``tests/test_faults.py``'s ``_cfg``),
    with EMA so the comparison covers it."""
    if strategy in ("backup", "dynamic_backup"):
        agg.setdefault("backup_workers", 2)
    return jbase.TrainConfig(
        model=jtiny_lm_config(),
        shape=jbase.ShapeConfig("t", 8, 12, "train"),
        aggregation=jbase.AggregationConfig(strategy=strategy,
                                            num_workers=workers, **agg),
        optimizer=jbase.OptimizerConfig(name="sgd", learning_rate=0.1,
                                        scale_lr_with_workers=False,
                                        ema_decay=0.9),
        checkpoint=jbase.CheckpointConfig(
            directory=os.path.join(str(tmp_path), "ck"), every_steps=every,
            retry_backoff_s=0.0),
        execution=jbase.ExecutionConfig(backend=backend, use_kernel=True,
                                        grad_batch=1),
        seed=0, total_steps=steps, chunk_size=chunk, log_every=1,
        faults=jbase.FaultConfig(spec=spec, seed=7,
                                 max_restarts=max_restarts))


def _tcfg(jcfg):
    cfg = port_config(jcfg)
    return dataclasses.replace(cfg, execution=dataclasses.replace(
        cfg.execution, use_kernel=None))


def _close_state(tres, jres):
    for got, want in ((tres.params, jres.params), (tres.ema, jres.ema)):
        want = from_jax_tree(want)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(want[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def _hold(tres, jres):
    """The port's run against the JAX run: log, steps, masks, time,
    losses and state."""
    assert tres.recovery_log == jres.recovery_log
    assert tres.steps == jres.steps and tres.restarts == jres.restarts
    assert [(m["step"], m["selected"], m["sim_time"]) for m in tres.metrics] \
        == [(m["step"], m["selected"], m["sim_time"]) for m in jres.metrics]
    assert tres.sim_time == jres.sim_time
    np.testing.assert_allclose([m["loss"] for m in tres.metrics],
                               [m["loss"] for m in jres.metrics],
                               rtol=RTOL, atol=ATOL)
    _close_state(tres, jres)


def _pair(jcfg, runner="experiment", **kw):
    """The same config through the JAX and the port entry point."""
    lat = dict(latency=JUniform(1.0, 2.0))
    tlat = dict(latency=Uniform(1.0, 2.0), device="cpu")
    tdir = jcfg.checkpoint.directory + "_torch"
    tcfg = _tcfg(dataclasses.replace(jcfg, checkpoint=dataclasses.replace(
        jcfg.checkpoint, directory=tdir)))
    if runner == "experiment":
        return (jloop.run_experiment(jcfg, **lat, **kw),
                tloop.run_experiment(tcfg, **tlat, **kw))
    return (jsupervisor.run_supervised(jcfg, **lat, **kw),
            tsupervisor.run_supervised(tcfg, **tlat, **kw))


# ---------------------------------------------------------------------------
# The chaos plan and the injector
# ---------------------------------------------------------------------------

PLAN_CASES = [
    ("crash@5:w1,slow@3:w0,ckpt_io@7,preempt@9", 20, 4, 0, 0),
    ("crash=2,slow=3", 50, 8, 11, 0),
    ("crash=2,slow=3", 50, 8, 12, 0),
    ("crash=1,ckpt_io=1,slow=1", 40, 6, 3, 0),
    ("kill@4:w2,slowdown@2:w1:x8:d5,restart@6:w2", 10, 4, 0, 0),
    ("crash@4:r1,slowdown@0:r0:x8:d32,restart@20:r1", 64, 3, 0, 3),
    ("crash=3", 50, 4, 5, 4),
    ("preempt=2,ckpt_io", 30, 6, 9, 0),
    ("meteor@3", 10, 2, 0, 0),
    ("crash@4:w1:r2", 10, 2, 0, 0),
    ("slow@4:x2:x3", 10, 2, 0, 0),
    ("crash@4:q7", 10, 2, 0, 0),
    ("crash@5:wa", 10, 2, 0, 0),
    ("meteor=2", 10, 2, 0, 0),
]


@pytest.mark.parametrize("spec,steps,workers,seed,replicas", PLAN_CASES)
def test_plan_from_spec_matches_jax(spec, steps, workers, seed, replicas):
    kw = dict(num_steps=steps, num_workers=workers, seed=seed,
              num_replicas=replicas)
    try:
        want = jfaults.plan_from_spec(spec, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.plan_from_spec(spec, **kw)
        assert str(got.value) == str(e)
        return
    got = tfaults.plan_from_spec(spec, **kw)
    assert got.seed == want.seed
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]


def test_fault_kinds_and_errors_match_jax():
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.RECOVERY_EVENTS == jfaults.RECOVERY_EVENTS
    with pytest.raises(ValueError) as want:
        jfaults.FaultEvent("meteor", 3)
    with pytest.raises(ValueError) as got:
        tfaults.FaultEvent("meteor", 3)
    assert str(got.value) == str(want.value)
    assert str(tfaults.Preemption(4, True)) == str(jfaults.Preemption(4, True))
    assert issubclass(tfaults.InjectedIOError, OSError)
    assert tfaults.build_injector(port_config(jbase.FaultConfig()),
                                  num_steps=4, num_workers=2) is None


def test_injector_schedule_matches_jax():
    """upcoming_steps / take_due / defer, with the slowdown windows, the
    checkpoint failures and the log, step for step."""
    spec = "slow@3:w0:d4,crash@5:w1,ckpt_io@6,restart@8:w1,preempt@9"
    injs = [m.FaultInjector(m.plan_from_spec(spec, num_steps=16,
                                             num_workers=4))
            for m in (jfaults, tfaults)]
    trace = [[], []]
    for inj, out in zip(injs, trace):
        for step in range(12):
            out.append(("upcoming", sorted(inj.upcoming_steps())))
            for ev in inj.take_due(step):
                out.append(("due", step, ev.kind, ev.step, ev.worker))
                if ev.kind == "slowdown":
                    inj.note_slowdown(step, ev.worker, ev.factor,
                                      ev.duration)
                elif ev.kind == "slow_end":
                    inj.note_slow_end(ev.worker)
                elif ev.kind == "crash":
                    inj.note_crash(step, ev.worker)
                elif ev.kind == "restart":
                    inj.note_restart(step, ev.worker)
                elif ev.kind == "ckpt_io":
                    inj.arm_ckpt_failures(step, ev.fails)
                    for attempt in range(ev.fails):
                        with pytest.raises(OSError):
                            inj.ckpt_io_check()
                        inj.on_ckpt_retry(step)(attempt, OSError())
                    inj.ckpt_io_check()
                elif ev.kind == "preempt" and step == 9:
                    inj.defer(ev, step + 2)
        out.append(("log", inj.log, sorted(inj.dead)))
    assert trace[0] == trace[1]


# ---------------------------------------------------------------------------
# Faulted runs against the JAX Trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,chunk", [("sim", 1), ("sim", 4),
                                           ("spmd", 4)])
def test_mask_chaos_matches_jax(tmp_path, backend, chunk):
    """Crashes past the backup pool (a rescale at step 9, 6 -> 3 workers)
    and a slowdown window, through ``run_experiment``."""
    jres, tres = _pair(_jcfg(tmp_path, spec=RESCALE_SPEC, chunk=chunk,
                             steps=10, backend=backend))
    assert [e["event"] for e in tres.recovery_log].count("rescale") == 1
    _hold(tres, jres)


@pytest.mark.parametrize("chunk", [1, 4])
def test_event_chaos_matches_jax(tmp_path, chunk):
    """Async W = 4: a crash leaves the scheduler, a slowdown scales service
    times, the restart revives the worker with the current parameters;
    per arrival and in planned chunks."""
    jres, tres = _pair(_jcfg(tmp_path, strategy="async",
                             spec="crash@5:w1,slow@3:w0,restart@9:w1",
                             chunk=chunk, steps=12))
    _hold(tres, jres)


@pytest.mark.parametrize("strategy,spec", [("backup", SPEC),
                                           ("async", EVENT_SPEC)])
def test_supervised_chaos_matches_jax(tmp_path, strategy, spec):
    """Under the supervisor: crash, slowdown, checkpoint write failures
    and a preemption (mask), crash, slowdown, restart and a preemption
    (event); the restore loses nothing."""
    jres, tres = _pair(_jcfg(tmp_path, strategy=strategy, spec=spec),
                       runner="supervised")
    events = [e["event"] for e in tres.recovery_log]
    assert "preempt" in events and "restore" in events
    _hold(tres, jres)


def test_chip_smoke_fault_log_matches_jax(tmp_path):
    """``chip_smoke.py`` phase 21's plan (``FAULT_SPEC``, fault seed 0) on
    its cell's layout (backup 6 + 2, 2 sequences a worker, chunks of 4,
    checkpoints every 4, ``FAULT_STEPS`` steps, ``run_supervised``) with
    the tiny model on the sim backend (the log holds steps and workers
    only, the same on spmd: ``test_mask_chaos_matches_jax``): the JAX and
    the port's recovery logs are both the literal ``FAULT_LOG`` the card's
    run is held to."""
    import chip_smoke
    jcfg = dataclasses.replace(
        _jcfg(tmp_path, spec=chip_smoke.FAULT_SPEC,
              steps=chip_smoke.FAULT_STEPS, workers=6, chunk=1),
        shape=jbase.ShapeConfig("t", 8, 16, "train"),
        faults=jbase.FaultConfig(spec=chip_smoke.FAULT_SPEC, seed=0))
    jres = jsupervisor.run_supervised(jcfg, latency=JUniform(1.0, 2.0))
    assert jres.recovery_log == chip_smoke.FAULT_LOG
    tcfg = _tcfg(dataclasses.replace(
        jcfg, chunk_size=4, checkpoint=dataclasses.replace(
            jcfg.checkpoint, directory=str(tmp_path / "t"))))
    _hold(tsupervisor.run_supervised(tcfg, latency=Uniform(1.0, 2.0),
                                     device="cpu"), jres)


def test_kill_worker_at_with_lists_matches_jax(tmp_path):
    """A correlated outage ({step: [w, w]}) and the scalar form, which
    leaves 3 of 6 workers alive: a rescale."""
    jres, tres = _pair(_jcfg(tmp_path, every=0, steps=8),
                       kill_worker_at={3: [4, 5], 5: 0})
    assert tres.restarts == 1
    _hold(tres, jres)


def test_event_kill_worker_at_matches_jax(tmp_path):
    jres, tres = _pair(_jcfg(tmp_path, strategy="async", every=0, steps=10,
                             chunk=4), kill_worker_at={3: [1, 2]})
    _hold(tres, jres)


def test_rescale_matches_jax(tmp_path):
    """``Trainer.rescale`` called directly: the plan, the new config and
    the state two steps later."""
    jcfg = _jcfg(tmp_path, every=0, steps=8, chunk=2)
    for n in (5, 3, 1):
        want = jelastic.plan_rescale(jcfg, n)
        got = telastic.plan_rescale(_tcfg(jcfg), n)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    jtr = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0))
    ttr = tloop.Trainer(_tcfg(dataclasses.replace(
        jcfg, checkpoint=dataclasses.replace(
            jcfg.checkpoint, directory=str(tmp_path / "t")))),
        latency=Uniform(1.0, 2.0), device="cpu")
    for tr in (jtr, ttr):
        tr.init_state()
        tr.run(3)
        tr.rescale(5)                    # rounds down to 4: 12 % 5 != 0
    assert ttr.cfg.aggregation == port_config(jtr.cfg.aggregation)
    assert ttr.cfg.aggregation.total_workers == 4 and ttr.restarts == 1
    assert ttr.step == jtr.step == 3
    _hold(ttr.run(2), jtr.run(2))


def test_faults_refusals_match_jax(tmp_path):
    """The reference's refusals with its messages: faults with the device
    backend, faults on a serial rig, rescale in event mode."""
    cases = [
        (dict(straggler_backend="device"), dict(spec="crash@3:w0"), "host"),
        (dict(), dict(strategy="staleness", spec="crash@3:w0", chunk=1,
                      staleness_tau=1), "serial"),
    ]
    for change, kw, match in cases:
        jcfg = dataclasses.replace(_jcfg(tmp_path, **kw), **change)
        with pytest.raises(ValueError, match=match) as want:
            jloop.run_experiment(jcfg, latency=JUniform(1.0, 2.0))
        with pytest.raises(ValueError) as got:
            tloop.run_experiment(_tcfg(jcfg), latency=Uniform(1.0, 2.0),
                                 device="cpu")
        assert str(got.value) == str(want.value)
    tr = tloop.Trainer(_tcfg(_jcfg(tmp_path, strategy="async")),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="mask strategies only"):
        tr.rescale(2)


# ---------------------------------------------------------------------------
# The supervisor (tests/test_supervisor.py's cases)
# ---------------------------------------------------------------------------


def _sup_cfg(tmp_path, **kw):
    return _tcfg(_jcfg(tmp_path, **kw))


def _run_sup(cfg, **kw):
    return tsupervisor.run_supervised(cfg, latency=Uniform(1.0, 2.0),
                                      device="cpu", **kw)


def test_preempt_without_grace_restores_last_cadence_checkpoint(tmp_path):
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        (tfaults.FaultEvent("preempt", 10, grace=False),), seed=7))
    res = _run_sup(_sup_cfg(tmp_path), injector=inj)
    assert res.steps == 16
    restore = [e for e in res.recovery_log if e["event"] == "restore"]
    assert restore == [{"event": "restore", "step": 8, "attempt": 1}]


def test_restart_budget_exhaustion_gives_up(tmp_path):
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        tuple(tfaults.FaultEvent("preempt", s, grace=False)
              for s in (3, 5, 7)), seed=0))
    with pytest.raises(tfaults.Preemption) as ei:
        _run_sup(_sup_cfg(tmp_path, max_restarts=1, every=0), injector=inj)
    assert inj.log[-1]["event"] == "give_up"
    assert inj.log[-1]["restarts"] == 2
    assert ei.value.recovery_log == list(inj.log)
    assert any(e["event"] == "restore" for e in ei.value.recovery_log)


def test_recovery_without_any_checkpoint_restarts_fresh(tmp_path):
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        (tfaults.FaultEvent("preempt", 2, grace=False),), seed=0))
    res = _run_sup(_sup_cfg(tmp_path, every=0, steps=8), injector=inj)
    assert res.steps == 8
    assert {"event": "restore", "step": 0, "attempt": 1} in res.recovery_log


def test_ckpt_io_exhausting_retries_is_recovered(tmp_path):
    cfg = _sup_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, checkpoint=dataclasses.replace(
        cfg.checkpoint, write_retries=1))
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        (tfaults.FaultEvent("ckpt_io", 5, fails=5),), seed=0))
    res = _run_sup(cfg, injector=inj)
    assert res.steps == 16
    events = [e["event"] for e in res.recovery_log]
    assert "ckpt_io_fault" in events and "restore" in events
    assert any(e["event"] == "restore" and e["step"] <= 4
               for e in res.recovery_log)


def test_permanent_deaths_trigger_rescale_under_supervision(tmp_path):
    res = _run_sup(_sup_cfg(tmp_path,
                            spec="crash@3:w0,crash@5:w1,crash@7:w2"))
    assert res.steps == 16
    events = [e["event"] for e in res.recovery_log]
    assert events.count("worker_crash") == 3 and "rescale" in events
    [rs] = [e for e in res.recovery_log if e["event"] == "rescale"]
    assert rs["to_workers"] < rs["from_workers"]
    assert np.isfinite(res.metrics[-1]["loss"])


def test_corrupt_latest_checkpoint_walks_back_on_recovery(tmp_path):
    cfg = _sup_cfg(tmp_path)
    inj = tfaults.FaultInjector(tfaults.FaultPlan(
        (tfaults.FaultEvent("preempt", 10, grace=True),), seed=0))
    orig_record = inj.record

    def record_and_corrupt(event, **kw):
        if event == "preempt":
            with open(os.path.join(cfg.checkpoint.directory, "step_00000010",
                                   "arrays.npz"), "wb") as f:
                f.write(b"garbage")
        orig_record(event, **kw)

    inj.record = record_and_corrupt
    res = _run_sup(cfg, injector=inj)
    assert res.steps == 16
    [restore] = [e for e in res.recovery_log if e["event"] == "restore"]
    assert restore["step"] == 8


def test_supervisor_refuses_telemetry(tmp_path):
    """``run_supervised(tracer=, metrics=)`` hands both to every trainer it
    builds, as the reference does: one trace and one registry across the
    preemption and the restore, equal to the JAX supervisor's (the
    recovery log, the span-name multiset, the step count, the chunk
    histogram's count); the files they write read back."""
    got = {}
    for tag, sup, tracer, reg in (
            ("jax", jsupervisor.run_supervised, JTracer(), JMetricsRegistry()),
            ("torch", _run_sup, tobs.Tracer(), tobs.MetricsRegistry())):
        cfg = _jcfg(tmp_path / tag, spec=SPEC)
        if tag == "torch":
            res = sup(_tcfg(cfg), tracer=tracer, metrics=reg)
        else:
            res = sup(cfg, latency=JUniform(1.0, 2.0), tracer=tracer,
                      metrics=reg)
        tracer.export(str(tmp_path / f"{tag}.json"))
        reg.dump_jsonl(str(tmp_path / f"{tag}.jsonl"))
        rows = {r["name"]: r for r in tobs.load_jsonl(
            str(tmp_path / f"{tag}.jsonl"))}
        got[tag] = (res.recovery_log, sorted(
            e["name"] for e in tobs.load_trace(
                str(tmp_path / f"{tag}.json"))["traceEvents"]),
            rows["train/steps"]["value"],
            rows["train/chunk_time_s"]["count"], set(res.phase_times))
    assert got["torch"] == got["jax"]
    assert "train/ckpt_save" in got["torch"][1]


def test_checkpoint_save_fault_hooks(tmp_path):
    """``io_check`` fails each attempt while armed, ``on_retry`` sees each
    retry, ``sleep`` takes ``retry_delays``; without them nothing
    changes."""
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)}}
    fails, seen, slept = [2], [], []

    def io_check():
        if fails[0]:
            fails[0] -= 1
            raise tfaults.InjectedIOError("injected")

    tckpt.save(str(tmp_path / "a"), 1, tree, retries=3, backoff_s=0.01,
               backoff_seed=5, io_check=io_check,
               on_retry=lambda a, e: seen.append((a, type(e).__name__)),
               sleep=slept.append)
    assert seen == [(0, "InjectedIOError"), (1, "InjectedIOError")]
    assert slept == tckpt.retry_delays(3, 0.01, seed=5)[:2]
    tckpt.save(str(tmp_path / "b"), 1, tree)
    for d in ("a", "b"):
        assert tckpt.verify(str(tmp_path / d), 1)
    with open(tmp_path / "a" / "step_00000001" / "manifest.json") as f:
        a = f.read()
    with open(tmp_path / "b" / "step_00000001" / "manifest.json") as f:
        assert f.read() == a
    with pytest.raises(OSError):
        tckpt.save(str(tmp_path / "c"), 1, tree, retries=1,
                   io_check=lambda: (_ for _ in ()).throw(OSError("x")),
                   sleep=lambda s: None)


# ---------------------------------------------------------------------------
# dynamic_backup and the measured latency pieces
# ---------------------------------------------------------------------------


def test_dynamic_backup_registered_and_matches_jax():
    """The same rows (a heavy tail, then deaths) give the same adapted n,
    masks, times and state_dict."""
    agg = jbase.AggregationConfig(strategy="dynamic_backup", num_workers=4,
                                  backup_workers=2, dynamic_window=6)
    js = jregistry.get_strategy(agg)
    ts = tregistry.get_strategy(port_config(agg))
    assert isinstance(ts, DynamicBackup) and tregistry.supports_spmd(ts)
    assert ts.total_workers == 6 and ts.n == 4 and ts.min_alive == 1
    assert not ts.device_select_supported
    rng = np.random.RandomState(0)
    ns = []
    for i in range(20):
        arr = rng.uniform(1.0, 1.2, size=6)
        arr[5] *= 50.0
        if i >= 12:
            arr[[1, 2]] = np.inf
        (jm, jt), (tm, tt) = js.select(arr.copy()), ts.select(arr.copy())
        np.testing.assert_array_equal(tm, jm)
        assert tt == jt and ts.n == js.n
        ns.append(ts.n)
    assert min(ns) < 6
    assert ts.state_dict() == js.state_dict()
    back = DynamicBackup(4, 2, 6)
    back.load_state_dict(ts.state_dict())
    assert back.state_dict() == ts.state_dict()
    rows = rng.uniform(1, 2, size=(5, 6))
    jm, jt = js.select_batch(rows.copy())     # the reference's row loop
    for i, row in enumerate(rows):
        m, t = ts.select(row)
        np.testing.assert_array_equal(m, jm[i])
        assert t == jt[i]


def test_dynamic_backup_measured_matches_jax():
    agg = jbase.AggregationConfig(strategy="dynamic_backup", num_workers=3,
                                  backup_workers=1, dynamic_window=4,
                                  latency_source="measured")
    js = jregistry.get_strategy(agg)
    ts = tregistry.get_strategy(port_config(agg))
    rng = np.random.RandomState(1)
    for i in range(9):
        row = rng.uniform(0.1, 0.2, size=4)
        if i > 5:
            row[3] = np.inf
        js.observe_measured(row)
        ts.observe_measured(row)
        arr = rng.uniform(1, 2, size=4)
        np.testing.assert_array_equal(ts.select(arr)[0], js.select(arr)[0])
    assert ts.state_dict() == js.state_dict()
    with pytest.raises(RuntimeError, match="measured"):
        DynamicBackup(3, 1).observe_measured(np.ones(4))
    with pytest.raises(ValueError, match="latency_source"):
        DynamicBackup(3, 1, latency_source="wall")


def test_dynamic_backup_run_matches_jax(tmp_path):
    """A sim run with workers 4 and 5 slowed 5x: the adapted n equals
    JAX's at every step (host logic), the runs agree, and a resume from
    the step-8 checkpoint keeps the adapted n."""
    jcfg = _jcfg(tmp_path, strategy="dynamic_backup", chunk=4, steps=12,
                 every=8, dynamic_window=6)
    lat = dict(slow_workers=(4, 5), slowdown=5.0)
    tcfg = _tcfg(dataclasses.replace(jcfg, checkpoint=dataclasses.replace(
        jcfg.checkpoint, directory=str(tmp_path / "t"))))
    jtr = jloop.Trainer(jcfg, latency=JDeterministic(**lat))
    ttr = tloop.Trainer(tcfg, latency=DeterministicStragglers(**lat),
                        device="cpu")
    for tr in (jtr, ttr):
        tr.init_state()
    jres, tres = jtr.run(12), ttr.run(12)
    assert ttr.strategy.n == jtr.strategy.n < 6
    assert ttr.strategy.state_dict() == jtr.strategy.state_dict()
    _hold(tres, jres)
    saved = tckpt.read_manifest(tcfg.checkpoint.directory, 8)
    assert saved["strategy_state"] == tckpt.read_manifest(
        jcfg.checkpoint.directory, 8)["strategy_state"]
    back = tloop.Trainer(tcfg, latency=DeterministicStragglers(**lat),
                         device="cpu")
    back.reset_optimizer_state()
    back.restore_checkpoint(8)
    assert back.strategy.n == saved["strategy_state"]["n"]
    assert back.strategy.state_dict() == saved["strategy_state"]
    bres = back.run(4)
    assert [(m["step"], m["selected"], m["sim_time"]) for m in bres.metrics] \
        == [(m["step"], m["selected"], m["sim_time"])
            for m in jres.metrics[8:]]
    assert back.strategy.state_dict() == jtr.strategy.state_dict()
    _close_state(bres, jres)


def test_dynamic_backup_refuses_device_backend(tmp_path):
    jcfg = dataclasses.replace(_jcfg(tmp_path, strategy="dynamic_backup"),
                               straggler_backend="device")
    with pytest.raises(ValueError, match="host") as want:
        jloop.run_experiment(jcfg, latency=JUniform(1.0, 2.0))
    with pytest.raises(ValueError) as got:
        tloop.run_experiment(_tcfg(jcfg), device="cpu")
    assert str(got.value) == str(want.value)


def test_windowed_quantile_matches_jax():
    rng = np.random.RandomState(2)
    vals = list(rng.exponential(1.0, size=37))
    for q, n in ((50.0, 1), (99.0, 10), (95.0, 40)):
        assert tquantiles.windowed_quantile(vals, q, n, -1.0) == \
            jquantiles.windowed_quantile(vals, q, n, -1.0)
    jw, tw = (m.WindowedQuantile(8, 90.0, 3) for m in (jquantiles,
                                                       tquantiles))
    for v in vals:
        jw.observe(v)
        tw.observe(v)
        assert tw.estimate() == jw.estimate() and tw.warm == jw.warm
    assert tw.state_dict() == jw.state_dict()
    with pytest.raises(ValueError, match="window"):
        tquantiles.WindowedQuantile(0)


def test_empirical_latency_model_matches_jax():
    jm, tm = (m.EmpiricalLatencyModel(3, window=5, fallback_s=0.7)
              for m in (jlatency, tlatency))
    assert np.array_equal(tm.sample(np.random.RandomState(0), (4, 3)),
                          jm.sample(np.random.RandomState(0), (4, 3)))
    rng = np.random.RandomState(4)
    for i in range(9):
        row = rng.uniform(0.5, 1.5, size=3)
        if i % 3 == 0:
            row[1] = np.inf
        jm.record(row)
        tm.record(row)
    assert tm.state_dict() == jm.state_dict() and len(tm) == len(jm)
    for shape in ((6, 3), (2, 5)):
        assert np.array_equal(tm.sample(np.random.RandomState(1), shape),
                              jm.sample(np.random.RandomState(1), shape))
    assert tm.quantile(90.0) == jm.quantile(90.0)
    assert tm.quantile(50.0, worker=1) == jm.quantile(50.0, worker=1)
    np.testing.assert_array_equal(tm.mean_row(), jm.mean_row())
    other = tlatency.EmpiricalLatencyModel(2, window=5)
    other.load_state_dict(tm.state_dict())
    assert other.samples == tm.samples[:2]


# ---------------------------------------------------------------------------
# The 'data' axis over spawned gloo ranks, and the CLI
# ---------------------------------------------------------------------------


def test_mesh_chaos_matches_jax(tmp_path):
    """A crash and a slowdown at ``mesh_data`` 2 over two gloo ranks: the
    dead worker's row is masked out of each rank's reduce. Rank 0 against
    the JAX sim Trainer with the same plan; the ranks bit-identical; a
    rescale to 3 workers shrinks the data axis by the reference's rule
    (2 -> 1, the JAX rescale's worker count) and rank 1 idles."""
    spec = "crash@3:w1,slow@2:w4:x3:d3"
    jcfg = _jcfg(tmp_path / "j", spec=spec, every=0, steps=8, chunk=1)
    jres = jloop.run_experiment(jcfg, latency=JUniform(1.0, 2.0))
    tcfg = _tcfg(dataclasses.replace(
        jcfg, checkpoint=dataclasses.replace(
            jcfg.checkpoint, directory=str(tmp_path / "t")),
        execution=dataclasses.replace(jcfg.execution, backend="spmd",
                                      mesh_data=2)))
    mesh.spawn(ranks.chaos_rank, 2, "cpu",
               args=(str(tmp_path), _jax_params(tcfg.model), tcfg, 8),
               threads=1, timeout_s=120.0)
    out = [torch.load(tmp_path / f"chaos{r}.pt") for r in range(2)]
    for name, v in out[0]["params"].items():
        assert torch.equal(out[1]["params"][name], v), name
    assert out[1]["metrics"] == out[0]["metrics"]
    assert out[0]["recovery_log"] == jres.recovery_log
    assert [m["selected"] for m in out[0]["metrics"]] == \
        [m["selected"] for m in jres.metrics]
    assert out[0]["sim_time"] == jres.sim_time
    for got, want in ((out[0]["params"], jres.params),
                      (out[0]["ema"], jres.ema)):
        for k, v in from_jax_tree(want).items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    jtr = jloop.Trainer(dataclasses.replace(
        jcfg, checkpoint=dataclasses.replace(
            jcfg.checkpoint, directory=str(tmp_path / "jr"))),
        latency=JUniform(1.0, 2.0))
    jtr.init_state()
    jtr.rescale(3)
    md = 2
    while jtr.cfg.aggregation.total_workers % md:   # the reference's rule
        md -= 1
    assert [(o["workers"], o["mesh_data"], o["idle"]) for o in out] == \
        [(jtr.cfg.aggregation.total_workers, md, False),
         (jtr.cfg.aggregation.total_workers, md, True)] == \
        [(3, 1, False), (3, 1, True)]


def test_mesh_rescale_shrinks_the_data_axis(tmp_path):
    """Full sync over 4 workers at ``mesh_data`` 2 on two spawned gloo
    ranks under ``run_supervised``: a crash takes the live workers below
    N, the rescale to 3 shrinks the data axis to 1 (the reference's rule,
    ``tests/test_spmd_engine.py``'s rescale case) and rank 1 idles, taking
    no step but every checkpoint barrier, the preemption after the shrink
    and the supervisor's restore barrier. Rank 0 against the JAX sim
    supervisor with the same plan: the log bit-identical, selected and
    sim_time equal, losses and state within rtol 2e-4 / atol 2e-5; rank 1
    logs nothing after the shrink."""
    spec = "crash@3:w1,preempt@6"
    jcfg = _jcfg(tmp_path / "j", strategy="full_sync", spec=spec, every=4,
                 steps=10, chunk=2)
    jres = jsupervisor.run_supervised(jcfg, latency=JUniform(1.0, 2.0))
    tcfg = _tcfg(dataclasses.replace(
        jcfg, checkpoint=dataclasses.replace(
            jcfg.checkpoint, directory=str(tmp_path / "t")),
        execution=dataclasses.replace(jcfg.execution, backend="spmd",
                                      mesh_data=2)))
    mesh.spawn(ranks.shrink_rank, 2, "cpu",
               args=(str(tmp_path), _jax_params(tcfg.model), tcfg),
               threads=1, timeout_s=120.0)
    out = [torch.load(tmp_path / f"shrink{r}.pt") for r in range(2)]
    assert [(o["mesh_data"], o["idle"], o["steps"]) for o in out] == \
        [(1, False, 10), (1, True, 10)]
    assert out[0]["recovery_log"] == out[1]["recovery_log"] == \
        jres.recovery_log
    assert any(e["event"] == "rescale" for e in jres.recovery_log)
    assert [(m["step"], m["selected"], m["sim_time"])
            for m in out[0]["metrics"]] == \
        [(m["step"], m["selected"], m["sim_time"]) for m in jres.metrics]
    np.testing.assert_allclose([m["loss"] for m in out[0]["metrics"]],
                               [m["loss"] for m in jres.metrics], rtol=RTOL)
    assert out[1]["metrics"] == [] and out[1]["sim_time"] == jres.sim_time
    for got, want in ((out[0]["params"], jres.params),
                      (out[0]["ema"], jres.ema)):
        for k, v in from_jax_tree(want).items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


_LINE = re.compile(r"\[train\] step\s+(\d+) loss (\S+) sim\s+(\S+)s "
                   r"selected (\d+)")


def test_cli_faults_supervise_matches_jax_cli(tmp_path, capsys):
    """``--faults ... --supervise`` through both CLIs, the port from the
    JAX init: the recovery lines equal, the step lines within 2e-4."""
    argv = ["--smoke", "--steps", "10", "--seq", "8", "--batch-per-worker",
            "1", "--strategy", "backup", "--workers", "3", "--backups", "1",
            "--optimizer", "momentum", "--lr", "0.05", "--ckpt-every", "4",
            "--chunk-size", "2", "--faults",
            "crash@2:w1,slow@3:w0:x4:d2,crash@5:w2,preempt@7",
            "--supervise"]
    out = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        extra = ["--device", "cpu"] if tag == "torch" else []
        main(argv + extra + ["--ckpt", str(tmp_path / tag)])
        out[tag] = capsys.readouterr().out
    rec = {t: [ln for ln in o.splitlines() if "recovery:" in ln]
           for t, o in out.items()}
    assert rec["torch"] == rec["jax"] and any("rescale" in ln
                                              for ln in rec["jax"])
    lines = {t: _LINE.findall(o) for t, o in out.items()}
    assert len(lines["torch"]) == len(lines["jax"]) == 1
    for got, want in zip(lines["torch"], lines["jax"]):
        assert (got[0], got[2], got[3]) == (want[0], want[2], want[3])
        assert abs(float(got[1]) - float(want[1])) <= 2e-4
    done = {t: re.sub(r", checkpoint .*", "", o.split("[train] done: ")[1]
                      .splitlines()[0]) for t, o in out.items()}
    assert done["torch"] == done["jax"]
