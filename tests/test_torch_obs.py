"""The port's telemetry (``repro_torch.obs`` and the trainer's spans and
registry) against the JAX reference (``repro.obs``), on the CPU.

* ``METRIC_NAMES`` and ``SPAN_NAMES`` are the reference's tuples, and the
  copied ``Counter`` / ``Gauge`` / ``Histogram`` / ``MetricsRegistry``
  give the same ``summary()`` and byte-identical JSONL on one script of
  operations; ``load_trace`` and ``span_tree`` behave as the reference's.
* A traced trainer run (``tests/test_obs.py``'s trainer cases) gives the
  JAX ``Trainer``'s span-name multiset, ``span_tree`` shape and registry
  counts on the same config: the sim and spmd backends, per step and in
  chunks of 4, the device straggler backend and an event strategy; its
  parameters are bit-equal to the untraced port run; ``phase_times`` is
  ``{}`` with observability off; measured ``dynamic_backup`` feeds
  ``spmd/worker_step_s`` as the reference does; the no-op tracer costs
  under 2% of a chunk.
* ``run_experiment`` takes ``tracer=`` / ``metrics=``, and the CLI's
  ``--trace`` / ``--metrics`` under ``--supervise`` write files that read
  back.
"""
import collections
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.common import tiny_lm_config as jtiny_lm_config
from repro import obs as jobs
from repro.configs import base as jbase
from repro.core.straggler import Uniform as JUniform
from repro.train import loop as jloop

from repro_torch import obs as tobs
from repro_torch.core.straggler import Uniform
from repro_torch.launch import train as tcli
from repro_torch.train import loop as tloop
from torch_parity import port_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# The obs layer: names, registry, trace files
# ---------------------------------------------------------------------------


def test_names_are_the_reference_tuples():
    assert tobs.METRIC_NAMES == jobs.METRIC_NAMES
    assert tobs.SPAN_NAMES == jobs.SPAN_NAMES
    assert set(tobs.__all__) == set(jobs.__all__)


def _script(reg) -> None:
    """One script of registry operations, over every instrument kind."""
    rng = np.random.RandomState(0)
    reg.counter("train/steps").inc(3)
    reg.counter("train/steps").inc()
    reg.gauge("train/wall_time_s").set(1.25)
    reg.gauge("train/ckpt_s").add(0.5)
    reg.gauge("train/ckpt_s").add(0.25)
    for v in rng.exponential(1.0, size=40):
        reg.histogram("serve/latency", window=16).observe(float(v))
    reg.histogram("router/latency")                 # no sample: count 0
    for v in (3, 1, 2):
        reg.histogram("train/chunk_time_s").observe(v)


def test_registry_summary_and_jsonl_byte_identical(tmp_path):
    regs = {"jax": jobs.MetricsRegistry(), "torch": tobs.MetricsRegistry()}
    for reg in regs.values():
        _script(reg)
    assert regs["torch"].summary() == regs["jax"].summary()
    assert len(regs["torch"]) == len(regs["jax"]) == 6
    assert list(regs["torch"]) and "train/steps" in regs["torch"]
    h = {k: r.histogram("serve/latency") for k, r in regs.items()}
    assert h["torch"].values == h["jax"].values and len(h["jax"].values) == 16
    assert h["torch"].quantile(90.0) == h["jax"].quantile(90.0)
    blobs = {}
    for tag, reg in regs.items():
        path = str(tmp_path / f"{tag}.jsonl")
        assert reg.dump_jsonl(path) == path
        with open(path, "rb") as f:
            blobs[tag] = f.read()
        assert tobs.load_jsonl(path) == jobs.load_jsonl(path)
    assert blobs["torch"] == blobs["jax"]
    for reg in regs.values():
        with pytest.raises(ValueError, match="is a counter, not a gauge"):
            reg.gauge("train/steps")


def test_trace_files_and_span_tree_match_reference(tmp_path):
    events = [
        {"name": "train/chunk", "ph": "X", "ts": 0.0, "dur": 10.0},
        {"name": "train/data_wait", "ph": "X", "ts": 1.0, "dur": 2.0},
        {"name": "train/device_wait", "ph": "X", "ts": 5.0, "dur": 5.0},
        {"name": "train/chunk", "ph": "X", "ts": 12.0, "dur": 3.0},
        {"name": "router/hedge", "ph": "i", "ts": 13.0},
        {"name": "serve/decode", "ph": "X", "ts": 0.5, "dur": 1.0,
         "tid": 1}]
    assert tobs.span_tree(events) == jobs.span_tree(events)
    tr = tobs.Tracer(capacity=2)
    with tr.span("train/chunk", k=4):
        tr.instant("serve/evict", evicted=1)
    tr.counter("train/steps", 4)
    assert (len(tr), tr.dropped) == (2, 1)
    path = str(tmp_path / "t.json")
    tr.export(path)
    assert tobs.load_trace(path) == jobs.load_trace(path)
    for bad, match in (({"events": []}, "traceEvents"),
                       ({"traceEvents": [{"name": "a", "ph": "X",
                                          "ts": 0}]}, "dur"),
                       ({"traceEvents": [{"ph": "i", "ts": 0}]}, "name")):
        with open(path, "w") as f:
            import json
            json.dump(bad, f)
        for load in (tobs.load_trace, jobs.load_trace):
            with pytest.raises(ValueError, match=match):
                load(path)


# ---------------------------------------------------------------------------
# The trainer's spans and registry against the JAX Trainer
# ---------------------------------------------------------------------------


def _jcfg(tmp_path, *, backend="sim", chunk=4, agg=None, every=4,
          straggler="host"):
    """``tests/test_obs.py``'s trainer config, with checkpoints every 4 so
    ``train/ckpt_save`` is covered."""
    return jbase.TrainConfig(
        model=jtiny_lm_config(),
        shape=jbase.ShapeConfig("t", 16, 8, "train"),
        aggregation=jbase.AggregationConfig(**(agg or dict(
            strategy="backup", num_workers=3, backup_workers=1))),
        optimizer=jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                        scale_lr_with_workers=False),
        checkpoint=jbase.CheckpointConfig(directory=str(tmp_path),
                                          every_steps=every),
        execution=jbase.ExecutionConfig(backend=backend, grad_batch=1),
        log_every=100, chunk_size=chunk, straggler_backend=straggler)


def _tcfg(jcfg, directory):
    return port_config(dataclasses.replace(
        jcfg, checkpoint=dataclasses.replace(jcfg.checkpoint,
                                             directory=str(directory))))


def _shape(node):
    return (node["name"], tuple(_shape(c) for c in node["children"]))


def _digest(tracer, reg):
    """What a traced run must share with the reference's: the span names
    (a multiset), the tree's shape, and each metric's count or value
    (the wall-clock gauges by presence)."""
    events = list(tracer.events)
    counts = {}
    for name, row in reg.summary().items():
        if row["kind"] == "histogram":
            counts[name] = row["count"]
        elif name in ("train/steps",):
            counts[name] = row["value"]
        else:
            counts[name] = None
    return (collections.Counter(e["name"] for e in events),
            [_shape(r) for r in tobs.span_tree(events)], counts)


CASES = {
    "sim_chunk4": dict(),
    "sim_step": dict(chunk=1),
    "spmd_chunk4": dict(backend="spmd"),
    "spmd_step": dict(backend="spmd", chunk=1),
    "device_backend": dict(straggler="device", every=0),
    "async_events": dict(agg=dict(strategy="async", num_workers=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_traced_trainer_matches_jax(tmp_path, case):
    """The same spans, tree and registry counts as the JAX Trainer; the
    port's traced parameters bit-equal to its untraced run."""
    jcfg = _jcfg(tmp_path / "j", **CASES[case])
    jtr, jreg = jobs.Tracer(), jobs.MetricsRegistry()
    jt = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0), tracer=jtr,
                       metrics=jreg)
    jt.init_state()
    jres = jt.run(8)
    ttr, treg = tobs.Tracer(), tobs.MetricsRegistry()
    tt = tloop.Trainer(_tcfg(jcfg, tmp_path / "t"), latency=Uniform(1.0, 2.0),
                       device="cpu", tracer=ttr, metrics=treg)
    tt.init_state()
    tres = tt.run(8)
    assert _digest(ttr, treg) == _digest(jtr, jreg)
    assert set(tobs.SPAN_NAMES) >= {e["name"] for e in ttr.events}
    assert set(tres.phase_times) == set(jres.phase_times) == \
        {"dispatch_s", "data_s", "ckpt_s"}
    # event mode times only its checkpoints, as in the reference
    assert tres.wall_time_s > 0
    for key in tres.phase_times:
        assert (tres.phase_times[key] > 0) == (jres.phase_times[key] > 0)
    assert (tres.phase_times["dispatch_s"] > 0) == ("agg" not in CASES[case])
    plain = tloop.Trainer(_tcfg(jcfg, tmp_path / "p"),
                          latency=Uniform(1.0, 2.0), device="cpu")
    plain.init_state()
    pres = plain.run(8)
    assert pres.phase_times == {}
    for k, v in pres.params.items():
        assert torch.equal(tres.params[k], v), k
    assert [m.get("loss") for m in tres.metrics] == \
        [m.get("loss") for m in pres.metrics]


def test_chunk_roots_hold_the_phase_spans(tmp_path):
    """``tests/test_obs.py``'s traced run: 2 ``train/chunk`` roots of 4
    steps, each with its data and device waits; 8 steps and 2 chunk
    samples in the registry."""
    tracer, reg = tobs.Tracer(), tobs.MetricsRegistry()
    tr = tloop.Trainer(_tcfg(_jcfg(tmp_path, every=0), tmp_path),
                       latency=Uniform(1.0, 2.0), device="cpu",
                       tracer=tracer, metrics=reg)
    tr.init_state()
    tr.run(8)
    roots = [r for r in tobs.span_tree(list(tracer.events))
             if r["name"] == "train/chunk"]
    assert len(roots) == 2
    for r in roots:
        assert [c["name"] for c in r["children"]] == \
            ["train/data_wait", "train/device_wait"]
    assert reg.counter("train/steps").value == 8
    assert reg.histogram("train/chunk_time_s").count == 2
    assert reg.histogram("train/step_time_s").count == 2


def test_measured_feed_fills_worker_step_histogram(tmp_path):
    """Measured ``dynamic_backup`` with a registry: one row per chunk into
    the strategy and ``spmd/worker_step_s`` (live workers only), as many
    samples as the reference's."""
    agg = dict(strategy="dynamic_backup", num_workers=4, backup_workers=2,
               dynamic_window=4, latency_source="measured")
    jcfg = _jcfg(tmp_path / "j", agg=agg, every=0)
    counts = {}
    for tag in ("jax", "torch"):
        reg = (jobs if tag == "jax" else tobs).MetricsRegistry()
        if tag == "jax":
            tr = jloop.Trainer(jcfg, latency=JUniform(1.0, 2.0), metrics=reg)
        else:
            tr = tloop.Trainer(_tcfg(jcfg, tmp_path / "t"),
                               latency=Uniform(1.0, 2.0), device="cpu",
                               metrics=reg)
        tr.init_state()
        res = tr.run(8)
        counts[tag] = (reg.histogram("spmd/worker_step_s").count,
                       tr.strategy.measured.rows, set(res.phase_times))
    assert counts["torch"] == counts["jax"] == \
        (12, 2, {"dispatch_s", "data_s", "ckpt_s"})


def test_null_path_overhead_under_two_percent(tmp_path):
    """The disabled tracer's hooks cost under 2% of a chunk of 32 steps
    (``tests/test_obs.py``'s bound and method: the no-op span timed in a
    tight loop against the measured chunk)."""
    tr = tloop.Trainer(_tcfg(_jcfg(tmp_path, chunk=32, every=0), tmp_path),
                       latency=Uniform(1.0, 2.0), device="cpu")
    tr.init_state()
    tr.run(32)
    t0 = time.perf_counter()
    tr.run(32)
    chunk_s = time.perf_counter() - t0
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tobs.NULL.span("train/chunk"):
            pass
    hook_s = (time.perf_counter() - t0) / n
    overhead = 5 * hook_s / chunk_s    # chunk, data and device waits, 2 clocks
    assert overhead < 0.02, (hook_s, chunk_s)


def test_run_experiment_takes_telemetry(tmp_path):
    jcfg = dataclasses.replace(_jcfg(tmp_path / "j"), total_steps=8)
    got = {}
    for tag, run, obs in (("jax", jloop.run_experiment, jobs),
                          ("torch", tloop.run_experiment, tobs)):
        tracer, reg = obs.Tracer(), obs.MetricsRegistry()
        if tag == "jax":
            res = run(jcfg, latency=JUniform(1.0, 2.0), tracer=tracer,
                      metrics=reg, save_final=True)
        else:
            res = run(_tcfg(jcfg, tmp_path / "t"), latency=Uniform(1.0, 2.0),
                      device="cpu", tracer=tracer, metrics=reg,
                      save_final=True)
        got[tag] = (_digest(tracer, reg), res.steps, set(res.phase_times))
    assert got["torch"] == got["jax"]


def test_cli_supervised_trace_and_metrics_read_back(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.jsonl"
    tcli.main(["--smoke", "--steps", "8", "--seq", "8", "--batch-per-worker",
               "1", "--workers", "3", "--backups", "1", "--ckpt-every", "4",
               "--chunk-size", "2", "--device", "cpu", "--ckpt",
               str(tmp_path / "ck"), "--faults", "crash@2:w1,preempt@5",
               "--supervise", "--trace", str(trace), "--metrics",
               str(metrics)])
    out = capsys.readouterr().out
    assert "[train] recovery: preempt" in out
    assert f"[train] trace: {trace} (" in out
    assert f"[train] metrics: {metrics} (" in out
    names = {e["name"] for e in tobs.load_trace(str(trace))["traceEvents"]}
    assert {"train/chunk", "train/data_wait", "train/device_wait",
            "train/ckpt_save"} <= names <= set(tobs.SPAN_NAMES)
    rows = {r["name"]: r for r in tobs.load_jsonl(str(metrics))}
    assert rows["train/steps"]["value"] >= 8
    assert rows["train/chunk_time_s"]["count"] >= 4
