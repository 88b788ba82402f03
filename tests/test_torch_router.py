"""The port's replica router and its serving resilience against the JAX
reference (``repro.serve``), on the CPU.

* ``ReplicaRouter`` over the port's ``StepSession`` replicas, on the same
  smoke model (the port from the JAX init) and traces, on the cases of
  ``tests/test_router.py`` and ``tests/test_router_chaos.py`` (one
  replica, several, hedging around a slowed replica, timeouts with
  jittered backoff and their budget, SLO shed / queue, queue overflow,
  an undersized pool, crash / restart, preemption, a total outage, a
  crash under hedging, seeded random placement): ``tokens_by_rid``, the
  completed records, the rejections, the ``metrics`` dict, the decision
  events and the health log all equal the reference's, and a second run
  replays the first bit for bit. The ``router/*`` instants and counters
  equal the reference's.
* ``HealthMonitor`` and ``SLOController`` (its ``state_dict`` round trip)
  step for step against the reference's; the configs' and the fault
  plan's errors are the reference's.
* ``StepSession``: tokens equal the engine's, ``release`` frees every
  page, ``evict_all`` orders by slot.
* The restore bridge both ways (``tests/test_serve_engine.py``'s
  train-then-serve case): a checkpoint the JAX trainer wrote serves, in
  the port, the JAX engine's greedy tokens, and one the port's trainer
  wrote serves the port engine's tokens in the JAX engine; params and EMA.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro import obs as jobs
from repro import serve as jserve
from repro.configs import base as jbase
from repro.models import get_model as jget_model
from repro.train import loop as jloop

from repro_torch import configs as tconfigs
from repro_torch import obs as tobs
from repro_torch import serve as tserve
from repro_torch.models import TransformerLM, load_jax_params
from repro_torch.train import loop as tloop
from torch_parity import port_config

ARCH = "qwen3-0.6b"
ENGINE_KW = dict(num_slots=2, page_size=4, max_prompt_len=12, max_new_cap=8,
                 clock="virtual")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def qwen():
    jcfg = jconfigs.get_smoke_config(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    params = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(TransformerLM(tcfg, device="cpu"), params)
    return jcfg, params, tcfg, tmodel


@pytest.fixture(scope="module")
def engines(qwen):
    jcfg, params, tcfg, tmodel = qwen
    return (jserve.ServeEngine(jcfg, params, **ENGINE_KW),
            tserve.ServeEngine(tcfg, tmodel, device="cpu", **ENGINE_KW))


def _traces(n=12, *, seed=0, rate=2.0, max_prompt=12, max_new=8, vocab=128,
            min_new=2):
    kw = dict(num_requests=n, rate=rate, prompt_len_min=2,
              prompt_len_max=max_prompt, max_new_min=min_new,
              max_new_max=max_new, vocab=vocab, seed=seed)
    return (jserve.make_trace(jserve.TraceConfig(**kw)),
            tserve.make_trace(tserve.TraceConfig(**kw)))


def _report(rep):
    """Everything a report holds, in plain values."""
    return dict(completed=[dataclasses.asdict(c) for c in rep.completed],
                tokens=rep.tokens_by_rid(), rejected=rep.rejected,
                metrics=rep.metrics, events=rep.events, health=rep.health)


def _accounted(rep, trace):
    done = {c.rid for c in rep.completed}
    rej = {r["rid"] for r in rep.rejected}
    assert not done & rej and done | rej == {r.rid for r in trace}
    assert rep.metrics["lost_requests"] == 0


# (RouterConfig kwargs, SLOConfig kwargs or None, trace kwargs); the
# router cases of tests/test_router.py and tests/test_router_chaos.py
_SLO_TRACE = dict(n=40, seed=3, rate=1.0, min_new=4, max_new=8)
SCENARIOS = {
    "one_replica": (dict(num_replicas=1), None, dict(n=8)),
    "three_replicas": (dict(num_replicas=3), None, dict(n=12)),
    "hedging": (dict(num_replicas=3, hedge_after=6.0,
                     faults="slowdown@0:r0:x8:d64"), None,
                dict(n=24, min_new=4)),
    "hedge_win_release": (dict(num_replicas=2, faults="slowdown@0:r1:x20:"
                               "d200", hedge_after=2.0), None,
                          dict(n=24, min_new=4)),
    "prefill_only": (dict(num_replicas=2), None,
                     dict(n=4, rate=1000.0, min_new=1, max_new=1)),
    "prefill_cancelled_by_crash": (dict(num_replicas=2,
                                        faults="crash@1:r0"), None,
                                   dict(n=1, rate=1000.0, min_new=1,
                                        max_new=1)),
    "timeout_retries": (dict(num_replicas=2, timeout=8.0, max_retries=3,
                             faults="slowdown@0:r0:x50:d20"), None,
                        dict(n=4, rate=2.0, min_new=2, max_new=4)),
    "timeout_budget": (dict(num_replicas=2, timeout=4.0, max_retries=1,
                            faults="slowdown@0:r0:x50:d400,"
                                   "slowdown@0:r1:x50:d400"), None,
                       dict(n=6, min_new=4)),
    "slo_shed": (dict(num_replicas=1),
                 dict(target_p99=10.0, window=16, min_samples=4),
                 _SLO_TRACE),
    "slo_queue": (dict(num_replicas=1),
                  dict(target_p99=15.0, mode="queue", window=16,
                       min_samples=4), _SLO_TRACE),
    "queue_overflow": (dict(num_replicas=2, max_queue=3), None,
                       dict(n=16, rate=1000.0)),
    "crash_restart": (dict(num_replicas=3,
                           faults="crash@4:r1,restart@20:r1"), None, {}),
    "drain_order": (dict(num_replicas=2, faults="crash@6:r0,restart@40:r0"),
                    None, {}),
    "preempt_revives": (dict(num_replicas=2, faults="preempt@3:r0:d10"),
                        None, {}),
    "total_outage": (dict(num_replicas=2, faults="crash@2:r0,crash@2:r1"),
                     None, dict(n=12)),
    "hedge_replica_crash": (dict(num_replicas=3, hedge_after=4.0,
                                 faults="slowdown@0:r0:x10:d400,crash@12:r1,"
                                        "restart@60:r1"), None, {}),
    "random_placement": (dict(num_replicas=3, faults="crash=2,restart@80:r0,"
                              "restart@80:r1,restart@80:r2", fault_seed=5,
                              fault_horizon=16), None, dict(n=12)),
    "chaos_hedged_timeout": (dict(num_replicas=3, hedge_after=5.0,
                                  timeout=60.0,
                                  faults="slowdown@0:r0:x8:d50,crash@10:r2,"
                                         "restart@30:r2,preempt@15:r1:d8"),
                             dict(target_p99=40.0, window=16, min_samples=4),
                             {}),
}


@pytest.mark.parametrize("case", list(SCENARIOS))
def test_router_report_matches_jax(engines, case):
    jeng, teng = engines
    rkw, skw, tkw = SCENARIOS[case]
    jtrace, ttrace = _traces(**tkw)
    reports = []
    for _ in range(2):              # the second run replays the first
        slo = tserve.SLOConfig(**skw) if skw else None
        reports.append(tserve.ReplicaRouter(
            teng, tserve.RouterConfig(**rkw), slo=slo).run(ttrace))
    want = jserve.ReplicaRouter(
        jeng, jserve.RouterConfig(**rkw),
        slo=jserve.SLOConfig(**skw) if skw else None).run(jtrace)
    _accounted(reports[0], ttrace)
    assert _report(reports[0]) == _report(want)
    assert _report(reports[1]) == _report(reports[0])


def test_router_pool_exhausted_reject_matches_jax(qwen):
    """An undersized pool (``strict_capacity=False``): requests that can
    never fit are rejected with the reference's structured reason."""
    jcfg, params, tcfg, tmodel = qwen
    kw = dict(ENGINE_KW, num_pages=4, strict_capacity=False)
    jtrace, ttrace = _traces(4, max_prompt=12, min_new=4)
    want = jserve.ReplicaRouter(jserve.ServeEngine(jcfg, params, **kw),
                                jserve.RouterConfig(num_replicas=2)).run(
        jtrace)
    got = tserve.ReplicaRouter(
        tserve.ServeEngine(tcfg, tmodel, device="cpu", **kw),
        tserve.RouterConfig(num_replicas=2)).run(ttrace)
    assert _report(got) == _report(want)
    assert {r["reason"] for r in got.rejected} == {"pool_exhausted"}
    _accounted(got, ttrace)


def test_router_instants_and_counters_match_jax(engines):
    """The tracer's ``router/*`` instants (names, replicas, virtual times)
    and the registry's ``router/*`` summary equal the reference's."""
    jeng, teng = engines
    rkw, skw, tkw = SCENARIOS["chaos_hedged_timeout"]
    jtrace, ttrace = _traces(**tkw)
    got = {}
    for tag, pkg, obs, eng, trace in (("jax", jserve, jobs, jeng, jtrace),
                                      ("torch", tserve, tobs, teng, ttrace)):
        tracer, reg = obs.Tracer(), obs.MetricsRegistry()
        pkg.ReplicaRouter(eng, pkg.RouterConfig(**rkw),
                          slo=pkg.SLOConfig(**skw), tracer=tracer,
                          metrics=reg).run(trace)
        got[tag] = ([(e["name"], e["args"]) for e in tracer.events
                     if e["name"].startswith("router/")],
                    {k: v for k, v in reg.summary().items()
                     if k.startswith("router/")},
                    collections.Counter(e["name"] for e in tracer.events))
    assert got["torch"] == got["jax"]
    assert {"router/dispatch", "router/hedge",
            "router/failover"} <= set(got["torch"][2])


# ---------------------------------------------------------------------------
# Health, SLO and the configs, step for step
# ---------------------------------------------------------------------------


def test_health_monitor_matches_jax():
    mons = (jserve.HealthMonitor(3), tserve.HealthMonitor(3))
    script = [("set_slowdown", 1, 0.0, dict(factor=4.0, until=5.0)),
              ("mark_down", 0, 1.0, dict(reason="crash")),
              ("set_slowdown", 0, 1.5, dict(factor=2.0, until=9.0)),
              ("mark_down", 2, 2.0, dict(reason="preempt", up_at=6.0)),
              ("expire", None, 5.0, {}), ("expire", None, 6.0, {}),
              ("revive", 0, 7.0, {})]
    for op, r, t, kw in script:
        for m in mons:
            if op == "expire":
                m.expire(t)
            else:
                getattr(m, op)(r, t, **kw)
        assert [dataclasses.asdict(x) for x in mons[1].replicas] == \
            [dataclasses.asdict(x) for x in mons[0].replicas]
        assert mons[1].up_replicas() == mons[0].up_replicas()
        assert mons[1].next_restart() == mons[0].next_restart()
        assert [mons[1].factor(i, t) for i in range(3)] == \
            [mons[0].factor(i, t) for i in range(3)]
    assert mons[1].log == mons[0].log and mons[1].counts() == mons[0].counts()
    assert tserve.HEALTH_STATES == jserve.HEALTH_STATES
    with pytest.raises(ValueError, match="at least one replica"):
        tserve.HealthMonitor(0)


@pytest.mark.parametrize("mode", ["shed", "queue"])
def test_slo_controller_state_roundtrip_matches_jax(mode):
    kw = dict(target_p99=10.0, mode=mode, window=8, min_samples=4,
              probe_every=3)
    ctl = (jserve.SLOController(jserve.SLOConfig(**kw)),
           tserve.SLOController(tserve.SLOConfig(**kw)))
    rng = np.random.RandomState(1)
    for i in range(40):
        lat = float(rng.exponential(8.0 if i < 20 else 2.0))
        verdicts = []
        for c in ctl:
            c.observe(lat)
            verdicts.append(c.admit(float(i)))
        assert verdicts[1] == verdicts[0]
        assert ctl[1].state_dict() == ctl[0].state_dict()
        assert ctl[1].estimate() == ctl[0].estimate()
        if i == 25:
            fresh = tserve.SLOController(tserve.SLOConfig(**kw))
            fresh.load_state_dict(ctl[1].state_dict())
            ctl = (ctl[0], fresh)
    assert ctl[0].trips >= 1
    assert tserve.SLO_MODES == jserve.SLO_MODES


@pytest.mark.parametrize("build,match", [
    (lambda p: p.SLOConfig(target_p99=1.0, mode="panic"), "slo mode"),
    (lambda p: p.SLOConfig(target_p99=0.0), "target_p99"),
    (lambda p: p.SLOConfig(target_p99=1.0, resume_margin=1.5),
     "resume_margin"),
    (lambda p: p.RouterConfig(num_replicas=0), "num_replicas"),
    (lambda p: p.RouterConfig(num_replicas=2, step_time=0.0), "step_time"),
    (lambda p: p.RouterConfig(num_replicas=2, max_retries=-1),
     "max_retries")])
def test_config_errors_match_jax(build, match):
    for pkg in (jserve, tserve):
        with pytest.raises(ValueError, match=match):
            build(pkg)


@pytest.mark.parametrize("faults,match", [
    ("ckpt_io@3:r0", "router wires only"), ("crash@3:r5", "targets replica")])
def test_router_fault_errors_match_jax(engines, faults, match):
    errors = []
    for pkg, eng in zip((jserve, tserve), engines):
        with pytest.raises(ValueError, match=match) as e:
            pkg.ReplicaRouter(eng, pkg.RouterConfig(num_replicas=2,
                                                    faults=faults))
        errors.append(str(e.value))
    assert errors[1] == errors[0]
    assert tserve.ROUTER_FAULT_KINDS == jserve.ROUTER_FAULT_KINDS


def test_engine_fault_kind_errors_match_jax(qwen):
    jcfg, params, tcfg, tmodel = qwen
    errors = []
    for build in (lambda: jserve.ServeEngine(jcfg, params,
                                             faults="crash@2:w0",
                                             **ENGINE_KW),
                  lambda: tserve.ServeEngine(tcfg, tmodel, device="cpu",
                                             faults="crash@2:w0",
                                             **ENGINE_KW)):
        with pytest.raises(ValueError, match="serve wires only") as e:
            build()
        errors.append(str(e.value))
    assert errors[1] == errors[0]
    assert tserve.SERVE_FAULT_KINDS == jserve.SERVE_FAULT_KINDS


# ---------------------------------------------------------------------------
# StepSession
# ---------------------------------------------------------------------------


def test_step_session_matches_engine_tokens(engines):
    jeng, teng = engines
    jtrace, ttrace = _traces(4, rate=1000.0)
    want = jeng.run(jtrace).tokens_by_rid()
    sess = tserve.StepSession(teng, name="r0")
    got, backlog = {}, list(ttrace)
    while backlog or sess.active:
        while backlog and sess.can_admit(backlog[0]):
            st = sess.admit(backlog.pop(0), 0.0, 0.0)
            if sess.done(st):
                got[st.req.rid] = sess.release(st.req.rid).tokens
        for rid in sess.tick():
            got[rid] = sess.release(rid).tokens
    assert got == want == teng.run(ttrace).tokens_by_rid()


def test_step_session_release_and_evict(engines):
    _, teng = engines
    sess = tserve.StepSession(teng)
    free0 = sess.pool.free_pages
    _, trace = _traces(3, rate=1000.0)
    sess.admit(trace[0], 0.0, 0.0)
    assert sess.pool.free_pages < free0
    sess.release(trace[0].rid)
    assert sess.pool.free_pages == free0 and not sess.active
    assert len(sess.free_slots) == 2
    sts = [sess.admit(r, 0.0, 0.0) for r in trace[:2]]
    slots = {st.req.rid: s for s, st in sess.active.items()}
    evicted = sess.evict_all()
    assert [st.req.rid for st in evicted] == \
        sorted(slots, key=lambda rid: slots[rid])
    assert {id(s) for s in evicted} == {id(s) for s in sts}
    assert sess.pool.free_pages == free0 and not sess._slot_of
    # R sessions never share a pool
    other = tserve.StepSession(teng)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        sess.pool.buffers.values(), other.pool.buffers.values()))


# ---------------------------------------------------------------------------
# The restore bridge, both ways
# ---------------------------------------------------------------------------


def _train_cfg(directory):
    return jbase.TrainConfig(
        model=jconfigs.get_smoke_config(ARCH),
        shape=jbase.ShapeConfig("tiny", 16, 4, "train"),
        aggregation=jbase.AggregationConfig(strategy="full_sync",
                                            num_workers=2),
        optimizer=jbase.OptimizerConfig(name="momentum", learning_rate=0.05,
                                        scale_lr_with_workers=False,
                                        ema_decay=0.9),
        checkpoint=jbase.CheckpointConfig(directory=str(directory),
                                          every_steps=0),
        log_every=10)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restore_bridge_serves_across_packages(tmp_path, writer):
    """A checkpoint written by ``writer``'s trainer (2 steps from the JAX
    init), restored by both packages' ``restore_params`` (params, then
    EMA): the leaves equal, and both engines serve the same greedy
    tokens."""
    jcfg = _train_cfg(tmp_path)
    if writer == "jax":
        tr = jloop.Trainer(jcfg)
        tr.init_state()
        tr.run(2)
        tr.save_checkpoint()
    else:
        params = jget_model(jcfg.model).init(jax.random.PRNGKey(0))
        tr = tloop.Trainer(port_config(jcfg), device="cpu")
        tr.init_state()
        load_jax_params(tr.model, params)
        tr.reset_optimizer_state()
        tr.run(2)
        tr.save_checkpoint()
    tcfg = tconfigs.get_smoke_config(ARCH)
    jtrace, ttrace = _traces(4, rate=1000.0, vocab=jcfg.model.vocab_size)
    served = []
    for use_ema in (False, True):
        jparams, jman = jserve.restore_params(str(tmp_path), jcfg.model,
                                              use_ema=use_ema)
        tmodel, tman = tserve.restore_params(str(tmp_path), tcfg,
                                             use_ema=use_ema, device="cpu")
        assert tman["step"] == jman["step"] == 2
        want = load_jax_params(TransformerLM(tcfg, device="cpu"), jparams)
        for (k, v), w in zip(tmodel.named_parameters(), want.parameters()):
            assert torch.equal(v, w), k
        jtok = jserve.ServeEngine(jcfg.model, jparams,
                                  **ENGINE_KW).run(jtrace).tokens_by_rid()
        ttok = tserve.ServeEngine(tcfg, tmodel, device="cpu",
                                  **ENGINE_KW).run(ttrace).tokens_by_rid()
        assert ttok == jtok and len(ttok) == 4
        served.append(ttok)
    assert served[0] != served[1]          # the EMA is not the raw weights
