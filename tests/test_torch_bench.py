"""The port's convergence experiments (``repro_torch.benchmarks``, ROADMAP
Queue 1 item 4) on the CPU at the tiny size, against the JAX package's
``benchmarks`` and ``repro.core.events``.

* ``mean_iteration_time`` and ``estimate_time_to_converge`` bit-equal to
  ``repro.core.events``' for N in {50, 75, 96, 100} of 100 machines under
  two latency models; ``time_to_threshold`` equal to
  ``benchmarks.common``'s on the same arrays.
* Fig. 6: the rows equal those built from the reference's
  ``estimate_time_to_converge`` for the paper fit and for a tiny-LM fit.
* ``tiny_lm_problem`` at the JAX init: batches equal, loss, gradients and
  held-out loss within rtol 1e-5 (per tensor: max |diff| <= 1e-5 x
  max |reference|).
* Fig. 5 at N = 2 from the JAX init: the first 20 training losses within
  1e-4 of the reference's ``steps_to_target`` (recorded through its SGD
  update), and ``steps_to_target`` equal at a target the held-out loss
  crosses with a margin; the fit a + c/N recovers a known curve.
* Figs. 8/9: each of the four regimes for 12 steps (updates) through the
  trainer with the bench's own ``_variant_cfg`` and ``_data_cfg`` (every
  step logged) from the JAX init: losses within 2e-4, ``sim_time``,
  ``selected`` and ``staleness`` equal.
* ``data_cfg=None`` leaves the trainer's stream as it was; a ``data_cfg``
  with noise 0.2 gives the JAX trainer's batches (mask and event modes).
* The runner prints the reference's row names.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from benchmarks import bench_iterations_vs_n as jfig5
from benchmarks import bench_sync_vs_async as jsva
from benchmarks import common as jcommon
from repro.core import events as jevents
from repro.core import straggler as jstraggler
from repro.core.coordination import BackupWorkers as JBackupWorkers
from repro.train import loop as jloop

from repro_torch.benchmarks import bench_iterations_vs_n as tfig5
from repro_torch.benchmarks import bench_sync_vs_async as tsva
from repro_torch.benchmarks import bench_time_to_converge as tfig6
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import run as trun
from repro_torch.core import events as tevents
from repro_torch.core import straggler as tstraggler
from repro_torch.core.coordination import BackupWorkers
from repro_torch.data import synthetic_lm as tdata
from repro_torch.models import from_jax_tree, load_jax_params
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


def _assert_close_per_tensor(got, want_tree, rel=REL):
    want = from_jax_tree(want_tree)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.asarray(want[k], np.float32)
        diff = np.abs(v.detach().numpy() - w).max()
        assert diff <= rel * max(np.abs(w).max(), 1e-30), (k, diff)


# ---------------------------------------------------------------------------
# Host numpy: Fig. 6's estimate and the time to a threshold, bit for bit
# ---------------------------------------------------------------------------

_LATENCY = {
    "paper": (tstraggler.PaperCalibrated, jstraggler.PaperCalibrated),
    "lognormal": (tstraggler.LogNormal, jstraggler.LogNormal),
}


@pytest.mark.parametrize("latency", list(_LATENCY))
@pytest.mark.parametrize("n", [50, 75, 96, 100])
def test_time_to_converge_estimate_bit_equal(n, latency):
    tlat, jlat = _LATENCY[latency]
    got = tevents.mean_iteration_time(BackupWorkers(n, 100 - n), tlat(),
                                      iters=300, seed=3)
    want = jevents.mean_iteration_time(JBackupWorkers(n, 100 - n), jlat(),
                                       iters=300, seed=3)
    assert got == want
    ns, iters = np.array([n, 60]), np.array([1234.5, 987.0])
    gt, gs = tevents.estimate_time_to_converge(ns, iters, 100, tlat(),
                                               sim_iters=200, seed=1)
    wt, ws = jevents.estimate_time_to_converge(ns, iters, 100, jlat(),
                                               sim_iters=200, seed=1)
    assert gt.dtype == wt.dtype and np.array_equal(gt, wt)
    assert np.array_equal(gs, ws)


def _threshold_cases():
    rng = np.random.RandomState(0)
    t = np.cumsum(rng.rand(120))
    falling = 5.0 * np.exp(-t / 20) + 1.0 + 0.3 * rng.randn(120)
    return {"empty": (np.zeros(0), np.zeros(0), 2.0),
            "smoothed": (t, falling, 2.5),            # 120 points: k = 2
            "short": (t[:30], falling[:30], 3.0),
            "never": (t[:30], falling[:30], -1.0)}


@pytest.mark.parametrize("case", list(_threshold_cases()))
def test_time_to_threshold_matches_reference(case):
    times, losses, eps = _threshold_cases()[case]
    got = tcommon.time_to_threshold(times, losses, eps)
    assert got == jcommon.time_to_threshold(times, losses, eps)
    assert (got is None) == (case in ("empty", "never"))


@pytest.mark.parametrize("fit", [None, (50.0, 4000.0)],
                         ids=["paper-fit", "tiny-lm-fit"])
def test_fig6_rows_match_reference_estimate(fit):
    iters_fn, src = tfig6.iters_model(fit)
    assert src == ("paper-fig5-interpolated" if fit is None
                   else "fitted(tiny-lm)")
    ns = list(range(50, 101, 5))
    times, _ = jevents.estimate_time_to_converge(
        np.array(ns), np.array([iters_fn(n) for n in ns]), 100,
        jstraggler.PaperCalibrated(), sim_iters=800, seed=0)
    best = ns[int(np.argmin(times))]
    want = [("time_to_converge.best_split", f"N={best},b={100 - best}"),
            ("time_to_converge.speedup_vs_b0",
             f"{times[-1] / times.min():.2f}x"),
            ("time_to_converge.interior_optimum", str(50 < best < 100))]
    got = [(name, derived) for name, _, derived in tfig6.run(True, fit)]
    assert got == want


def test_fig6_falls_back_to_paper_fit_on_a_flat_fit():
    assert tfig6.iters_model((100.0, 100.0))[1] == "paper-fig5-interpolated"
    a, c = tfig6.paper_fit()
    assert tfig6.iters_model(None)[0](50) == pytest.approx(137.5e3)
    assert a + c / 100 == pytest.approx(76.2e3)


# ---------------------------------------------------------------------------
# The tiny-LM problem and Fig. 5, from the JAX init
# ---------------------------------------------------------------------------


def test_tiny_lm_problem_matches_reference():
    kw = dict(batch=4, workers=2, seed=0)
    _, jparams, jgrad, jbatch, jeval = jcommon.tiny_lm_problem(**kw)
    model, params, grad_fn, batch_fn, eval_fn = tcommon.tiny_lm_problem(
        device="cpu", **kw)
    assert dataclasses.asdict(port_config(jcommon.tiny_lm_config())) == \
        dataclasses.asdict(tcommon.tiny_lm_config())
    load_jax_params(model, jparams)
    for w, d in ((0, 0), (1, 3), (997, 2)):
        tb, jb = batch_fn(w, d), jbatch(w, d)
        for k in jb:
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    jloss, jg = jgrad(jparams, jbatch(1, 5))
    loss, grads = grad_fn(params, batch_fn(1, 5))
    assert float(loss) == pytest.approx(float(jloss), rel=REL)
    _assert_close_per_tensor(grads, jg)
    assert eval_fn(params) == pytest.approx(jeval(jparams), rel=REL)


@pytest.fixture
def jax_init_problem(monkeypatch):
    """The port's ``tiny_lm_problem`` starts from the JAX init of the same
    seed (the reference's ``params0``)."""
    orig, jax_problem = tcommon.tiny_lm_problem, jcommon.tiny_lm_problem

    def problem(**kw):
        out = orig(**kw)
        load_jax_params(out[0], jax_problem(
            **{k: v for k, v in kw.items() if k != "device"})[1])
        return out

    monkeypatch.setattr(tcommon, "tiny_lm_problem", problem)


@pytest.fixture
def jax_fig5(monkeypatch):
    """Runs the reference's ``steps_to_target`` and returns (result,
    training losses, held-out evaluations): each step's loss recomputed
    from the parameters its SGD update received."""
    seen, evals, problems = [], [], []
    problem, sgd = jcommon.tiny_lm_problem, jcommon.sgd_update_fn

    def tiny_lm_problem(**kw):
        model, p0, g, batch_fn, eval_fn = problem(**kw)
        problems.append((model, batch_fn))

        def recorded_eval(params):
            evals.append(eval_fn(params))
            return evals[-1]
        return model, p0, g, batch_fn, recorded_eval

    def sgd_update_fn(lr):
        update = sgd(lr)

        def recorded(params, opt_state, grads, step):
            seen.append(params)
            return update(params, opt_state, grads, step)
        return recorded

    monkeypatch.setattr(jcommon, "tiny_lm_problem", tiny_lm_problem)
    monkeypatch.setattr(jcommon, "sgd_update_fn", sgd_update_fn)

    def run(n, target, max_steps, n_losses):
        seen.clear()
        evals.clear()
        steps = jfig5.steps_to_target(n, target, max_steps)
        model, batch_fn = problems[-1]

        @jax.jit
        def loss(params, batches):
            per_worker = []
            for b in batches:
                lt, aux = model.per_token_loss(params, b)
                per_worker.append(lt.mean() + aux)
            return sum(per_worker) / len(per_worker)
        losses = [float(loss(p, [batch_fn(w, t) for w in range(n)]))
                  for t, p in enumerate(seen[:n_losses])]
        return steps, losses, list(evals)

    return run


def test_fig5_losses_and_steps_match_reference(jax_init_problem, jax_fig5):
    want_steps, want_losses, evals = jax_fig5(2, 3.35, 40, 20)
    losses = []
    got = tfig5.steps_to_target(2, 3.35, 40, device="cpu", losses=losses)
    assert len(losses) >= 20
    np.testing.assert_allclose(losses[:20], want_losses, rtol=0, atol=1e-4)
    # the target is crossed at an evaluation clear of it on both sides
    assert want_steps == 25 and min(abs(e - 3.35) for e in evals) > 1e-2
    assert got == want_steps


# ---------------------------------------------------------------------------
# Figs. 8/9: the four regimes through the trainer, from the JAX init
# ---------------------------------------------------------------------------

_STEPS = 12
_REGIMES = {name: (strategy, dict(kw, steps=_STEPS))
            for name, strategy, kw in tsva._regimes(6, 2, _STEPS, 0.08)}


@pytest.mark.parametrize("name", list(_REGIMES))
def test_sync_vs_async_regime_matches_reference(name):
    strategy, kw = _REGIMES[name]
    jcfg = dataclasses.replace(jsva._variant_cfg(strategy, **kw),
                               log_every=1)
    tcfg = dataclasses.replace(tsva._variant_cfg(strategy, **kw),
                               log_every=1)
    assert port_config(jcfg) == tcfg
    assert dataclasses.asdict(jsva._data_cfg(jcfg)) == \
        dataclasses.asdict(tsva._data_cfg(tcfg))
    want = jloop.run_experiment(jcfg, data_cfg=jsva._data_cfg(jcfg))
    tr = tloop.Trainer(tcfg, device="cpu", data_cfg=tsva._data_cfg(tcfg))
    tr.init_state()
    load_jax_params(tr.model, jcommon.tiny_lm_problem()[1])
    tr.reset_optimizer_state()
    if tr.strategy.kind == "event":
        tr._init_event_state()
    got = tr.run(_STEPS)
    assert got.steps == want.steps == _STEPS
    assert len(got.metrics) == len(want.metrics) == _STEPS
    for a, b in zip(got.metrics, want.metrics):
        assert a["loss"] == pytest.approx(b["loss"], rel=0, abs=2e-4)
        for k in ("step", "sim_time", "selected", "staleness"):
            assert a[k] == b[k], k
    assert got.sim_time == want.sim_time
    assert got.mean_selected == want.mean_selected
    assert got.mean_staleness == want.mean_staleness


# ---------------------------------------------------------------------------
# The trainer's data_cfg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["backup", "async"])
def test_data_cfg_default_and_override(strategy):
    kw = dict(_REGIMES["sync_backup" if strategy == "backup" else "async"][1])
    tcfg = tsva._variant_cfg(strategy, **kw)
    jcfg = jsva._variant_cfg(strategy, **kw)
    total = tcfg.aggregation.total_workers
    # no data_cfg: the stream the trainer always drew (default noise 0.1)
    default = tdata.SyntheticLMConfig(
        vocab_size=tcfg.model.vocab_size, seq_len=tcfg.shape.seq_len,
        global_batch=tcfg.shape.global_batch, num_workers=total,
        seed=tcfg.seed)
    runs = {"default": (tloop.Trainer(tcfg, device="cpu"), default,
                        jloop.Trainer(jcfg)),
            "noise 0.2": (tloop.Trainer(tcfg, device="cpu",
                                        data_cfg=tsva._data_cfg(tcfg)),
                          tsva._data_cfg(tcfg),
                          jloop.Trainer(jcfg, data_cfg=jsva._data_cfg(jcfg)))}
    for key, (tr, data_cfg, jtr) in runs.items():
        assert tr.data_cfg == data_cfg, key
        if strategy == "backup":
            for step in range(2):
                got, want = tr.pipeline.next(), jtr.pipeline.next()
                assert all(np.array_equal(got[k], want[k]) for k in want)
                assert all(np.array_equal(
                    got[k], tdata.global_batch(data_cfg, step)[k])
                    for k in got)
        else:
            for w, d in ((0, 0), (7, 2)):
                got, want = tr._event_batch_host(w, d), \
                    jtr._event_batch_host(w, d)
                assert all(np.array_equal(got[k], np.asarray(want[k]))
                           for k in want)
                assert all(np.array_equal(
                    got[k], tdata.worker_batch(data_cfg, w, d)[k])
                    for k in got)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


# the harness benches after the figures, in the runner's order
HARNESS = ("event_loop", "spmd", "recovery", "serve", "obs", "step_time",
           "router", "loop")
_HARNESS_MODULES = dict(event_loop="bench_event_loop", spmd="bench_spmd",
                        recovery="bench_recovery", serve="bench_serve",
                        obs="bench_obs", step_time="bench_step_time",
                        router="bench_router", loop="bench_loop_overhead")


def _stub_harness(monkeypatch, fail=None):
    """Each harness bench's ``run`` returns one row ``<name>.row`` (their
    rows' names are held to the reference's in tests/test_torch_harness*.py);
    ``fail``'s raises."""
    import importlib
    for name, mod in _HARNESS_MODULES.items():
        def run(quick, device=None, name=name, **kw):
            if name == fail:
                raise RuntimeError("boom")
            return [(f"{name}.row", 1.0, "ok")]
        monkeypatch.setattr(importlib.import_module(
            f"repro_torch.benchmarks.{mod}"), "run", run)


def test_runner_prints_the_reference_rows(monkeypatch, capsys):
    """Fig. 5's search is stubbed (its CPU cost is the steps); Fig. 6 runs
    on its fit, Fig. 2's runs stop after 2 updates, the lr sweep's after 2
    steps and Figs. 8/9 run 2 sync steps; Figs. 3-4 and Table 1 run at
    their quick sizes (host numpy); the harness benches are stubbed, in
    order after the figures."""
    from functools import partial
    from repro_torch.benchmarks import bench_lr_sweep, bench_staleness
    monkeypatch.setattr(tfig5, "steps_to_target",
                        lambda n, target, max_steps, **kw: 40 + 400 // n)
    monkeypatch.setattr(bench_staleness, "run",
                        partial(bench_staleness.run, updates=2))
    monkeypatch.setattr(bench_lr_sweep, "run",
                        partial(bench_lr_sweep.run, steps=2))
    _stub_harness(monkeypatch)
    trun.main(["--device", "cpu", "--steps", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [line.split(",")[0] for line in lines[1:]]
    assert names == [
        "straggler.sim_iter", "straggler.k98_cdf2s", "straggler.k100_cdf2s",
        "straggler.mean_k100", "layer_staleness.sim_iter",
        "layer_staleness.bottom_layer", "layer_staleness.top_layer",
        "layer_staleness.bottom_over_top",
        "layer_staleness.monotone_in_depth",
        "iters_vs_n.N1", "iters_vs_n.N2", "iters_vs_n.N4", "iters_vs_n.N8",
        "iters_vs_n.range_ratio", "time_to_converge.best_split",
        "time_to_converge.speedup_vs_b0", "time_to_converge.interior_optimum",
        "staleness.tau0", "staleness.tau5", "staleness.tau10",
        "staleness.tau15", "staleness.monotone_degradation",
        "lr_sweep.g0.05", "lr_sweep.g0.2", "lr_sweep.g0.8",
        "lr_sweep.best_gamma", "lr_sweep.small_lr_worse_optimum",
        "sync_vs_async.sync_backup", "sync_vs_async.sync_full",
        "sync_vs_async.async", "sync_vs_async.softsync",
        "sync_vs_async.backup_better_final_than_async",
        "sync_vs_async.backup_faster_than_fullsync"] + [
        f"{name}.row" for name in HARNESS]
    assert lines[10].endswith(",iters=440")
    assert lines[14].endswith(",4.89x fewer iters at 8x workers")


def test_runner_reports_a_failed_bench_and_exits_1(monkeypatch, capsys):
    """As the reference's runner: ``<name>.ERROR`` and the rest still run,
    then exit status 1 (the figures stubbed out)."""
    from repro_torch.benchmarks import (bench_iterations_vs_n, bench_lr_sweep,
                                        bench_staleness, bench_straggler,
                                        bench_sync_vs_async,
                                        bench_layer_staleness)
    for mod in (bench_straggler, bench_layer_staleness, bench_staleness,
                bench_lr_sweep, bench_sync_vs_async, tfig6):
        monkeypatch.setattr(mod, "run", lambda *a, **kw: [])
    monkeypatch.setattr(bench_iterations_vs_n, "run",
                        lambda *a, **kw: ([], None))
    _stub_harness(monkeypatch, fail="recovery")
    with pytest.raises(SystemExit) as exit_:
        trun.main(["--device", "cpu"])
    assert exit_.value.code == 1
    names = [line.split(",")[0]
             for line in capsys.readouterr().out.splitlines()[1:]]
    assert names == [f"{n}.ERROR" if n == "recovery" else f"{n}.row"
                     for n in HARNESS]


@pytest.mark.parametrize("argv,rc", [
    (["--mesh-data", "1", "--mesh-models", "1"], None),
    (["--mesh-data", "1"], 1),
], ids=["m1", "m1_m2"])
def test_runner_runs_bench_spmd_on_one_card(monkeypatch, capsys, argv, rc):
    """The runner on one card (``device_count`` 1): ``--mesh-data 1
    --mesh-models 1`` passes both to bench_spmd, whose cells then need one
    card each; without ``--mesh-models`` its M = 2 cells need 2 cards and
    the runner prints ``spmd.ERROR`` naming them, then exits 1. The other
    benches are stubbed; bench_spmd's timing is stubbed (no card here),
    its bytes planned as on the card."""
    from repro_torch.benchmarks import (bench_iterations_vs_n, bench_lr_sweep,
                                        bench_staleness, bench_straggler,
                                        bench_sync_vs_async,
                                        bench_layer_staleness)
    from repro_torch.benchmarks import bench_spmd as tspmd
    for mod in (bench_straggler, bench_layer_staleness, bench_staleness,
                bench_lr_sweep, bench_sync_vs_async, tfig6):
        monkeypatch.setattr(mod, "run", lambda *a, **kw: [])
    monkeypatch.setattr(bench_iterations_vs_n, "run",
                        lambda *a, **kw: ([], None))
    spmd_run = tspmd.run
    _stub_harness(monkeypatch)
    monkeypatch.setattr(tspmd, "run", spmd_run)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card = torch.device("cuda", 0)
    monkeypatch.setattr(trun, "resolve_device", lambda d=None: card)
    monkeypatch.setattr(tspmd, "resolve_device", lambda d=None: card)
    timed = []

    def time_cells(specs, steps, reps, device, tracer=None, metrics=None):
        timed.extend(specs)
        return [0.5] * len(specs), [0] * len(specs)

    monkeypatch.setattr(tspmd, "_time_cells", time_cells)
    if rc is None:
        trun.main(argv)
    else:
        with pytest.raises(SystemExit) as exit_:
            trun.main(argv)
        assert exit_.value.code == rc
    out = capsys.readouterr().out.splitlines()[1:]
    spmd = [line for line in out if line.startswith("spmd.")]
    if rc is None:
        assert [(b, m, d) for b, _, _, m, d in timed] == \
            [("sim", 1, w) for w in (4, 4, 8, 8)] + [("spmd", 1, 1)] * 4
        assert [line.split(",")[0] for line in spmd] == [
            "spmd.sim_w4_chunk1_m1", "spmd.sim_w4_chunk32_m1",
            "spmd.sim_w8_chunk1_m1", "spmd.sim_w8_chunk32_m1",
            "spmd.spmd_w4_chunk1_m1_d1", "spmd.spmd_w4_chunk32_m1_d1",
            "spmd.spmd_w8_chunk1_m1_d1", "spmd.spmd_w8_chunk32_m1_d1",
            "spmd.spmd_vs_sim_w4_chunk1_m1_d1",
            "spmd.spmd_vs_sim_w4_chunk32_m1_d1",
            "spmd.spmd_vs_sim_w8_chunk1_m1_d1",
            "spmd.spmd_vs_sim_w8_chunk32_m1_d1"]
    else:
        assert not timed
        assert len(spmd) == 1 and spmd[0].startswith("spmd.ERROR,0,")
        assert "needs 2 cards" in spmd[0]


def test_fig5_fit_recovers_a_plus_c_over_n(monkeypatch):
    monkeypatch.setattr(tfig5, "steps_to_target",
                        lambda n, target, max_steps, **kw: 40 + 400 // n)
    rows, (a, c) = tfig5.run(True, device="cpu")
    assert (a, c) == (pytest.approx(40.0), pytest.approx(400.0))
    assert [r[2] for r in rows[:4]] == ["iters=440", "iters=240",
                                        "iters=140", "iters=90"]


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcommon.tiny_lm_problem()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trun.main([])
    # the harness benches (check_spmd_regression runs nothing: host logic)
    import importlib
    for mod in _HARNESS_MODULES.values():
        main = importlib.import_module(f"repro_torch.benchmarks.{mod}").main
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])
