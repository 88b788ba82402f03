"""The paper's four remaining figures on the port (``repro_torch.
benchmarks``: ``bench_straggler``, ``bench_layer_staleness``,
``bench_staleness``, ``bench_lr_sweep``) against the reference's
``benchmarks/`` on the CPU. The reference's JSON writer is pointed at
``tmp_path`` (``benchmarks.common.OUT_DIR``), so no file of the repo is
written.

* Figs. 3-4 and Table 1 / Fig. 1 (host numpy): every row's name and
  derived string equal at the reference's quick sizes.
* Fig. 2 from the JAX init, each tau's run cut to ``FIG2_UPDATES`` updates
  (the schedules stay the full run's, in both packages): test errors on
  the EMA within ``FIG2_ERR_TOL`` (two of the 1,024 test images), the
  boolean row equal.
* Table 2 / Fig. 7 from the JAX init, each gamma's run cut to
  ``LR_STEPS`` steps: the held-out losses within ``LR_LOSS_TOL``, the
  boolean rows equal.
"""
import builtins

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_layer_staleness as jlayer
from benchmarks import bench_lr_sweep as jlr
from benchmarks import bench_staleness as jstal
from benchmarks import bench_straggler as jstrag
from benchmarks import common as jcommon

from repro_torch.benchmarks import bench_layer_staleness as tlayer
from repro_torch.benchmarks import bench_lr_sweep as tlr
from repro_torch.benchmarks import bench_staleness as tstal
from repro_torch.benchmarks import bench_straggler as tstrag
from repro_torch.benchmarks import common as tcommon
from repro_torch.models import load_jax_params

FIG2_UPDATES = 20
FIG2_ERR_TOL = 2 / 1024
LR_STEPS = 30
LR_LOSS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reference_writes_to_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(jcommon, "OUT_DIR", str(tmp_path))


def _derived(rows):
    return [(name, derived) for name, _, derived in rows]


def test_straggler_rows_equal_the_reference():
    assert _derived(tstrag.run(True)) == _derived(jstrag.run(True))


def test_layer_staleness_rows_equal_the_reference():
    got = tlayer.simulate_layer_staleness(num_workers=8, num_layers=5,
                                          iters=30, seed=3)
    want = jlayer.simulate_layer_staleness(num_workers=8, num_layers=5,
                                           iters=30, seed=3)
    assert np.array_equal(got, want)
    assert _derived(tlayer.run(True)) == _derived(jlayer.run(True))


# ---------------------------------------------------------------------------
# Fig. 2: the staleness rig from the JAX init
# ---------------------------------------------------------------------------


def _fig2_reference(monkeypatch):
    """The reference's Fig. 2 with each run cut to ``FIG2_UPDATES`` updates
    and its CNN's init jitted (eagerly it compiles each truncated normal
    on its own); returns (rows, the JAX init)."""
    make, simulate = jstal.mnist_cnn.make, jstal.async_sim.simulate_staleness
    init = {}

    def jitted_make(**kw):
        model = make(**kw)
        model.init = jax.jit(model.init)
        init["params"] = model.init(jax.random.PRNGKey(0))
        return model

    def cut(*args, **kw):
        return simulate(*args, **dict(kw, num_updates=FIG2_UPDATES))

    monkeypatch.setattr(jstal.mnist_cnn, "make", jitted_make)
    monkeypatch.setattr(jstal.async_sim, "simulate_staleness", cut)
    rows = jstal.run(True)
    monkeypatch.undo()
    return rows, init["params"]


def test_fig2_errors_and_verdict_match_the_reference(monkeypatch):
    want, params = _fig2_reference(monkeypatch)
    make = tstal.mnist_cnn.make

    def from_jax(**kw):
        return load_jax_params(make(**kw), params)

    monkeypatch.setattr(tstal.mnist_cnn, "make", from_jax)
    got = tstal.run(True, device="cpu", updates=FIG2_UPDATES)
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got[:-1], want[:-1]):
        err = lambda row: float(row[2].split("=")[1])  # noqa: E731
        assert abs(err(g) - err(w)) <= FIG2_ERR_TOL, (g, w)
    assert got[-1][2] == want[-1][2]


# ---------------------------------------------------------------------------
# Table 2 / Fig. 7: the lr sweep from the JAX init
# ---------------------------------------------------------------------------


def test_lr_sweep_losses_and_verdicts_match_the_reference(monkeypatch):
    evals, problem = [], jcommon.tiny_lm_problem

    def recorded_problem(**kw):
        model, p0, grad_fn, batch_fn, eval_fn = problem(**kw)

        def recorded(params):
            evals.append(eval_fn(params))
            return evals[-1]
        return model, p0, grad_fn, batch_fn, recorded

    # the reference's loop is ``for s in range(steps)``: cut it here only
    monkeypatch.setattr(jlr, "range",
                        lambda n: builtins.range(min(n, LR_STEPS)),
                        raising=False)
    monkeypatch.setattr(jlr.common, "tiny_lm_problem", recorded_problem)
    want = jlr.run(True)
    monkeypatch.undo()

    orig, losses = tcommon.tiny_lm_problem, []

    def from_jax(**kw):
        out = orig(**kw)
        load_jax_params(out[0], problem(**{k: v for k, v in kw.items()
                                           if k != "device"})[1])
        model, p0, grad_fn, batch_fn, eval_fn = out

        def recorded(params):
            losses.append(eval_fn(params))
            return losses[-1]
        return model, p0, grad_fn, batch_fn, recorded

    monkeypatch.setattr(tcommon, "tiny_lm_problem", from_jax)
    got = tlr.run(True, device="cpu", steps=LR_STEPS)
    assert len(losses) == len(evals) == 3 * LR_STEPS // tlr.EVAL_EVERY
    np.testing.assert_allclose(losses, evals, rtol=0, atol=LR_LOSS_TOL)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert _derived(got[-2:]) == _derived(want[-2:])


def test_card_figures_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstal.run(True, updates=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlr.run(True, steps=1)
