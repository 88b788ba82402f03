"""The port's harness benches on the training side (``repro_torch.
benchmarks``: ``bench_recovery``, ``bench_spmd``, ``bench_loop_overhead``,
``bench_event_loop``) against the reference's ``benchmarks/`` on the CPU.
The reference's ``bench_spmd`` is not imported: it forces 16 host devices
into ``XLA_FLAGS`` when imported. Its ``write_bench`` is patched in every
reference module these tests run (as in ``tests/test_torch_harness.py``).

* ``bench_recovery --steps 12`` from the JAX init (the preemption at
  step 10 fires and is restored): ``restores`` and ``recovery_events``
  equal, each arm's ``final_loss`` within the trainer parity tolerance
  (rtol 2e-4 / atol 2e-5, ``tests/test_torch_faults.py``), ``loss_delta``
  within twice that.
* ``bench_spmd``: one spawn of 2 gloo ranks at W = 2, M = 1, chunks 1 and
  2: the bytes axis is ``(P_local + 2) x 4`` (one all-reduce of the
  reduced gradient with the loss and aux sums at ``bucket_size = 0``),
  the reference's figure at m1 (49,672 B for its 1-layer d32 model), and
  the guard passes the payload against itself; the m2 bytes from the dry
  run's plan without a spawn (the data axis ``(P_local + 2) x 4`` at the
  rank's P_local, the model axis's all-reduces beside it); a cell
  larger than the visible cards raises naming its count; ``--platform``
  is refused; the rows carry the reference's names.
* ``bench_loop_overhead`` and ``bench_event_loop`` at the reference's
  quick settings on a 1-layer d32 stand-in for the smoke model, one timed
  round a config, the loop's host backend (both packages): the payload's
  keys and each row's keys equal the reference's, every rate positive.

Wall-clock ratios are printed, never asserted.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from benchmarks import bench_event_loop as jevents
from benchmarks import bench_loop_overhead as jloop_bench
from benchmarks import bench_recovery as jrecovery
from benchmarks import common as jcommon
from repro import configs as jconfigs
from repro.configs.base import replace as jreplace
from repro.models import get_model as jget_model

from repro_torch import configs as tconfigs
from repro_torch.benchmarks import bench_event_loop as tevents
from repro_torch.benchmarks import bench_loop_overhead as tloop_bench
from repro_torch.benchmarks import bench_recovery as trecovery
from repro_torch.benchmarks import bench_spmd as tspmd
from repro_torch.benchmarks import check_spmd_regression as tguard
from repro_torch.configs.base import replace as treplace
from repro_torch.launch import dryrun
from repro_torch.models import load_jax_params
from repro_torch.train import loop as tloop
import torch_parity  # noqa: F401  (TF32 off)

RTOL, ATOL = 2e-4, 2e-5
# the reference's bytes-moved figure at m1 (its HLO, any W, chunk 1)
REFERENCE_M1_BYTES = 49_672


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reference_writes_nowhere(tmp_path, monkeypatch):
    for mod in (jrecovery, jloop_bench, jevents):
        monkeypatch.setattr(mod, "write_bench",
                            lambda name, payload, mirror=None: str(tmp_path))
    monkeypatch.setattr(jcommon, "OUT_DIR", str(tmp_path))


# ---------------------------------------------------------------------------
# bench_recovery from the JAX init
# ---------------------------------------------------------------------------


def test_recovery_arms_match_reference(monkeypatch):
    params = jget_model(jcommon.tiny_lm_config()).init(
        jax.random.PRNGKey(0))
    orig = tloop.Trainer.init_state

    def init_state(self, seed=None):
        orig(self, seed)
        load_jax_params(self.model, params)
        self.reset_optimizer_state()

    monkeypatch.setattr(tloop.Trainer, "init_state", init_state)
    want = jrecovery.main(["--steps", "12"])
    got = trecovery.main(["--device", "cpu", "--steps", "12"])
    assert sorted(got) == sorted(want)
    (gc, gx), (wc, wx) = got["results"], want["results"]
    assert (gx["restores"], gx["recovery_events"]) == \
        (wx["restores"], wx["recovery_events"])
    assert gx["restores"] >= 1 and (gc["steps"], gx["steps"]) == \
        (wc["steps"], wx["steps"])
    for g, w in ((gc, wc), (gx, wx)):
        assert abs(g["final_loss"] - w["final_loss"]) <= \
            ATOL + RTOL * abs(w["final_loss"]), g["arm"]
    tol = 2 * (ATOL + RTOL * abs(wc["final_loss"]))
    assert abs(got["loss_delta"] - want["loss_delta"]) <= tol
    assert got["mttr_s"] > 0 and got["chaos_overhead_x"] > 0
    print(f"recovery MTTR {got['mttr_s']:.3f} s, chaos overhead "
          f"{got['chaos_overhead_x']:.2f}x (CPU)")


# ---------------------------------------------------------------------------
# bench_spmd
# ---------------------------------------------------------------------------


def _params(cfg) -> int:
    return dryrun.plan_train(cfg)["params_local"]


def test_spmd_spawned_cells_bytes_axis(tmp_path):
    path = tmp_path / "spmd.json"
    got = tspmd.main(["--device", "cpu", "--quick", "--workers", "2",
                      "--chunks", "1", "2", "--mesh-models", "1",
                      "--out", str(path)])
    p = _params(tspmd.train_config("spmd", 2, 1))
    assert (p + 2) * 4 == REFERENCE_M1_BYTES
    assert {k: v for k, v in got.items() if k.startswith("spmd_bytes")} == \
        {"spmd_bytes_per_step_w2_chunk1_m1": REFERENCE_M1_BYTES,
         "spmd_bytes_per_step_w2_chunk2_m1": REFERENCE_M1_BYTES}
    assert sorted(k for k in got if k.startswith("spmd_vs_sim")) == \
        ["spmd_vs_sim_w2_chunk1_m1", "spmd_vs_sim_w2_chunk2_m1"]
    rows = got["results"]
    assert [(r["backend"], r["chunk_size"], r["mesh_data"]) for r in rows] \
        == [("sim", 1, 2), ("sim", 2, 2), ("spmd", 1, 2), ("spmd", 2, 2)]
    assert all(r["steps_per_s"] > 0 and r["steps"] == 32 for r in rows)
    assert [r["collective_ops_per_step"] for r in rows] == [0, 0, 1, 1]
    assert [r["backup_reduce_launches"] for r in rows] == [0] * 4  # no card
    assert got["max_ranks"] == 2
    assert tguard.main([str(path), str(path)]) == 0


def test_spmd_m2_bytes_from_the_plan():
    """The m2 cells' bytes without a spawn: the 'data' axis carries
    ``(P_local + 2) x 4`` (P_local: the rank's slice of the sharded leaves
    and the whole replicated ones), the 'model' axis its all-reduces (the
    reference's HLO count differs: ROADMAP Queue 3's known
    differences)."""
    for w in tspmd.WORKER_COUNTS:
        cfg = tspmd.train_config("spmd", w, 1, mesh_model=2)
        plan = dryrun.plan_train(cfg)
        p_local = plan["params_local"]
        axis = plan["collectives"]["per_axis"]
        assert p_local < _params(tspmd.train_config("spmd", w, 1))
        assert (axis["data"]["count"], axis["data"]["bytes"]) == \
            (1, (p_local + 2) * 4)
        assert axis["model"]["count"] == 11
        assert tspmd.collective_bytes_per_step(cfg) == {
            "collective_bytes_per_step": axis["data"]["bytes"]
            + axis["model"]["bytes"], "collective_ops_per_step": 12.0}
    assert tspmd.collective_bytes_per_step(
        tspmd.train_config("sim", 4, 1)) == {
            "collective_bytes_per_step": 0.0, "collective_ops_per_step": 0.0}


def test_spmd_cell_larger_than_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 cards"):
        tspmd.ranks_needed(4, 1, 4, "cuda")
    with pytest.raises(ValueError, match="needs 2 cards"):
        tspmd.ranks_needed(8, 2, 1, "cuda")
    assert tspmd.ranks_needed(8, 1, 1, "cuda") == 1
    with pytest.raises(ValueError, match="must divide"):
        tspmd.ranks_needed(4, 1, 3, "cpu")
    assert tspmd.ranks_needed(8, 2, 8, "cpu") == 16
    with pytest.raises(SystemExit):
        tspmd.main(["--device", "cpu", "--platform", "cpu"])


def test_spmd_rows_are_the_reference_names(monkeypatch):
    results = [{"backend": b, "workers": 4, "chunk_size": 1, "mesh_model": m,
                "mesh_data": d, "steps_per_s": 2.0}
               for b, m, d in (("sim", 1, 4), ("spmd", 2, 4), ("spmd", 1, 2))]
    monkeypatch.setattr(tspmd, "main", lambda argv: {
        "results": results, "spmd_vs_sim_w4_chunk1_m2": 0.5})
    assert [name for name, _, _ in tspmd.run(True, device="cpu")] == [
        "spmd.sim_w4_chunk1_m1", "spmd.spmd_w4_chunk1_m2",
        "spmd.spmd_w4_chunk1_m1_d2", "spmd.spmd_vs_sim_w4_chunk1_m2"]


# ---------------------------------------------------------------------------
# The loop and event-loop overheads
# ---------------------------------------------------------------------------


def _tiny(cfg, replace):
    return replace(cfg, num_layers=1, d_model=32, num_heads=2,
                   num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)


@pytest.fixture
def tiny_smoke(monkeypatch):
    """Both packages' qwen3 smoke config cut to 1 layer at d 32 and one
    timed round a config (the benches' shapes, steps and configs
    unchanged)."""
    jget, tget = jconfigs.get_smoke_config, tconfigs.get_smoke_config
    monkeypatch.setattr(jconfigs, "get_smoke_config",
                        lambda arch: _tiny(jget(arch), jreplace))
    monkeypatch.setattr(tconfigs, "get_smoke_config",
                        lambda arch: _tiny(tget(arch), treplace))
    for mod in (jloop_bench, jevents, tloop_bench, tevents):
        monkeypatch.setattr(mod, "measure_all",
                            functools.partial(mod.measure_all, reps=1))


def _same_keys(got, want, rows, rate):
    assert sorted(got) == sorted(want)
    assert [sorted(r) for r in got[rows]] == [sorted(r) for r in want[rows]]
    assert all(r[rate] > 0 for r in got[rows])


def test_loop_overhead_payload_keys(tiny_smoke):
    """The host backend (the device backend's chunks: tests/
    test_torch_straggler_device.py)."""
    want = jloop_bench.main(["--quick", "--host-only"])
    got = tloop_bench.main(["--device", "cpu", "--quick", "--host-only"])
    _same_keys(got, want, "results", "steps_per_s")
    assert [(r["chunk_size"], r["backend"]) for r in got["results"]] == \
        [(r["chunk_size"], r["backend"]) for r in want["results"]]
    print(f"loop speedup 32 vs 1 {got['speedup_32_vs_1']:.2f}x (CPU)")


def test_event_loop_payload_keys(tiny_smoke):
    want = jevents.main(["--quick"])
    got = tevents.main(["--device", "cpu", "--quick"])
    _same_keys(got, want, "results", "updates_per_s")
    for s in tevents.STRATEGIES:
        assert sorted(got[s]) == sorted(want[s])
    names = [(r["strategy"], r["chunk_size"]) for r in got["results"]]
    assert names == [(r["strategy"], r["chunk_size"])
                     for r in want["results"]]
    assert np.isfinite(got["speedup_32_vs_1"])
    print(f"event loop async speedup 32 vs 1 {got['speedup_32_vs_1']:.2f}x "
          f"(CPU)")
