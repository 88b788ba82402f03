"""The port's dry run (``repro_torch.launch.dryrun``), its mesh layouts
(``repro_torch.launch.mesh``) and roofline (``repro_torch.benchmarks.
roofline``), on the CPU.

* Resident bytes: a plan on ``meta`` tensors equals, byte for byte, what a
  built port ``Trainer`` on the CPU holds after one step (its parameters,
  optimizer state, EMA and gradient stack, measured by the same tracker),
  at grad_batch 1, 0 and 2; its step peak equals the tracker's reading of
  that real step with its reduce written in place, as the kernel writes
  it (the plain twin's reduce allocates rows the kernel does not).
* Collectives: the ``'data'`` axis' one all-reduce of ``(P_local + 2) x 4``
  bytes at ``bucket_size`` 0 (P at 2 x 1, P_local at 2 x 2), none on one
  card; the ``'model'`` axis' all-reduces as many as a real step in a
  ``fake`` world of 2 counts in ``tp.all_reduces``.
* A refused cell names its reason (no TP hooks; a serve cell at M > 1; a
  batch that does not split); ``cell_is_skipped`` is the reference's.
* The port's ``analyze_cell`` with the reference's constants and
  ``model_shard = 16`` equals the reference's on the same records.
* Full-width published cells (qwen3-0.6b, rwkv6-1.6b, qwen2-moe-a2.7b)
  plan without allocating (the process's peak RSS grows < 1 GB).
* The CLI writes its record; the reference's policy flags are refused by
  name.
"""
import dataclasses
import json
import resource

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import roofline as jroof
from repro import configs as jconfigs

from repro_torch import configs
from repro_torch.benchmarks import roofline
from repro_torch.configs.base import (AggregationConfig, CheckpointConfig,
                                      ExecutionConfig, OptimizerConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.straggler import PaperCalibrated
from repro_torch.distributed import tp
from repro_torch.kernels import counters
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as layouts
from repro_torch.launch.profile_train import train_config
from repro_torch.train.loop import Trainer
from torch_parity import fake_world_of_two  # noqa: F401  (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _smoke_cfg(grad_batch=0, mesh_data=1, mesh_model=1, arch="qwen3-0.6b",
               workers=(3, 1), ema=0.999):
    n, b = workers
    return TrainConfig(
        model=configs.get_smoke_config(arch),
        shape=ShapeConfig("smoke", 16, 2 * (n + b), "train"),
        aggregation=AggregationConfig(strategy="backup", num_workers=n,
                                      backup_workers=b),
        optimizer=OptimizerConfig(name="rmsprop_momentum", learning_rate=0.01,
                                  ema_decay=ema),
        checkpoint=CheckpointConfig(every_steps=0),
        execution=ExecutionConfig(backend="spmd", grad_batch=grad_batch,
                                  mesh_data=mesh_data, mesh_model=mesh_model),
        seed=0, total_steps=1, log_every=1)


def _real_step(cfg):
    """A built trainer on the CPU, one step, under the dry run's tracker:
    (bytes live after the step, the step's peak, the trainer)."""
    with dryrun.MemoryTracker() as mem:
        tr = Trainer(cfg, latency=PaperCalibrated(), device="cpu")
        tr.init_state()
        mem.reset_peak()
        tr.run(1)
    return mem.live, mem.peak, tr


# ---------------------------------------------------------------------------
# Resident bytes and the peak, against a real trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-1.6b"])
@pytest.mark.parametrize("grad_batch", [1, 0, 2])
def test_resident_bytes_equal_a_built_trainer(arch, grad_batch):
    cfg = _smoke_cfg(grad_batch, arch=arch)
    plan = dryrun.plan_train(cfg)
    live, _, tr = _real_step(cfg)
    res = plan["memory"]["resident"]
    assert plan["memory"]["argument_bytes"] == live
    assert res["params"] == dryrun.tensor_bytes(tr.params)
    assert res["opt_state"] == dryrun.tensor_bytes(tr.opt_state)
    assert res["ema"] == dryrun.tensor_bytes(tr.ema)
    p = sum(v.numel() for v in tr.params.values())
    assert plan["params_local"] == p
    assert res["grad_stack"] == -(-4 * p * 4 // 512) * 512   # [4, P] f32
    assert res["other"] == 0
    assert plan["memory"]["temp_bytes"] == \
        plan["memory"]["peak_bytes"] - plan["memory"]["argument_bytes"] > 0


def _reduce_in_place(grads, mask, n_aggregate, *, out):
    """The masked mean written straight into ``out``, allocating nothing:
    what the ``backup_reduce`` kernel allocates."""
    out.zero_()
    for w in range(grads.shape[0]):
        out.add_(grads[w], alpha=float(mask[w]))
    return out.mul_(1.0 / n_aggregate)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("grad_batch", [1, 0, 2])
def test_peak_equals_a_real_step_with_the_kernels_allocations(arch,
                                                              grad_batch):
    """The real CPU step with its reduce written in place (as the kernel
    writes it) peaks where the plan does, byte for byte (vmap through
    ``common.Remat`` at grad_batch 0 and 2 included). With the plain
    twin's reduce the CPU step peaks higher, never lower."""
    from unittest import mock
    from repro_torch.distributed import spmd_engine
    from repro_torch.kernels import bucketed_reduce
    cfg = _smoke_cfg(grad_batch, arch=arch)
    plan = dryrun.plan_train(cfg)
    live, plain_peak, _ = _real_step(cfg)
    with mock.patch.object(spmd_engine, "resolve_use_kernel",
                           lambda *a: True), \
            mock.patch.object(bucketed_reduce, "backup_reduce",
                              _reduce_in_place):
        live, peak, _ = _real_step(cfg)
    assert plan["memory"]["argument_bytes"] == live
    assert plan["memory"]["peak_bytes"] == peak <= plain_peak


def test_plan_launches_nothing_and_restores_counts():
    before = counters.read()
    plan = dryrun.plan_train(_smoke_cfg(0, arch="rwkv6-1.6b"))
    assert counters.read() == before
    assert plan["collectives"]["num_ops"] == 0


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2), (1, 2), (1, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_data_axis_all_reduce_is_p_local_plus_two(mesh):
    d, m = mesh
    plan = dryrun.plan_train(_smoke_cfg(0, mesh_data=d, mesh_model=m))
    axes = plan["collectives"]["per_axis"]
    p_local = plan["params_local"]
    if d > 1:
        assert axes["data"] == {"count": 1.0, "bytes": (p_local + 2) * 4.0,
                                "wire_bytes": (p_local + 2) * 4.0}
    else:
        assert "data" not in axes
    assert ("model" in axes) == (m > 1)
    full = sum(v.numel() for v in torch.nn.Module.parameters(
        __import__("repro_torch.models", fromlist=["get_model"]).get_model(
            configs.get_smoke_config("qwen3-0.6b"), device="meta",
            generator=torch.Generator())))
    assert (p_local == full) == (m == 1)
    assert plan["collectives"]["per_kind"]["all-reduce"]["count"] == \
        sum(a["count"] for a in axes.values()) if axes else True


def test_model_axis_all_reduces_as_a_real_step_counts(fake_world_of_two):
    """A real CPU step at mesh 1 x 2 in a ``fake`` world of 2 (collectives
    return at once) counts its model-group all-reduces in
    ``tp.all_reduces``; the plan, made in its own world afterwards,
    records as many."""
    import torch.distributed as dist
    from repro_torch.distributed import mesh as mesh_lib
    cfg = _smoke_cfg(0, mesh_model=2)
    before = tp.all_reduces
    tr = Trainer(cfg, latency=PaperCalibrated(), device="cpu")
    tr.init_state()
    tr.run(1)
    issued = tp.all_reduces - before
    del tr
    mesh_lib._mesh.clear()
    dist.destroy_process_group()
    try:
        plan = dryrun.plan_train(cfg)
    finally:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=2)
    assert issued > 0
    assert plan["collectives"]["per_axis"]["model"]["count"] == issued


def test_a_world_already_joined_is_refused(fake_world_of_two):
    with pytest.raises(RuntimeError, match="world of its own"):
        dryrun.plan_train(_smoke_cfg(0, mesh_model=2))


# ---------------------------------------------------------------------------
# Cells: refusals, skips, records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,mesh,match", [
    ("rwkv6-1.6b", "train_4k", "1x2", "ssm family carries no tensor"),
    ("hymba-1.5b", "decode_32k", "2x2", "hybrid family"),
    ("whisper-tiny", "train_4k", "single", "audio family"),
    ("qwen3-0.6b", "decode_32k", "1x2", "replica on one card"),
    ("gemma3-1b", "long_500k", "2x1", "does not split over 2 replicas"),
])
def test_refused_cells_name_their_reason(arch, shape, mesh, match):
    r = dryrun.run_cell(arch, shape, mesh, out_dir=None)
    assert r["status"] == "refused" and match in r["reason"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_cell_is_skipped_is_the_reference(shape):
    for arch in configs.list_archs():
        assert configs.cell_is_skipped(arch, shape) == \
            jconfigs.cell_is_skipped(arch, shape)
    r = dryrun.run_cell("qwen3-0.6b", "long_500k", out_dir=None)
    assert r["status"] == "skipped"


def _record(arch, shape, mesh, devices, model, zero1):
    return {"arch": arch, "shape": shape, "mesh": mesh, "tag": "",
            "kind": jconfigs.SHAPES_BY_NAME[shape].kind, "devices": devices,
            "mesh_model": model, "status": "ok", "policy": {"zero1": zero1},
            "collectives": {"per_kind": {
                "all-reduce": {"count": 3.0, "bytes": 1.5e9,
                               "wire_bytes": 1.75e9},
                "all-gather": {"count": 1.0, "bytes": 2e8}}},
            "memory": {"argument_bytes": 7e9, "temp_bytes": 3e9},
            "cost": {"flops": 1.25e12}}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b",
                                  "rwkv6-1.6b", "whisper-tiny",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_analyze_cell_equals_the_reference_on_its_constants(arch, shape):
    rec = _record(arch, shape, "single", 256, 16, shape != "decode_32k")
    got = roofline.analyze_cell(rec, peak_flops=jroof.PEAK_FLOPS,
                                hbm_bw=jroof.HBM_BW, link_bw=jroof.ICI_BW,
                                model_shard=16)
    assert got == jroof.analyze_cell(rec)
    assert jroof.what_would_help(got)


def test_analyze_cell_on_a_port_record(tmp_path):
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", "1x1",
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok" and rec["fits"]
    saved = json.loads((tmp_path / "whisper-tiny__decode_32k__1x1.json")
                       .read_text())
    rec = dict(saved, cost={"flops": 0.0})
    got = roofline.analyze_cell(rec, peak_flops=jroof.PEAK_FLOPS,
                                hbm_bw=jroof.HBM_BW, link_bw=jroof.ICI_BW,
                                model_shard=16)
    assert got == jroof.analyze_cell(rec)
    rows = roofline.load_rows(directory=str(tmp_path))
    assert len(rows) == 1 and rows[0]["collective_s"] == 0.0
    assert rows[0]["mem_gb_per_device"] == pytest.approx(
        saved["memory"]["peak_bytes"] / 1e9)
    assert "| whisper-tiny | decode_32k |" in roofline.markdown_table(rows)
    assert roofline.run(directory=str(tmp_path))[0] == ("roofline.cells",
                                                        0.0, "1")


def test_step_shares():
    cfg = train_config("qwen3-0.6b")
    sh = roofline.step_shares(cfg.model, cfg.shape, 0.25)
    assert sh["mfu"] == pytest.approx(
        6.0 * 596_049_920 * 16 * 256 / (0.25 * roofline.PEAK_FLOPS))
    assert "hbm_share" not in sh
    dec = ShapeConfig("d", 256, 8, "decode")
    sh = roofline.step_shares(cfg.model, dec, 0.01)
    assert 0 < sh["hbm_share"] < 1
    with pytest.raises(ValueError, match="a count is wrong"):
        roofline.step_shares(cfg.model, dec, 1e-6)


# ---------------------------------------------------------------------------
# Full width on meta: no allocation
# ---------------------------------------------------------------------------


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def test_full_width_cells_plan_without_allocating():
    rss = _rss_gb()
    qwen = dryrun.plan_train(train_config("qwen3-0.6b", grad_batch=0))
    rwkv = dryrun.plan_train(train_config("rwkv6-1.6b", grad_batch=0))
    moe = dryrun.run_cell("qwen2-moe-a2.7b", "decode_32k", "8x1",
                          out_dir=None)
    assert _rss_gb() - rss < 1.0
    p = 596_049_920
    assert qwen["params_local"] == p
    assert qwen["memory"]["resident"]["grad_stack"] == 8 * p * 4
    assert qwen["memory"]["argument_bytes"] == 27_418_310_656
    assert qwen["memory"]["peak_bytes"] <= dryrun.CARD_MEMORY_BYTES
    assert rwkv["params_local"] == 1_584_095_232
    assert rwkv["memory"]["peak_bytes"] > dryrun.CARD_MEMORY_BYTES
    assert moe["status"] == "ok" and moe["params"] == 14_315_587_584
    assert moe["memory"]["resident"]["params"] >= 2 * moe["params"]


# ---------------------------------------------------------------------------
# Mesh layouts and the CLI
# ---------------------------------------------------------------------------


def test_mesh_layouts():
    single = layouts.make_production_mesh()
    multi = layouts.make_production_mesh(multi_pod=True)
    assert (single.shape, single.axes, single.data, single.model) == \
        ((16, 16), ("data", "model"), 16, 16)
    assert (multi.shape, multi.axes, multi.devices, multi.data,
            multi.model) == ((2, 16, 16), ("pod", "data", "model"), 512, 32,
                             16)
    assert [m.name for m in layouts.card_meshes()] == [
        "1x1", "2x1", "1x2", "4x1", "2x2", "1x4", "8x1", "4x2", "2x4",
        "1x8"]
    assert layouts.mesh_by_name("2x4") == layouts.make_host_mesh(2, 4)
    with pytest.raises(ValueError):
        layouts.mesh_by_name("pod")
    with pytest.raises(ValueError):
        layouts.make_host_mesh(0, 1)


def test_cli_writes_its_record(tmp_path, capsys):
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                        "--mesh", "1x2", "--out", str(tmp_path)]) == 0
    r = json.loads((tmp_path / "whisper-tiny__decode_32k__1x2.json")
                   .read_text())
    assert r["status"] == "refused"
    assert "[dryrun] done; 0 failures" in capsys.readouterr().out


@pytest.mark.parametrize("flags,name", [
    (["--fsdp", "on"], "--fsdp"), (["--sp", "off"], "--sp"),
    (["--microbatch", "4"], "--microbatch"), (["--no-zero2"], "--no-zero2"),
    (["--moe-mode", "ep"], "--moe-mode ep")])
def test_cli_refuses_the_reference_policies_by_name(flags, name, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all"] + flags)
    assert e.value.code == 2
    assert f"{name} is not ported" in capsys.readouterr().err


def test_rwkv_plan_goes_through_the_kernels_autograd_op():
    """The wkv6 forward and backward twins stand where the kernels launch:
    a planned rwkv6 step calls each once a layer and worker pass."""
    from unittest import mock
    fwd, bwd = dryrun._wkv6_forward_twin, dryrun._wkv6_backward_parts_twin
    with mock.patch.object(dryrun, "_wkv6_forward_twin",
                           wraps=fwd) as f, \
            mock.patch.object(dryrun, "_wkv6_backward_parts_twin",
                              wraps=bwd) as b:
        dryrun.plan_train(_smoke_cfg(1, arch="rwkv6-1.6b"))
    model = configs.get_smoke_config("rwkv6-1.6b")
    passes = 1 if model.remat == "none" else 2      # and its recompute
    # 4 workers one at a time, a forward (and recompute) and a backward
    assert (f.call_count, b.call_count) == (passes * 4 * model.num_layers,
                                            4 * model.num_layers)
