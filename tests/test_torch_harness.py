"""The port's harness benches on the serving side and the host logic
(``repro_torch.benchmarks``: ``check_spmd_regression``, ``bench_router``,
``bench_serve``, ``bench_obs``, ``bench_step_time``, ``common``'s writer)
against the reference's ``benchmarks/`` on the CPU.

The reference benches write ``experiments/bench/BENCH_*.json`` and a root
mirror through ``write_bench``, which each imports from the top-level
module ``common`` (``benchmarks/`` on ``sys.path``), not from
``benchmarks.common``: the name is patched in every reference module these
tests run, and ``benchmarks.common.OUT_DIR`` points at ``tmp_path``. The
last test holds every committed ``BENCH_*.json`` to the hashes it had
before the module ran.

* ``check_spmd_regression``: ``compare``'s records, ``main``'s exit codes
  and its printed report bit-equal to the reference's on hand-written
  payloads (a ratio drop, bytes growth, keys in one payload only, an
  empty baseline, a custom threshold).
* ``bench_router --requests 8``: the payload equals the JAX ``main``'s key
  for key, from the JAX init (``models.load_jax_params``).
* ``bench_serve --quick --requests 8``: the payload's keys and each arm's
  keys equal the reference's; every arm completes every request, the
  occupancy lies in [0, 1], every rate is positive; the ``--full-width``
  flow on the smoke config.
* ``bench_obs``: ``cells[*].train_flops`` bit-equal to the reference's
  ``cell_flops``; the hooks a chunk opens counted from the trace.
* ``bench_step_time`` on internvl2-2b (the vlm prefix) and whisper-tiny
  (the encoder frames): the rows named as the reference's, and the first
  step's loss from the JAX init and batch within ``STEP_LOSS_RTOL`` of
  JAX's.
* ``--out`` writes the payload with its provenance; without it a main
  writes nothing.

Wall-clock ratios are printed by the benches, never asserted.
"""
import builtins
import hashlib
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from benchmarks import bench_obs as jobs
from benchmarks import bench_router as jrouter
from benchmarks import bench_serve as jserve
from benchmarks import bench_step_time as jstep
from benchmarks import check_spmd_regression as jguard
from benchmarks import common as jcommon
from repro import configs as jconfigs
from repro.analysis.perfmodel import cell_flops as jcell_flops
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import get_model as jget_model
from repro.optim import optimizers as jopt
from repro.optim import schedules as jschedules
from repro.train.train_step import build_train_step as jbuild_train_step

from repro_torch import configs as tconfigs
from repro_torch.benchmarks import bench_obs as tobs
from repro_torch.benchmarks import bench_router as trouter
from repro_torch.benchmarks import bench_serve as tserve
from repro_torch.benchmarks import bench_step_time as tstep
from repro_torch.benchmarks import check_spmd_regression as tguard
from repro_torch.models import get_model as tget_model
from repro_torch.models import load_jax_params
import torch_parity  # noqa: F401  (TF32 off)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the first step's loss of a smoke train step, port from the JAX init and
# batch against JAX (f32 on both sides: summation order alone)
STEP_LOSS_RTOL = 2e-4
STEP_ARCHS = ("internvl2-2b", "whisper-tiny")


def _committed_bench_files():
    out = []
    for d in (ROOT, os.path.join(ROOT, "experiments", "bench")):
        out += sorted(os.path.join(d, n) for n in os.listdir(d)
                      if n.startswith("BENCH_") and n.endswith(".json"))
    return out


def _hashes():
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in _committed_bench_files()}


_BEFORE = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel tier-1 run; the
    committed BENCH files' hashes taken before any test here runs."""
    _BEFORE.update(_hashes())
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reference_writes_nowhere(tmp_path, monkeypatch):
    """The reference benches' ``write_bench`` captures its payload; their
    ``save_json`` writes under ``tmp_path``."""
    written = {}

    def capture(name, payload, mirror=None):
        written[name] = payload
        return str(tmp_path / f"{name}.json")

    for mod in (jrouter, jserve, jobs):
        monkeypatch.setattr(mod, "write_bench", capture)
    monkeypatch.setattr(jcommon, "OUT_DIR", str(tmp_path))
    return written


# ---------------------------------------------------------------------------
# check_spmd_regression: bit-equal records, exit codes and report
# ---------------------------------------------------------------------------

_BASE = {"bench": "spmd",
         "spmd_vs_sim_w4_chunk1_m1": 0.60,
         "spmd_vs_sim_w8_chunk32_m2": 0.50,
         "spmd_bytes_per_step_w4_chunk1_m1": 49672.0,
         "spmd_bytes_per_step_w8_chunk32_m2": 50184.0,
         "steps": 96}

GUARD_CASES = {
    "steady": (_BASE, dict(_BASE), ()),
    "ratio_drop": (_BASE, dict(_BASE, spmd_vs_sim_w4_chunk1_m1=0.45), ()),
    "small_drift": (_BASE, dict(_BASE, spmd_vs_sim_w4_chunk1_m1=0.55,
                                spmd_bytes_per_step_w4_chunk1_m1=55000.0),
                    ()),
    "bytes_growth": (_BASE, dict(_BASE,
                                 spmd_bytes_per_step_w8_chunk32_m2=70000.0),
                     ()),
    "improvement": (_BASE, dict(_BASE, spmd_vs_sim_w8_chunk32_m2=0.9,
                                spmd_bytes_per_step_w4_chunk1_m1=1000.0),
                    ()),
    "only_in_baseline": (_BASE, {k: v for k, v in _BASE.items()
                                 if k != "spmd_vs_sim_w4_chunk1_m1"}, ()),
    "only_in_fresh": (_BASE, dict(_BASE, spmd_vs_sim_w16_chunk64_m4=0.1),
                      ()),
    "empty_baseline": ({"bench": "spmd"}, dict(_BASE), ()),
    "zero_baseline": (dict(_BASE, spmd_vs_sim_w4_chunk1_m1=0.0),
                      dict(_BASE), ()),
    "tight_threshold": (_BASE, dict(_BASE, spmd_vs_sim_w4_chunk1_m1=0.55),
                        ("--threshold", "0.05")),
}


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_regression_guard_equals_reference(case, tmp_path, capsys):
    base, fresh, extra = GUARD_CASES[case]
    b, f = tmp_path / "base.json", tmp_path / "fresh.json"
    b.write_text(json.dumps(base))
    f.write_text(json.dumps(fresh))
    assert tguard.compare(base, fresh, 0.2) == jguard.compare(base, fresh,
                                                              0.2)
    rc_ref = jguard.main([str(b), str(f), *extra])
    out_ref = capsys.readouterr().out
    rc = tguard.main([str(b), str(f), *extra])
    assert (rc, capsys.readouterr().out) == (rc_ref, out_ref)
    assert rc == (1 if case in ("ratio_drop", "bytes_growth",
                                "tight_threshold") else 0)


# ---------------------------------------------------------------------------
# bench_router: the whole payload, from the JAX init
# ---------------------------------------------------------------------------


def _jax_smoke_model(arch="qwen3-0.6b"):
    jcfg = jconfigs.get_smoke_config(arch)
    params = jget_model(jcfg).init(jax.random.PRNGKey(0))
    model = tget_model(tconfigs.get_smoke_config(arch), device="cpu")
    return params, load_jax_params(model, params)


def test_router_payload_equals_reference(_reference_writes_nowhere):
    want = jrouter.main(["--requests", "8"])
    assert _reference_writes_nowhere["BENCH_router"] == want
    _, model = _jax_smoke_model()
    got = trouter.main(["--device", "cpu", "--requests", "8"], model=model)
    assert got == want
    assert got["chaos_lost_requests"] == 0 and got["replay_identical"] \
        and got["token_parity"]


_ROWS_PAYLOADS = {
    "router": {"hedged_vs_unhedged_p99": 2.0, "chaos_lost_requests": 0,
               "goodput_shed": 0.5},
    "serve": {"tokens_per_s_peak": 120.5, "p99_latency_s_peak": 0.25,
              "continuous_vs_static_tokens_per_s": 3.0},
    "recovery": {"mttr_s": 0.5, "chaos_overhead_x": 1.5,
                 "loss_delta": -0.01},
    "obs": {"tracer_overhead_pct": 0.01, "traced_overhead_pct": 2.0,
            "predicted_vs_measured_err": 0.1,
            "cells": [{"seq_len": 32, "global_batch": 16,
                       "measured_step_s": 0.01, "rel_err": 0.0}]},
    "event_loop": {"results": [{"strategy": "async", "chunk_size": 1,
                                "updates_per_s": 50.0}],
                   "speedup_32_vs_1": 4.0},
}


@pytest.mark.parametrize("bench", list(_ROWS_PAYLOADS))
def test_run_rows_equal_the_reference(bench, monkeypatch):
    """``run``'s rows from one payload, each package's ``main`` stubbed."""
    import importlib
    ref = importlib.import_module(f"benchmarks.bench_{bench}")
    port = importlib.import_module(f"repro_torch.benchmarks.bench_{bench}")
    payload = _ROWS_PAYLOADS[bench]
    for mod in (ref, port):
        monkeypatch.setattr(mod, "main", lambda *a, **kw: payload)
    assert port.run(True, device="cpu") == ref.run(True)


# ---------------------------------------------------------------------------
# bench_serve: the payload's keys, the arms' invariants
# ---------------------------------------------------------------------------


def _serve_invariants(payload):
    assert payload["decode_compiles"] == 1
    assert payload["prefill_compiles"] >= 1
    assert all(r > 0 for r in payload["loads"])
    for r in payload["results"]:
        assert r["completed"] == payload["requests"], r["policy"]
        assert r["tokens_per_s"] > 0 and r["p99_latency_s"] > 0
        assert 0.0 <= r.get("mean_occupancy", 0.0) <= 1.0
    print("serve continuous vs toy "
          f"{payload['continuous_vs_static_tokens_per_s']:.2f}x, vs the "
          f"engine's static "
          f"{payload['continuous_vs_engine_static_tokens_per_s']:.2f}x")


def test_serve_payload_keys_and_invariants(_reference_writes_nowhere):
    want = jserve.main(["--quick", "--requests", "8"])
    got = tserve.main(["--device", "cpu", "--quick", "--requests", "8"])
    assert sorted(got) == sorted(want)
    assert [sorted(r) for r in got["results"]] == \
        [sorted(r) for r in want["results"]]
    assert [r["policy"] for r in got["results"]] == \
        [r["policy"] for r in want["results"]]
    for k in ("bench", "model", "slots", "page_size", "num_pages",
              "requests", "cache", "decode_compiles"):
        assert got[k] == want[k], k
    _serve_invariants(got)


@pytest.mark.parametrize("quick", [False, True])
def test_serve_full_width_flow_on_the_smoke_config(quick, monkeypatch):
    """``--full-width --cache-int8`` (and its ``--quick`` short trace) with
    the preset's config swapped for the smoke one and its traces cut (the
    flow; the card runs the widths)."""
    monkeypatch.setattr(tserve.configs, "get_config",
                        tconfigs.get_smoke_config)
    monkeypatch.setattr(tserve, "FULL_PROMPT", (4, 24))
    monkeypatch.setattr(tserve, "FULL_NEW", (2, 6))
    monkeypatch.setattr(tserve, "FULL_REQUESTS", 6)
    monkeypatch.setattr(tserve, "FULL_QUICK",
                        dict(prompt=(4, 12), new=(2, 4), requests=4))
    got = tserve.main(["--device", "cpu", "--full-width", "--cache-int8"]
                      + (["--quick"] if quick else []))
    assert (got["model"], got["slots"], got["page_size"], got["cache"],
            got["requests"]) == ("qwen3-0.6b", tserve.FULL_SLOTS,
                                 tserve.FULL_PAGE, "int8", 4 if quick else 6)
    assert max(r["decode_steps"] for r in got["results"]
               if "decode_steps" in r) > 0
    _serve_invariants(got)


# ---------------------------------------------------------------------------
# bench_obs and bench_step_time
# ---------------------------------------------------------------------------


def test_obs_train_flops_bit_equal():
    got = tobs.main(["--device", "cpu", "--quick"])
    model_cfg = jcommon.tiny_lm_config()
    want = [jcell_flops(model_cfg, JShapeConfig("bench_obs", c["seq_len"],
                                                 c["global_batch"],
                                                 "train")).train
            for c in got["cells"]]
    assert [c["train_flops"] for c in got["cells"]] == want
    assert [(c["seq_len"], c["global_batch"]) for c in got["cells"]] == \
        [(32, 16), (64, 16), (32, 32)]
    # train/chunk, train/data_wait, train/device_wait
    assert got["hooks_per_chunk"] == 3
    assert got["tracer_overhead_pct"] >= 0 and all(
        c["measured_step_s"] > 0 for c in got["cells"])
    print(f"obs predicted_vs_measured_err "
          f"{got['predicted_vs_measured_err']:.3f} (CPU)")


def _jax_first_loss(arch, params):
    """The reference ``_bench_arch``'s step and batch: its first step's
    loss, and the batch as numpy."""
    cfg = jconfigs.get_smoke_config(arch)
    opt = jopt.sgd(jschedules.constant(0.01))
    step = jax.jit(jbuild_train_step(jget_model(cfg), opt, num_workers=4,
                                     n_aggregate=3))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    b, s = 8, 32
    batch = {"tokens": jax.random.randint(k1, (b, s), 0, cfg.vocab_size),
             "labels": jax.random.randint(k2, (b, s), 0, cfg.vocab_size)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = jnp.zeros((b, cfg.num_prefix_embeds,
                                            cfg.d_model))
    if cfg.family == "audio":
        batch["encoder_frames"] = jnp.zeros((b, cfg.encoder_seq_len,
                                             cfg.d_model))
    _, _, _, m = step(params, opt.init(params), None,
                      jnp.asarray(0, jnp.int32), batch, jnp.ones((4,), bool))
    return float(m["loss"]), {k: np.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_step_time_first_loss_matches_reference(arch):
    params, model = _jax_smoke_model(arch)
    want, batch = _jax_first_loss(arch, params)
    us, got = tstep._bench_arch(
        arch, 1, torch.device("cpu"), model=model,
        batch={k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    assert us > 0
    assert got == pytest.approx(want, rel=STEP_LOSS_RTOL)


def test_step_time_rows_are_the_reference_names(monkeypatch):
    monkeypatch.setattr(jstep.configs, "list_archs", lambda: list(STEP_ARCHS))
    monkeypatch.setattr(jstep, "_bench_arch", lambda arch, iters: 1.0)
    want = [name for name, _, _ in jstep.run(True)]
    monkeypatch.setattr(tstep.configs, "list_archs", lambda: list(STEP_ARCHS))
    got = tstep.main(["--device", "cpu", "--quick"])
    assert list(got) == want
    assert all(us > 0 for us in got.values())


# ---------------------------------------------------------------------------
# The port's writer: --out and nothing else
# ---------------------------------------------------------------------------


def test_out_writes_the_payload_and_its_provenance(tmp_path):
    path = tmp_path / "sub" / "router.json"
    payload = trouter.main(["--device", "cpu", "--requests", "4",
                            "--out", str(path)])
    got = json.loads(path.read_text())
    prov = got.pop("provenance")
    assert got == json.loads(json.dumps(payload))
    assert set(prov) == {"schema_version", "git_sha", "torch_version",
                         "device", "name", "power.limit"}
    assert (prov["device"], prov["torch_version"], prov["name"]) == \
        ("cpu", torch.__version__, None)


def test_main_writes_nothing_without_out(monkeypatch):
    """Without ``--out`` a main opens no file for writing outside the
    temporary directory (bench_recovery's checkpoints live there)."""
    from repro_torch.benchmarks import bench_recovery
    real_open = builtins.open
    tmp = os.path.realpath(tempfile.gettempdir())
    written = []

    def watching_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+") and not os.path.realpath(
                str(file)).startswith(tmp):
            written.append(str(file))
        return real_open(file, mode, *a, **kw)

    monkeypatch.setattr(builtins, "open", watching_open)
    trouter.main(["--device", "cpu", "--requests", "4"])
    bench_recovery.main(["--device", "cpu", "--steps", "4"])
    assert written == []


def test_committed_bench_files_untouched():
    """Last in the module: every committed BENCH_*.json hashes as it did
    before the module's first test."""
    assert _BEFORE and _hashes() == _BEFORE
