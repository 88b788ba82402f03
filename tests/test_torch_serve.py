"""The port's serve path against the JAX serve engine, and its CLI.

* ``make_trace`` is bit-identical to the reference's (arrivals, lengths,
  prompts), and the page pool's host bookkeeping replays identically.
* Greedy tokens per request of the port's ``ServeEngine`` (device cpu,
  virtual clock) equal the JAX ``ServeEngine``'s on the same smoke params
  and trace, for the fp and int8 pools and the continuous and static
  policies, and so do the scheduler's metrics (decode steps, pages,
  virtual-clock latencies). A variant with sliding windows and a softcap
  decodes past the window.
* The weights are trainable parameters, yet serving runs under
  ``torch.inference_mode``: no activation of a run requires grad.
* The engine's chaos (``faults=``), SLO gate (``slo=``) and metrics
  mirror (``metrics=``) equal the JAX engine's; ``StepSession`` decodes
  the engine's tokens; ``restore_params`` serves a checkpoint in the
  reference's format, params or EMA.
* The CLI runs with ``--device cpu`` and raises without it when there is
  no CUDA; ``--replicas``, ``--restore``, ``--faults``, ``--slo-p99-ms``,
  ``--metrics`` and ``--toy`` run against the JAX CLI, and
  ``--mesh-model 2`` against the one-process CLI.
* ``mesh_model=2`` serves over 2 spawned gloo ranks to the JAX engine's
  tokens (the full TP suite is ``tests/test_torch_serve_tp.py``).
"""
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.serve import PagePool as JPagePool
from repro.serve import PoolConfig as JPoolConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import TraceConfig as JTraceConfig
from repro.serve import make_trace as jmake_trace

from repro.launch import serve as jcli
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import load_jsonl as jload_jsonl
from repro.serve import SLOConfig as JSLOConfig
from repro.train import checkpoint as jckpt

from repro_torch import configs as tconfigs
from repro_torch.distributed import mesh
from repro_torch.launch import serve as tcli
from repro_torch.models import TransformerLM, load_jax_params, to_jax_tree
from repro_torch.obs import MetricsRegistry
from repro_torch.serve import (PagePool, PoolConfig, ServeEngine,
                               SLOConfig, StepSession, TraceConfig,
                               make_trace, restore_params)
from repro_torch.train import checkpoint as tckpt

import torch_serve_tp_ranks as tp_ranks

ARCH = "qwen3-0.6b"
ENGINE_KW = dict(num_slots=3, page_size=4, max_prompt_len=12, max_new_cap=8,
                 clock="virtual")
# wall-clock fields differ by nature; everything else must match
WALL_KEYS = {"wall_time_s", "prefill_s", "decode_s"}

VARIANTS = {
    "qwen3_smoke": {},
    "window_softcap": dict(sliding_window=3, global_every=2,
                           attn_logit_softcap=20.0),
}


def _trace_kw(n, vocab, *, seed=0, rate=4.0, max_prompt=12, max_new=8,
              min_new=2):
    return dict(num_requests=n, rate=rate, prompt_len_min=2,
                prompt_len_max=max_prompt, max_new_min=min_new,
                max_new_max=max_new, vocab=vocab, seed=seed)


def _pair(kw, seed=0):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), **kw)
    params = jget_model(jcfg).init(jax.random.PRNGKey(seed))
    tmodel = load_jax_params(TransformerLM(tcfg, device="cpu"), params)
    return jcfg, params, tcfg, tmodel


@pytest.fixture(scope="module")
def qwen():
    return _pair({})


# ---------------------------------------------------------------------------
# Traces and pages (host numpy: bit for bit)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n,rate", [(0, 16, 8.0), (7, 33, 0.5)])
def test_make_trace_bit_identical(seed, n, rate):
    kw = _trace_kw(n, 151936, seed=seed, rate=rate, max_prompt=512,
                   max_new=128)
    j, t = jmake_trace(JTraceConfig(**kw)), make_trace(TraceConfig(**kw))
    assert [(r.rid, r.arrival, r.max_new) for r in t] == \
        [(r.rid, r.arrival, r.max_new) for r in j]
    for a, b in zip(t, j):
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_page_pool_bookkeeping_replays_reference():
    kw = dict(num_layers=2, kv_heads=2, head_dim=4, num_pages=9, page_size=4,
              num_slots=3, max_pages_per_slot=4, quantized=True)
    jp, tp = JPagePool(JPoolConfig(**kw)), PagePool(PoolConfig(**kw))
    ops = [("alloc", 0, 3), ("alloc", 1, 4), ("free", 0), ("alloc", 2, 2),
           ("try", 0, 4), ("alloc", 0, 1), ("free", 1), ("try", 1, 4)]
    for op in ops:
        for p in (jp, tp):
            if op[0] == "alloc":
                p.alloc(op[1], op[2])
            elif op[0] == "try":
                p.try_alloc(op[1], op[2])
            else:
                p.free_slot(op[1])
            p.note_occupancy()
        np.testing.assert_array_equal(tp.page_table, jp.page_table)
        assert (tp.free_pages, tp.peak_pages, tp.mean_occupancy()) == \
            (jp.free_pages, jp.peak_pages, jp.mean_occupancy())
    assert {k: tuple(v.shape) for k, v in tp.buffers.items()} == \
        {k: tuple(v.shape) for k, v in jp.buffers.items()}
    assert tp.buffers["k"].dtype == torch.int8
    assert tp.buffers["k_scale"].dtype == torch.float16
    with pytest.raises(ValueError):
        tp.alloc(2, 1)                      # slot already holds pages


# ---------------------------------------------------------------------------
# Engine token parity with the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(qwen):
    jcfg, params, tcfg, tmodel = qwen
    out = {}
    for int8 in (False, True):
        out[int8] = (JServeEngine(jcfg, params, cache_int8=int8, **ENGINE_KW),
                     ServeEngine(tcfg, tmodel, cache_int8=int8, device="cpu",
                                 **ENGINE_KW))
    return out


def _assert_same_run(jeng, teng, trace_kw, policy):
    jrep = jeng.run(jmake_trace(JTraceConfig(**trace_kw)), policy=policy)
    trep = teng.run(make_trace(TraceConfig(**trace_kw)), policy=policy)
    assert trep.metrics["completed"] + trep.metrics["rejected"] == \
        trace_kw["num_requests"]
    assert trep.tokens_by_rid() == jrep.tokens_by_rid()
    assert trep.rejected == jrep.rejected
    jm = {k: v for k, v in jrep.metrics.items() if k not in WALL_KEYS}
    tm = {k: v for k, v in trep.metrics.items() if k not in WALL_KEYS}
    assert tm == jm
    assert set(trep.metrics) == set(jrep.metrics)
    return trep


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_tokens_match_jax(engines, qwen, int8, policy):
    jeng, teng = engines[int8]
    kw = _trace_kw(7, qwen[2].vocab_size, seed=1, rate=100.0)
    rep = _assert_same_run(jeng, teng, kw, policy)
    assert rep.metrics["prefill_compiles"] >= 1
    assert rep.metrics["decode_compiles"] == 1


def test_engine_window_softcap_matches_jax():
    """Decode well past a 3-token window on alternating local/global
    layers, with a logit softcap: paged masking matches the reference."""
    jcfg, params, tcfg, tmodel = _pair(VARIANTS["window_softcap"], seed=2)
    kw = dict(num_slots=2, page_size=4, max_prompt_len=8, max_new_cap=12,
              clock="virtual")
    _assert_same_run(JServeEngine(jcfg, params, **kw),
                     ServeEngine(tcfg, tmodel, device="cpu", **kw),
                     _trace_kw(3, tcfg.vocab_size, max_prompt=6, max_new=12,
                               min_new=12), "continuous")


def test_engine_rejections_match_jax(qwen):
    """Undersized pool + bounded queue: the same structured rejections."""
    jcfg, params, tcfg, tmodel = qwen
    kw = dict(ENGINE_KW, num_pages=4, strict_capacity=False, max_queue=2)
    trep = _assert_same_run(JServeEngine(jcfg, params, **kw),
                            ServeEngine(tcfg, tmodel, device="cpu", **kw),
                            _trace_kw(8, tcfg.vocab_size, seed=3,
                                      rate=1000.0), "continuous")
    assert trep.rejected


def test_prefill_buckets_counted_once(qwen):
    _, _, tcfg, tmodel = qwen
    eng = ServeEngine(tcfg, tmodel, device="cpu", num_slots=2, page_size=8,
                      max_prompt_len=16, max_new_cap=4, clock="virtual")
    assert (eng.prefill_compiles, eng.decode_compiles) == (0, 0)
    from repro_torch.serve import Request
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i, arrival=0.0, max_new=3,
                    prompt=rng.randint(0, 512, size=n).astype(np.int32))
            for i, n in enumerate([3, 5, 8, 9, 12, 16])]   # buckets {8, 16}
    for _ in range(2):
        eng.run(reqs)
        assert (eng.prefill_compiles, eng.decode_compiles) == (2, 1)


def test_serving_records_no_autograd_graph(qwen, monkeypatch):
    _, _, tcfg, tmodel = qwen
    assert all(p.requires_grad for p in tmodel.parameters())
    seen = []
    embed = TransformerLM._embed_inputs

    def spy(self, tokens):
        x = embed(self, tokens)
        seen.append((torch.is_inference_mode_enabled(), x.requires_grad,
                     x.grad_fn))
        return x

    monkeypatch.setattr(TransformerLM, "_embed_inputs", spy)
    eng = ServeEngine(tcfg, tmodel, device="cpu", **ENGINE_KW)
    rep = eng.run(make_trace(TraceConfig(**_trace_kw(4, tcfg.vocab_size))))
    assert rep.metrics["completed"] == 4 and len(seen) > 4
    assert all(s == (True, False, None) for s in seen)


def test_engine_validation(qwen):
    _, _, tcfg, tmodel = qwen
    eng = ServeEngine(tcfg, tmodel, device="cpu", **ENGINE_KW)
    from repro_torch.serve import Request
    with pytest.raises(ValueError, match="prompt_len"):
        eng.run([Request(0, 0.0, np.zeros(99, np.int32), 2)])
    with pytest.raises(ValueError, match="max_new"):
        eng.run([Request(0, 0.0, np.zeros(4, np.int32), 999)])
    with pytest.raises(ValueError, match="policy"):
        eng.run([], policy="adaptive")
    other = dataclasses.replace(tcfg, d_ff=64)
    with pytest.raises(ValueError, match="another config"):
        ServeEngine(other, tmodel, device="cpu", **ENGINE_KW)


@pytest.mark.parametrize("kw", [
    pytest.param(dict(mesh_model=2), id="kw0-Queue 1 item 8"),
    pytest.param(dict(faults="slowdown@1:x3:d2,preempt@3"), id="kw1-fault"),
    pytest.param(dict(slo="shed"), id="kw2-resilience"),
    pytest.param(dict(metrics=True), id="kw3-telemetry")])
def test_unported_engine_options_raise(qwen, kw, tmp_path):
    """The options that later slices brought run and equal the JAX
    engine's on the same trace: tensor-parallel decode (``mesh_model=2``
    over 2 spawned gloo ranks, ``tests/torch_serve_tp_ranks.py``: both
    ranks' tokens), chaos (a slowdown and a preemption: events, tokens and
    virtual-clock metrics), the SLO gate (the same sheds and trips) and
    the metrics registry (the same summary on the virtual clock, the
    wall-clock histograms by count)."""
    jcfg, params, tcfg, tmodel = qwen
    if "mesh_model" in kw:
        tkw = _trace_kw(9, tcfg.vocab_size, seed=4, rate=100.0)
        want = JServeEngine(jcfg, params, **ENGINE_KW).run(
            jmake_trace(JTraceConfig(**tkw))).tokens_by_rid()
        np_params = jax.tree_util.tree_map(np.asarray, params)
        mesh.spawn(tp_ranks.serve_rank, 1, "cpu",
                   args=(str(tmp_path), {"tp": (
                       ARCH, np_params, False,
                       make_trace(TraceConfig(**tkw)))}),
                   mesh_model=2, threads=1, timeout_s=120.0)
        for r in range(2):
            got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            assert got["tp"]["tokens"] == want and len(want) == 9
            assert got["tp"]["plan"].attn and got["tp"]["all_reduces"] > 0
        return
    regs = {}
    if kw.get("slo"):
        kw = dict(slo=None, _slo=True)
    if kw.get("metrics"):
        regs = {"jax": JMetricsRegistry(), "torch": MetricsRegistry()}
    jkw, tkw = dict(ENGINE_KW), dict(ENGINE_KW, device="cpu")
    if "faults" in kw:
        jkw["faults"] = tkw["faults"] = kw["faults"]
    if "_slo" in kw:
        jkw["slo"] = JSLOConfig(target_p99=4.0, window=8, min_samples=2,
                                probe_every=2)
        tkw["slo"] = SLOConfig(target_p99=4.0, window=8, min_samples=2,
                               probe_every=2)
    if regs:
        jkw["metrics"], tkw["metrics"] = regs["jax"], regs["torch"]
    # the SLO case spreads its arrivals, so some come after the trip
    trep = _assert_same_run(JServeEngine(jcfg, params, **jkw),
                            ServeEngine(tcfg, tmodel, **tkw),
                            _trace_kw(12 if "_slo" in kw else 9,
                                      tcfg.vocab_size, seed=4,
                                      rate=1.0 if "_slo" in kw else 100.0),
                            "continuous")
    if "faults" in kw:
        assert {e["event"] for e in trep.events} == {"slowdown", "preempt"}
        assert trep.metrics["preemptions"] == 1
    if "_slo" in kw:
        assert trep.metrics["slo_trips"] >= 1
        assert trep.metrics["rejected_slo_shed"] >= 1
    if regs:
        jsum, tsum = (r.summary() for r in (regs["jax"], regs["torch"]))
        wall = {"serve/prefill_s", "serve/decode_s", "serve/wall_time_s"}
        assert set(tsum) == set(jsum)
        assert {k: v for k, v in tsum.items() if k not in wall} == \
            {k: v for k, v in jsum.items() if k not in wall}
        for k in wall - {"serve/wall_time_s"}:
            assert tsum[k]["count"] == jsum[k]["count"] > 0


def test_unported_surfaces_raise(qwen, tmp_path):
    """The surfaces that used to be refused run: ``StepSession`` admits and
    ticks to the engine's greedy tokens, and ``restore_params`` serves a
    checkpoint in the reference's format (the raw parameters, then the
    EMA subtree cast to their dtype); a missing one raises
    ``FileNotFoundError`` as in the reference."""
    _, _, tcfg, tmodel = qwen
    eng = ServeEngine(tcfg, tmodel, device="cpu", **ENGINE_KW)
    trace = make_trace(TraceConfig(**_trace_kw(5, tcfg.vocab_size, seed=6)))
    want = eng.run(trace).tokens_by_rid()
    sess = StepSession(eng, name="r0")
    got, queue = {}, list(trace)
    while queue or sess.active:
        while queue and sess.can_admit(queue[0]):
            st = sess.admit(queue.pop(0), 0.0, 0.0)
            if sess.done(st):
                got[st.req.rid] = sess.release(st.req.rid).tokens
        for rid in sess.tick():
            got[rid] = sess.release(rid).tokens
    assert got == want and sess.decode_captures == 0
    named = {k: v.detach() for k, v in tmodel.named_parameters()}
    ema = {k: v.float() * 0.5 for k, v in named.items()}
    tckpt.save(str(tmp_path), 3, {"params": to_jax_tree(named),
                                  "ema": to_jax_tree(ema)}, {})
    for use_ema, src in ((False, named), (True, ema)):
        model, manifest = restore_params(str(tmp_path), tcfg,
                                         use_ema=use_ema, device="cpu")
        assert manifest["step"] == 3
        for k, v in model.named_parameters():
            assert torch.equal(v.detach(), src[k].to(v.dtype)), k
    with pytest.raises(FileNotFoundError):
        restore_params(str(tmp_path / "none"), tcfg, device="cpu")


def test_engine_without_cuda_raises_unless_cpu(qwen, monkeypatch):
    _, _, tcfg, tmodel = qwen
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tcfg, tmodel, **ENGINE_KW)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_runs_on_cpu(capsys, tmp_path):
    path = tmp_path / "trace.json"
    tcli.main(["--device", "cpu", "--requests", "4", "--rate", "100",
               "--cache-int8", "--trace", str(path)])
    out = capsys.readouterr().out
    assert "[serve] qwen3-0.6b policy=continuous slots=4" in out
    assert "4 requests" in out and "compiles prefill=" in out
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"serve/admit", "serve/prefill", "serve/decode"} <= names


def test_cli_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--requests", "2"])


@pytest.mark.parametrize("argv,match", [
    pytest.param(["--toy"], None, id="argv0-toy"),
    pytest.param(["--replicas", "2", "--hedge-after", "3", "--faults",
                  "crash@2:r1,restart@6:r1"], None, id="argv1-router"),
    pytest.param(["--restore", "ck"], None, id="argv2-checkpoint"),
    pytest.param(["--mesh-model", "2"], None, id="argv3-Queue 1 item 8"),
    # every request arrives before the first admission: the chaos events
    # then depend on the decode steps alone, not on how fast each CLI's
    # wall clock admits them
    pytest.param(["--faults", "slowdown@1:x2:d2,preempt@3", "--rate",
                  "1e12"], None, id="argv4-fault"),
    pytest.param(["--slo-p99-ms", "5000"], None, id="argv5-resilience"),
    pytest.param(["--metrics", "m.jsonl"], None, id="argv6-telemetry"),
    (["--ema"], "--restore"),
    (["--timeout", "3"], "--replicas")])
def test_cli_refuses_unported_paths(argv, match, tmp_path, capfd,
                                    monkeypatch):
    """The reference's cross-flag errors hold. The flags that later slices
    brought run through both CLIs (the JAX one on its own init): the
    router's virtual-clock lines equal the JAX CLI's; a checkpoint of the
    reference's format serves the same greedy tokens in both; the chaos
    events, the SLO line and the metrics file read back as the JAX CLI's
    do; ``--toy`` prints the JAX CLI's token rows (the same prompt and
    params handed to both); ``--mesh-model 2`` spawns 2 gloo ranks and
    rank 0 alone prints the one-process CLI's request lines with
    ``tp=2``."""
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            tcli.main(["--device", "cpu"] + argv)
        return
    base = ["--requests", "4", "--rate", "1000", "--max-new", "6"]
    if argv[0] == "--toy":
        toy = argv + ["--batch", "2", "--prompt-len", "3", "--tokens", "4"]
        cfg = tconfigs.get_smoke_config(ARCH)
        prompt = tcli.toy_prompt(0, 2, 3, cfg.vocab_size)
        params = jget_model(jconfigs.get_smoke_config(ARCH)).init(
            jax.random.PRNGKey(0))
        monkeypatch.setattr(jax.random, "randint",
                            lambda *a, **k: jnp.asarray(prompt, jnp.int32))
        jcli.main(toy)
        want = capfd.readouterr().out
        monkeypatch.setattr(tcli, "get_model", lambda c, device, generator:
                            load_jax_params(TransformerLM(c, device=device),
                                            params))
        tcli.main(toy + ["--device", "cpu"])
        got = capfd.readouterr().out
        rows = [re.findall(r"^  (\[.*\])$", o, re.M) for o in (got, want)]
        assert rows[0] == rows[1] and len(rows[0]) == 2
        assert got.split(" prefill ")[0] == want.split(" prefill ")[0]
        return
    if argv[0] == "--mesh-model":
        out = {}
        for tag, extra in (("one", []), ("tp", argv)):
            tcli.main(base + extra + ["--device", "cpu"])
            out[tag] = capfd.readouterr().out
        assert out["tp"].count("[serve] qwen3-0.6b policy=") == 1
        assert " tp=2 " in out["tp"]
        # the wall clock orders the completions: compare per request
        req = {t: dict(re.findall(r"rid=(\d+) (\[.*\])", o))
               for t, o in out.items()}
        assert len(req["tp"]) == 4 and req["tp"] == req["one"]
        return
    if argv[0] == "--restore":
        jcfg = jconfigs.get_smoke_config(ARCH)
        params = jget_model(jcfg).init(jax.random.PRNGKey(5))
        jckpt.save(str(tmp_path / "ck"), 2, {"params": params}, {})
        argv = ["--restore", str(tmp_path / "ck")]
    if argv[0] == "--metrics":
        argv = ["--metrics", str(tmp_path / "m.jsonl")]
    out = {}
    for tag, main in (("jax", jcli.main), ("torch", tcli.main)):
        extra = ["--device", "cpu"] if tag == "torch" else []
        main(base + argv + extra)
        out[tag] = capfd.readouterr().out
        if argv[0] == "--metrics":
            out[tag + "_metrics"] = {
                r["name"]: r.get("count", r.get("value"))
                for r in jload_jsonl(str(tmp_path / "m.jsonl"))}
    lines = {t: o.splitlines() for t, o in out.items() if "_" not in t}
    if argv[0] == "--replicas":
        assert [ln for ln in lines["torch"] if "rid=" not in ln] == \
            [ln for ln in lines["jax"] if "rid=" not in ln]
    elif argv[0] == "--restore":
        assert f"[serve] restored step 2 from {tmp_path / 'ck'}" in \
            lines["torch"][0]
        toks = {t: dict(re.findall(r"rid=(\d+) (\[.*\])", o))
                for t, o in out.items()}
        assert toks["torch"].keys() & toks["jax"].keys()
        for rid in toks["torch"].keys() & toks["jax"].keys():
            assert toks["torch"][rid] == toks["jax"][rid]
    elif argv[0] == "--faults":
        chaos = {t: sorted(ln for ln in ls if "chaos:" in ln)
                 for t, ls in lines.items()}
        assert chaos["torch"] == chaos["jax"] and len(chaos["jax"]) == 2
    elif argv[0] == "--slo-p99-ms":
        assert any(ln.startswith("  slo: shed 0 trips 0")
                   for ln in lines["torch"])
        assert "4 requests" in out["torch"]
    else:
        assert out["torch_metrics"].keys() == out["jax_metrics"].keys()
        for k in ("serve/completed", "serve/tokens", "serve/latency"):
            assert out["torch_metrics"][k] == out["jax_metrics"][k] > 0
