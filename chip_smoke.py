#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) through its own entry points and
fails (non-zero exit, no result line) if any phase fails:

1. Environment: torch / CUDA versions, the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. Build: every kernel source under ``src/repro_torch/kernels/csrc/``,
   one ``nvcc`` each, all at once, into the git-ignored build directory.
3. Kernel parity at the serve path's shapes: each kernel against its
   plain PyTorch version on the same inputs (page gather bf16 and int8 ->
   bf16 bit-exact; flash attention on unit-variance q/k/v, the scale
   qk-norm gives, so scores have std ~1: bf16 at atol 4e-3 / rtol 8e-3,
   one output rounding, and f32 at atol 1e-4, S in {16, 64, 512}, plus a
   window 64 + softcap 2 case where the cap binds), then device times from
   CUDA events (median of repeats, calls queued behind a GPU sleep so host
   overhead is excluded, inputs rotated past the 50 MB L2) of the kernel,
   its plain version and the library yardstick.
4. Serve qwen3-0.6b at full width (28 layers, d_model 1024, bf16, seeded
   random weights) through ``ServeEngine`` on a 16-request trace, once with
   an fp pool and once with an int8 pool. Launch counters are set to 0
   just before each run and read just after; the run must complete every
   request and launch each kernel of its path (page gather twice per layer
   per decode step, flash attention once per layer per admission).
5. End to end, kernel vs plain: a 2-layer full-width f32 model serves one
   short trace with ``use_kernel=True`` and ``use_kernel=False`` (fp and
   int8 pools), and the smoke model serves one on the card and one on the
   CPU; the greedy tokens must be identical.
6. Train qwen3-0.6b at full width (28 layers, bf16, remat full, tied
   151,936-vocab head) through ``run_experiment``: backup 6 + 2 workers,
   batch 2 per worker, seq 256, rmsprop_momentum, EMA 0.999, the spmd
   backend at mesh 1 x 1, 3 steps. The backup_reduce counter is set to 0
   just before and read just after: one launch per step. The same 3 steps
   again with ``use_kernel=False``: the same masks and sim_time, losses
   within rel 1e-3, and the first step's aggregated gradient bit-equal.
   Then backup_reduce against its plain version, bit-exact, at the run's
   [8, P] stack (P = 596,049,920 parameters) and at edge shapes W in
   {2, 3, 8}, P in {1, 3, 4097, 65536}, all-zero / all-one / mixed masks,
   aligned and unaligned bases, and its device times as in phase 3.
7. At reduced depth (2 layers, full width, f32): the sim and the spmd
   backends give the same parameters (atol 1e-5), and a checkpoint saved
   at step 1, restored and continued for 2 steps equals 3 steps run
   straight through.
8. A JSON line of per-kernel numbers (``launches`` is the count of one
   run of the path that launches the kernel, named by ``launches_run``),
   then, as the last line, ``{"ok": true, "device": {...}}``.

Needs one card; exits non-zero when ``torch.cuda.is_available()`` is false.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
GATHER_SHAPE = dict(b=8, ps=16, kv=8, hd=128)
FLASH_HEADS = dict(h=16, kv=8, d=128)
REDUCE_WORKERS = 8                 # backup 6 + 2
REDUCE_EDGES = dict(w=(2, 3, 8), p=(1, 3, 4097, 65536),
                    masks=("zeros", "ones", "mixed"))


def _log(msg: str) -> None:
    print(msg, flush=True)


def _time_ms(torch, fns, repeats: int = 7, iters: int = 10) -> float:
    """Device ms of one call: median over repeats of the CUDA-event time of
    ``iters`` calls / ``iters``. ``fns`` is a list of calls cycled through
    (distinct inputs, so repeated calls do not hit in L2). The calls are
    queued behind a GPU sleep, so they run back to back on the device and
    the host's Python/launch time per call is not counted; a repeat in
    which the sleep ran out before the host had queued everything is
    redone with a longer sleep."""
    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()
    times, cycles = [], 1 << 23
    while len(times) < repeats:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for i in range(iters):
            fns[i % len(fns)]()
        end.record()
        ran_dry = start.query()
        torch.cuda.synchronize()
        if ran_dry:
            if cycles > 1 << 32:
                raise RuntimeError("timing: the host cannot queue the calls "
                                   "ahead of the device")
            cycles *= 2
            continue
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: kernels at the serve path's shapes
# ---------------------------------------------------------------------------


def _gather_phase(torch, page_gather, maxp: int, num_pages: int,
                  layers: int):
    """Parity and timings of both gather variants; returns their rows."""
    g = GATHER_SHAPE
    b, ps, kv, hd = g["b"], g["ps"], g["kv"], g["hd"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # the decode path's table: every slot full, distinct live pages
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)[:b * maxp]
    table = (perm + 1).to(torch.int32).reshape(b, maxp).contiguous()
    pool = torch.randn((layers, num_pages, ps, kv, hd), generator=gen,
                       device=dev).to(torch.bfloat16)
    q8 = torch.randint(-127, 128, (layers, num_pages, ps, kv, hd),
                       generator=gen, device=dev, dtype=torch.int8)
    scales = (torch.rand((layers, num_pages, ps, kv), generator=gen,
                         device=dev) * 0.05).to(torch.float16)
    rows = []
    unique = int(torch.unique(table).numel())
    out_elems = b * maxp * ps * kv * hd
    for name, args, in_bytes in (
            ("page_gather", lambda l: (pool[l], table, None),
             unique * ps * kv * hd * 2),
            ("page_gather_dequant", lambda l: (q8[l], table, scales[l]),
             unique * ps * kv * (hd * 1 + 2))):
        got = page_gather.gather_pages(*args(0), out_dtype=torch.bfloat16)
        want = page_gather.gather_pages(*args(0), out_dtype=torch.bfloat16,
                                        use_kernel=False)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from plain "
                                 f"(max abs err {err})")
        ms = _time_ms(torch, [
            (lambda l=l: page_gather.gather_pages(
                *args(l), out_dtype=torch.bfloat16)) for l in range(layers)])
        plain_ms = _time_ms(torch, [
            (lambda l=l: page_gather.gather_pages(
                *args(l), out_dtype=torch.bfloat16, use_kernel=False))
            for l in range(layers)])
        library_ms = None
        if name == "page_gather":          # one PyTorch call: pool[table]
            library_ms = _time_ms(torch, [
                (lambda l=l: pool[l][table]) for l in range(layers)])
        nbytes = in_bytes + table.numel() * 4 + out_elems * 2   # bf16 out
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/page_gather.cu",
            replaces="src/repro/kernels/page_gather.py:83",
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=library_ms))
        _log(f"[kernels] {name} B={b} maxp={maxp} ps={ps} kv={kv} hd={hd}: "
             f"bit-exact vs plain; kernel {ms:.4f} ms, plain "
             f"{plain_ms:.4f} ms, library "
             f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}, "
             f"bound {rows[-1]['bound_ms']:.4f} ms ({nbytes} bytes)")
    return rows


def _flash_inputs(torch, s, dtype, copies, gen):
    """Unit-variance q/k/v, the scale qk-norm gives q and k: scores
    q.k/sqrt(D) then have std ~1, so the softmax is far from uniform."""
    f = FLASH_HEADS
    return [tuple(torch.randn((1, s, n, f["d"]), generator=gen,
                              device="cuda").to(dtype)
                  for n in (f["h"], f["kv"], f["kv"]))
            for _ in range(copies)]


def _flash_phase(torch, flash_attention):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(s, dt, 0, 0.0) for s in (16, 64, 512)
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(512, dt, 64, 2.0) for dt in (torch.bfloat16, torch.float32)]
    errs = {}
    for s, dt, window, cap in cases:
        q, k, v = _flash_inputs(torch, s, dt, 1, gen)[0]
        got = flash_attention.flash_attention(q, k, v, window=window,
                                              softcap=cap)
        want = flash_attention.flash_attention(q, k, v, window=window,
                                               softcap=cap, use_kernel=False)
        torch.cuda.synchronize()
        # bf16: the kernel and the plain version both compute in f32 and
        # round once to bf16, so they may differ by one bf16 ulp (< 2^-7
        # relative); f32: summation order only
        tol = dict(atol=4e-3, rtol=8e-3) if dt == torch.bfloat16 else \
            dict(atol=1e-4, rtol=0.0)
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        errs[(s, dt, window)] = err
        _log(f"[kernels] flash_attention S={s} {str(dt)[6:]} window={window} "
             f"softcap={cap}: max abs err {err:.3g} vs plain "
             f"(atol {tol['atol']}, rtol {tol['rtol']})")
    # timings at the largest prefill bucket, in the serve run's dtype
    s, dt = 512, torch.bfloat16
    ins = _flash_inputs(torch, s, dt, 16, gen)
    ms = _time_ms(torch, [(lambda a=a: flash_attention.flash_attention(*a))
                          for a in ins])
    plain_ms = _time_ms(torch, [
        (lambda a=a: flash_attention.flash_attention(*a, use_kernel=False))
        for a in ins])
    library_ms = _time_ms(torch, [
        (lambda a=a: F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in a), is_causal=True,
            enable_gqa=True)) for a in ins])
    f = FLASH_HEADS
    pairs = s * (s + 1) // 2                       # causal, window 0
    flops = 4 * pairs * f["d"] * f["h"]
    nbytes = 2 * s * f["d"] * (2 * f["h"] + 2 * f["kv"])   # q, o, k, v
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:95",
        max_abs_err=errs[(s, dt, 0)], ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms)
    _log(f"[kernels] flash_attention B=1 S={s} H={f['h']} KV={f['kv']} "
         f"D={f['d']} bf16 causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
         f"ms, library (sdpa) {library_ms:.4f} ms, bound "
         f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {flops} flop, "
         f"{nbytes} bytes)")
    return row


def _reduce_mask(torch, w, kind):
    vals = {"zeros": [0.0] * w, "ones": [1.0] * w,
            "mixed": [float(i % 4 != 3) for i in range(w)]}[kind]
    return torch.tensor(vals, device="cuda")


def _reduce_phase(torch, backup_reduce, p_full: int):
    """backup_reduce: bit-exact vs plain at the training stack and at the
    edge shapes; device times at the training stack."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n_edge = 0
    for w in REDUCE_EDGES["w"]:
        for p in REDUCE_EDGES["p"]:
            g = torch.randn((w, p + 1), generator=gen, device="cuda")
            for kind in REDUCE_EDGES["masks"]:
                m = _reduce_mask(torch, w, kind)
                # the aligned stack, then the same lanes 4 bytes off
                for view in (g[:, :p].contiguous(), g[:, 1:]):
                    got = backup_reduce.backup_reduce(view, m, 6)
                    want = backup_reduce.backup_reduce_plain(view, m, 6)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"backup_reduce W={w} P={p} mask={kind}: kernel "
                            f"differs from plain (max abs err "
                            f"{(got - want).abs().max().item()})")
                    n_edge += 1
    _log(f"[kernels] backup_reduce edge shapes: {n_edge} cases (W "
         f"{REDUCE_EDGES['w']}, P {REDUCE_EDGES['p']}, masks "
         f"{REDUCE_EDGES['masks']}, aligned and 4-byte-offset bases) "
         f"bit-exact vs plain")
    w = REDUCE_WORKERS
    g = torch.randn((w, p_full), generator=gen, device="cuda")
    m = _reduce_mask(torch, w, "mixed")
    n_agg = int(m.sum().item())
    got = backup_reduce.backup_reduce(g, m, n_agg)
    want = backup_reduce.backup_reduce_plain(g, m, n_agg)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"backup_reduce W={w} P={p_full}: kernel "
                             f"differs from plain (max abs err {err})")
    vec4 = backup_reduce.uses_vec4(g, got)
    del got, want
    inv_n = backup_reduce.inv_n_f32(n_agg)
    ms = _time_ms(torch, [lambda: backup_reduce.backup_reduce(g, m, n_agg)])
    plain_ms = _time_ms(torch, [
        lambda: backup_reduce.backup_reduce_plain(g, m, n_agg)], repeats=3,
        iters=3)
    library_ms = _time_ms(torch, [lambda: torch.matmul(m[None], g) * inv_n])
    nbytes = 4 * w * p_full + 4 * p_full + 4 * w
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * w * p_full / PEAK_FLOPS["float32"] * 1e3
    row = dict(
        name="backup_reduce", route="cuda",
        source="src/repro_torch/kernels/csrc/backup_reduce.cu",
        replaces="src/repro/kernels/backup_reduce.py:44",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms)
    _log(f"[kernels] backup_reduce W={w} P={p_full} f32 ({n_agg} of {w} "
         f"selected, {'float4' if vec4 else 'scalar'} path): bit-exact vs "
         f"plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
         f"(matmul, cuBLAS) {library_ms:.4f} ms, bound {row['bound_ms']:.4f} "
         f"ms ({nbytes} bytes)")
    del g
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phases 4 and 5: serving
# ---------------------------------------------------------------------------


def _serve(torch, engine, trace, counters):
    for c in counters:
        c.launches = 0
    report = engine.run(trace)
    torch.cuda.synchronize()
    return report, [c.launches for c in counters]


def _serve_phase(torch, kernels):
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine, TraceConfig, make_trace
    page_gather, flash_attention = kernels
    cfg = configs.get_config("qwen3-0.6b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    _log(f"[serve] qwen3-0.6b full width: {cfg.num_layers} layers, "
         f"d_model {cfg.d_model}, {n_params} params in {cfg.dtype}, init "
         f"{time.perf_counter() - t0:.2f} s")
    trace = make_trace(TraceConfig(
        num_requests=16, rate=1000.0, prompt_len_min=64, prompt_len_max=512,
        max_new_min=32, max_new_max=128, vocab=cfg.vocab_size, seed=0))
    warm = make_trace(TraceConfig(
        num_requests=2, rate=1000.0, prompt_len_min=64, prompt_len_max=512,
        max_new_min=4, max_new_max=4, vocab=cfg.vocab_size, seed=1))
    runs = {}
    for int8 in (False, True):
        engine = ServeEngine(cfg, model, num_slots=8, page_size=16,
                             max_prompt_len=512, max_new_cap=128,
                             cache_int8=int8, clock="wall")
        engine.run(warm)
        torch.cuda.reset_peak_memory_stats()
        report, (n_gather, n_flash) = _serve(
            torch, engine, trace, (page_gather, flash_attention))
        m = report.metrics
        tag = "int8" if int8 else "fp"
        if m["completed"] != len(trace):
            raise AssertionError(f"[serve {tag}] {m['completed']} of "
                                 f"{len(trace)} requests completed")
        for c in report.completed:
            req = next(r for r in trace if r.rid == c.rid)
            if len(c.tokens) != req.max_new or not all(
                    0 <= t < cfg.vocab_size for t in c.tokens):
                raise AssertionError(f"[serve {tag}] rid {c.rid}: bad tokens")
        want_gather = 2 * cfg.num_layers * m["decode_steps"]
        want_flash = cfg.num_layers * len(trace)
        if n_gather != want_gather or n_flash != want_flash:
            raise AssertionError(
                f"[serve {tag}] launches gather={n_gather} (expected "
                f"{want_gather}) flash={n_flash} (expected {want_flash})")
        runs[tag] = dict(report=report, gather=n_gather, flash=n_flash)
        _log(f"[serve {tag}] {m['completed']} requests, {m['total_tokens']} "
             f"tokens in {m['duration']:.3f} s -> {m['tokens_per_s']:.1f} "
             f"tok/s | latency p50 {m['p50_latency']:.4f} s p99 "
             f"{m['p99_latency']:.4f} s | ttft p50 {m['p50_ttft']:.4f} s | "
             f"prefill_s {m['prefill_s']:.4f} decode_s {m['decode_s']:.4f} | "
             f"{m['decode_steps']} decode steps, mean "
             f"{1e3 * m['decode_s'] / m['decode_steps']:.3f} ms/step | peak "
             f"pages {m['peak_pages']} of {engine.pool_cfg.num_pages - 1} | "
             f"pool {engine.pool_bytes} bytes | peak device memory "
             f"{torch.cuda.max_memory_allocated()} bytes | launches "
             f"page_gather={n_gather} flash_attention={n_flash}")
    fp_t = runs["fp"]["report"].tokens_by_rid()
    q8_t = runs["int8"]["report"].tokens_by_rid()
    same = sum(a == b for r in fp_t for a, b in zip(fp_t[r], q8_t[r]))
    total = sum(len(v) for v in fp_t.values())
    _log(f"[serve] int8 pool vs fp pool: {same}/{total} tokens equal "
         f"(bf16 random weights; reported, not asserted)")
    return runs


def _kernel_vs_plain_phase(torch):
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine, TraceConfig, make_trace
    full = configs.get_config("qwen3-0.6b")
    cfg = dataclasses.replace(full, num_layers=2, dtype="float32")
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    trace = make_trace(TraceConfig(
        num_requests=8, rate=1000.0, prompt_len_min=16, prompt_len_max=128,
        max_new_min=8, max_new_max=16, vocab=cfg.vocab_size, seed=2))
    for int8 in (False, True):
        toks = [ServeEngine(cfg, model, num_slots=4, page_size=16,
                            max_prompt_len=128, max_new_cap=16,
                            cache_int8=int8, use_kernel=use_kernel,
                            clock="virtual").run(trace).tokens_by_rid()
                for use_kernel in (True, False)]
        if toks[0] != toks[1]:
            raise AssertionError(f"2-layer f32 {'int8' if int8 else 'fp'}: "
                                 f"kernel-path tokens differ from plain")
        _log(f"[e2e] 2-layer full-width f32 {'int8' if int8 else 'fp'} pool: "
             f"kernel-path tokens == plain-path tokens "
             f"({sum(len(t) for t in toks[0].values())} tokens)")
    # the card against the CPU port (itself held to the JAX reference by
    # tests/test_torch_serve.py) on the smoke config
    smoke = configs.get_smoke_config("qwen3-0.6b")
    cpu_model = get_model(smoke, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    gpu_model = get_model(smoke, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    strace = make_trace(TraceConfig(
        num_requests=6, rate=1000.0, prompt_len_min=2, prompt_len_max=32,
        max_new_min=4, max_new_max=16, vocab=smoke.vocab_size, seed=3))
    kw = dict(num_slots=3, page_size=8, max_prompt_len=32, max_new_cap=16,
              clock="virtual")
    on_cpu = ServeEngine(smoke, cpu_model, device="cpu", **kw).run(
        strace).tokens_by_rid()
    on_gpu = ServeEngine(smoke, gpu_model, **kw).run(strace).tokens_by_rid()
    if on_cpu != on_gpu:
        raise AssertionError("smoke model: card tokens differ from CPU tokens")
    _log(f"[e2e] qwen3 smoke f32: card (kernels) tokens == CPU port tokens "
         f"({sum(len(t) for t in on_cpu.values())} tokens)")


# ---------------------------------------------------------------------------
# Phases 6 and 7: training
# ---------------------------------------------------------------------------


def _train_phase(torch, backup_reduce):
    """qwen3-0.6b at full width, 3 spmd steps through the kernel, then the
    same 3 steps through the plain reduce. Returns the kernel run's row
    numbers and its parameter count P."""
    from unittest import mock
    from repro_torch.core.straggler import PaperCalibrated
    from repro_torch.distributed import spmd_engine
    from repro_torch.launch.profile_train import train_config
    from repro_torch.train.loop import run_experiment
    first_grad, tags = {}, []
    reduce = spmd_engine.reduce_then_psum

    def keep_first(*args, **kw):           # each run's first [P] gradient
        red, tail = reduce(*args, **kw)
        if tags[-1] not in first_grad:
            first_grad[tags[-1]] = red.clone()
        return red, tail

    runs = {}
    with mock.patch.object(spmd_engine, "reduce_then_psum", keep_first):
        for tag, use_kernel in (("kernel", None), ("plain", False)):
            tags.append(tag)
            cfg = train_config(use_kernel=use_kernel)
            model = cfg.model
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            backup_reduce.launches = 0
            res = run_experiment(cfg, latency=PaperCalibrated(),
                                 device="cuda")
            torch.cuda.synchronize()
            launches = backup_reduce.launches
            peak = torch.cuda.max_memory_allocated()
            n_params = sum(v.numel() for v in res.params.values())
            for m in res.metrics:
                _log(f"[train {tag}] step {m['step']} loss {m['loss']:.6f} "
                     f"sim_time {m['sim_time']:.6f} selected {m['selected']} "
                     f"lr {m['lr']:.6f}")
            tokens = cfg.shape.global_batch * cfg.shape.seq_len
            ms = [1e3 * t for t in res.step_times_s]
            _log(f"[train {tag}] {model.name}: {model.num_layers} layers, "
                 f"d_model {model.d_model}, vocab {model.vocab_size}, "
                 f"{n_params} params {model.dtype}, remat {model.remat}; "
                 f"backup 6+2, {cfg.shape.global_batch} x "
                 f"{cfg.shape.seq_len} tokens/step, spmd mesh 1x1: ms/step "
                 f"{', '.join(f'{t:.1f}' for t in ms)} (steady "
                 f"{statistics.mean(ms[1:]):.1f} ms, "
                 f"{tokens / statistics.mean(ms[1:]) * 1e3:.0f} tokens/s) | "
                 f"backup_reduce launches {launches} | peak device memory "
                 f"{peak} bytes")
            if not all(math.isfinite(m["loss"]) for m in res.metrics):
                raise AssertionError(f"[train {tag}] non-finite loss")
            if res.steps != 3 or len(res.metrics) != 3:
                raise AssertionError(f"[train {tag}] ran {res.steps} steps")
            want = 3 if use_kernel is None else 0
            if launches != want:
                raise AssertionError(f"[train {tag}] backup_reduce launches "
                                     f"{launches}, expected {want}")
            runs[tag] = dict(metrics=res.metrics, launches=launches,
                             peak=peak, ms=ms, n_params=n_params)
            del res
            torch.cuda.empty_cache()
    for a, b in zip(runs["kernel"]["metrics"], runs["plain"]["metrics"]):
        if a["selected"] != b["selected"] or a["sim_time"] != b["sim_time"]:
            raise AssertionError(f"step {a['step']}: kernel and plain runs "
                                 f"planned different masks")
        if abs(a["loss"] - b["loss"]) > 1e-3 * abs(b["loss"]):
            raise AssertionError(f"step {a['step']}: loss {a['loss']} vs "
                                 f"plain {b['loss']}")
    gk, gp = first_grad["kernel"], first_grad["plain"]
    if not torch.equal(gk, gp):
        raise AssertionError(
            f"first step's aggregated gradient differs between the kernel "
            f"and the plain run (max abs {(gk - gp).abs().max().item()})")
    _log(f"[train] kernel run == plain run: masks and sim_time equal, "
         f"losses within rel 1e-3, first step's aggregated gradient "
         f"({gk.numel()} lanes) bit-equal")
    del gk, gp
    first_grad.clear()
    torch.cuda.empty_cache()
    return runs["kernel"]


def _parity_cfg(backend, *, directory="", every=0):
    """The full-width run cut to 2 layers in f32, seq 64, momentum (as the
    reference's own sim-vs-spmd test: the first RMSProp step divides by
    sqrt(0.1 g^2 + 1e-8), which turns the two backends' different
    summation orders near g = 0 into visible differences)."""
    from repro_torch.configs import CheckpointConfig, OptimizerConfig
    from repro_torch.launch.profile_train import train_config
    cfg = train_config(backend=backend)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_layers=2,
                                       dtype="float32"),
        shape=dataclasses.replace(cfg.shape, seq_len=64),
        optimizer=OptimizerConfig(name="momentum", learning_rate=0.05,
                                  scale_lr_with_workers=False,
                                  ema_decay=0.99),
        checkpoint=CheckpointConfig(directory=directory, every_steps=every))


def _parity_phase(torch):
    """2 layers at full width, f32: sim == spmd, and checkpoint save ->
    restore -> continue == straight through."""
    from repro_torch.train.loop import Trainer
    out = {}
    for backend in ("sim", "spmd"):
        tr = Trainer(_parity_cfg(backend), device="cuda")
        tr.init_state()
        out[backend] = tr.run(3)
    worst = 0.0
    for name, v in out["sim"].params.items():
        worst = max(worst, (v - out["spmd"].params[name]).abs().max().item())
    if worst > 1e-5 or out["sim"].sim_time != out["spmd"].sim_time:
        raise AssertionError(f"sim vs spmd: params differ by {worst}")
    _log(f"[parity] 2-layer full-width f32, 3 steps: sim vs spmd params max "
         f"abs diff {worst:.3g} (atol 1e-5), sim_time equal")
    with tempfile.TemporaryDirectory() as d:
        first = Trainer(_parity_cfg("spmd", directory=d, every=1),
                        device="cuda")
        first.init_state()
        first.run(1)
        resumed = Trainer(_parity_cfg("spmd", directory=d), device="cuda")
        resumed.reset_optimizer_state()
        resumed.restore_checkpoint()
        res = resumed.run(2)
    worst = 0.0
    for part in ("params", "ema"):
        a, b = getattr(res, part), getattr(out["spmd"], part)
        for name, v in a.items():
            worst = max(worst, (v - b[name]).abs().max().item())
    if worst > 1e-6 or res.sim_time != out["spmd"].sim_time:
        raise AssertionError(f"checkpoint resume: state differs by {worst}")
    _log(f"[parity] checkpoint at step 1 -> restore -> 2 more steps vs 3 "
         f"straight: params and EMA max abs diff {worst:.3g} (atol 1e-6), "
         f"sim_time equal")


def main() -> int:
    # cuBLAS picks the same algorithms run to run (the kernel and plain
    # training runs must compute the same first-step gradients)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import (_build, backup_reduce, flash_attention,
                                     page_gather)
    from repro_torch.serve.pages import pages_for
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 is full f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
         f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
         f"x{torch.cuda.device_count()}")
    _log(smi)

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build()
    _log(f"[build] {', '.join(f'{k}.cu {v:.1f} s' for k, v in secs.items())}"
         f" (wall {time.perf_counter() - t0:.1f} s, parallel nvcc, sm_90a)")

    # 3. the serve kernels at the serve path's shapes (its maxp and pool)
    maxp = pages_for(512 + 128, GATHER_SHAPE["ps"])
    rows = _gather_phase(torch, page_gather, maxp,
                         num_pages=GATHER_SHAPE["b"] * maxp + 1, layers=28)
    rows.append(_flash_phase(torch, flash_attention))

    # 4. serve at full width (no autograd graph: inference mode)
    with torch.inference_mode():
        runs = _serve_phase(torch, (page_gather, flash_attention))
    # each row's launches come from one serve run: the gather variants from
    # the run whose pool they read, flash from the fp run (the int8 run's
    # count is printed on its [serve int8] line)
    launch_run = {"page_gather": ("fp", "gather"),
                  "page_gather_dequant": ("int8", "gather"),
                  "flash_attention": ("fp", "flash")}
    for row in rows[:3]:
        run, counter = launch_run[row["name"]]
        row["launches"] = runs[run][counter]
        row["launches_run"] = f"serve {run}"

    # 5. kernel path == plain path, end to end
    with torch.inference_mode():
        _kernel_vs_plain_phase(torch)

    # 6. train at full width through the backup_reduce kernel, then the
    # kernel against its plain version at the run's [W, P] stack
    train = _train_phase(torch, backup_reduce)
    rows.append(_reduce_phase(torch, backup_reduce, train["n_params"]))
    rows[3]["launches"] = train["launches"]
    rows[3]["launches_run"] = "train spmd (3 steps)"

    # 7. reduced depth: sim == spmd, checkpoint resume == straight run
    _parity_phase(torch)

    # 8. results
    keys = ("name", "route", "source", "replaces", "launches", "launches_run",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
