"""Serving engine bench: open-loop latency/throughput vs offered load.
Reference: ``benchmarks/bench_serve.py`` (``RHOS``, ``toy_static_run``,
``main``, ``run``: its arms, lines and payload).

Replays a seeded synthetic arrival trace (``serve.trace``) through the
continuous-batching engine at three offered loads — light, near-critical
and saturated — and reports tokens/s, p50/p99 request latency and page-
pool occupancy per load. At the saturated load the same trace is also
served two more ways:

* ``policy="static"`` — the same paged engine, whole-batch-at-a-time
  admission: identical kernels, only the scheduler differs, so the gap is
  pure head-of-line blocking.
* the toy path — token-at-a-time prefill through an eager
  ``decode_step`` a token (the reference's ``jax.jit(model.decode_step)``)
  on one contiguous bucketed cache (``train/serve_step``), fixed
  whole-batch decode budget: the ``continuous_vs_static_tokens_per_s``
  baseline.

Loads are target utilisation ``rho`` converted to arrival rates with the
*measured* decode-step time. The engine's prefill buckets run and its
decode graph's captures stand in the reference's ``prefill_compiles`` /
``decode_compiles``, under its keys. On the card decode is one captured
CUDA graph replayed a step (``page_gather`` twice a layer), every
admission a prefill through ``flash_attention`` a layer.

``--full-width`` is the preset at qwen3-0.6b's published widths (28
layers, d_model 1024, bf16, weights drawn from seed 0): 8 slots,
pages of 16, ``FULL_REQUESTS`` requests with prompts of 16-512 tokens and
2-64 new ones (``--quick``: 16 requests, prompts to 128, up to 32 new);
``--cache-int8`` serves from the int8 pool. Returns the payload; writes
it only to ``--out PATH``.

    python -m repro_torch.benchmarks.bench_serve [--device cpu] [--quick]
    python -m repro_torch.benchmarks.bench_serve --full-width [--quick]
        [--cache-int8]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.benchmarks import common
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.serve import ServeEngine, TraceConfig, make_trace
from repro_torch.train.serve_step import bucketed_max_len, build_decode_step

RHOS = (0.25, 1.0, 4.0)            # light / near-critical / saturated

# the full-width preset: (slots, page size, prompt lengths, new tokens,
# requests); --quick's short trace, as the reference's --quick halves the
# requests and the new tokens, and its prompts to 128 (the toy arm steps
# every prompt token eagerly: ~40 ms a step at full width on an H100)
FULL_ARCH = "qwen3-0.6b"
FULL_SLOTS = 8
FULL_PAGE = 16
FULL_PROMPT = (16, 512)
FULL_NEW = (2, 64)
FULL_REQUESTS = 32
FULL_QUICK = dict(prompt=(16, 128), new=(2, 32), requests=16)


def toy_static_run(model, trace, slots):
    """Replay ``trace`` with the toy discipline the engine replaces.

    Waves of ``slots`` requests: token-at-a-time prefill through an eager
    ``decode_step`` on one contiguous bucketed cache (short prompts
    right-padded to the wave max, as the toy padded its batch), then a
    whole-wave decode budget of max(max_new) steps. Open loop: a wave
    admits only requests that have already arrived. Timing-only baseline;
    each request is credited with the max_new tokens it asked for and
    finishes when its wave drains (the card synchronized)."""
    device = model.device
    step = build_decode_step(model)
    reqs = sorted(trace, key=lambda r: (r.arrival, r.rid))
    cache_len = bucketed_max_len(max(r.prompt_len for r in reqs)
                                 + max(r.max_new for r in reqs) + 1)
    with torch.inference_mode():
        cache = model.init_cache(slots, cache_len)          # warmup
        tok = torch.zeros((slots, 1), dtype=torch.int32, device=device)
        logits, cache = step(tok, cache)
        common.sync(device)

        lat, total_tokens, i = [], 0, 0
        t0 = time.perf_counter()
        while i < len(reqs):
            now = time.perf_counter() - t0
            if reqs[i].arrival > now:
                time.sleep(reqs[i].arrival - now)
                now = reqs[i].arrival
            wave = [r for r in reqs[i:i + slots] if r.arrival <= now]
            wave = wave or [reqs[i]]
            i += len(wave)
            plen = max(r.prompt_len for r in wave)
            prompts = np.zeros((slots, plen), np.int32)
            for j, r in enumerate(wave):
                prompts[j, :r.prompt_len] = r.prompt
            prompts = torch.from_numpy(prompts).to(device)
            cache = model.init_cache(slots, cache_len)
            logits = None
            for t in range(plen):
                logits, cache = step(prompts[:, t:t + 1], cache)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            for _ in range(max(r.max_new for r in wave) - 1):
                logits, cache = step(tok, cache)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            common.sync(device)
            end = time.perf_counter() - t0
            for r in wave:
                lat.append(end - r.arrival)
                total_tokens += r.max_new
    duration = max((time.perf_counter() - t0) - reqs[0].arrival, 1e-9)
    return {
        "policy": "toy", "tokens_per_s": total_tokens / duration,
        "p50_latency_s": float(np.percentile(lat, 50)),
        "p99_latency_s": float(np.percentile(lat, 99)),
        "completed": len(lat),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="short trace (CI canary settings)")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--cache-int8", action="store_true")
    ap.add_argument("--full-width", action="store_true",
                    help=f"{FULL_ARCH} at its published widths (bf16, "
                         f"seeded random weights)")
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.full_width:
        cfg = configs.get_config(FULL_ARCH)
        if args.quick:
            prompt, new, n = (FULL_QUICK[k] for k in ("prompt", "new",
                                                      "requests"))
        else:
            prompt, new, n = FULL_PROMPT, FULL_NEW, FULL_REQUESTS
        requests = args.requests or n
        slots, page, (min_new, max_new) = FULL_SLOTS, FULL_PAGE, new
        (prompt_min, prompt_max), label = prompt, FULL_ARCH
    else:
        cfg = configs.get_smoke_config(FULL_ARCH)
        requests = args.requests or (32 if args.quick else 64)
        slots, page, max_new = 8, 8, 16 if args.quick else 32
        prompt_min, prompt_max = 2, 16
        min_new, label = 2, f"{FULL_ARCH} smoke"
    model = get_model(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0))
    engine = ServeEngine(cfg, model, num_slots=slots, page_size=page,
                         max_prompt_len=prompt_max, max_new_cap=max_new,
                         cache_int8=args.cache_int8, device=device)

    def trace_cfg(rate, seed=0):
        # wide max_new spread: static batching pays E[max]/E[mean] per
        # batch in head-of-line blocking, which is the effect under test
        return TraceConfig(num_requests=requests, rate=rate,
                           prompt_len_min=prompt_min,
                           prompt_len_max=prompt_max,
                           max_new_min=min_new, max_new_max=max_new,
                           vocab=cfg.vocab_size, seed=seed)

    # warm every bucket + the decode step (its graph captured) so no arm
    # pays a first call
    engine.run(make_trace(trace_cfg(1e9, seed=7)))

    # calibrate: decode-step seconds at full slots -> machine-independent
    # arrival rates.  rho = rate * E[service time] / slots
    t0 = time.perf_counter()
    sat = engine.run(make_trace(trace_cfg(1e9, seed=7)))
    t_step = (time.perf_counter() - t0) / max(sat.metrics["decode_steps"], 1)
    mean_new = (min_new + max_new) / 2.0
    crit_rate = slots / (mean_new * t_step)

    results = []
    for rho in RHOS:
        rate = rho * crit_rate
        rep = engine.run(make_trace(trace_cfg(rate)), policy="continuous")
        m = rep.metrics
        results.append({
            "policy": "continuous", "rho": rho, "offered_rate": rate,
            "tokens_per_s": m["tokens_per_s"],
            "p50_latency_s": m["p50_latency"],
            "p99_latency_s": m["p99_latency"],
            "p50_ttft_s": m["p50_ttft"],
            "mean_occupancy": m["mean_occupancy"],
            "completed": m["completed"],
            "decode_steps": m["decode_steps"],
        })
        print(f"continuous rho={rho:<4} rate={rate:7.1f}/s "
              f"tok/s {m['tokens_per_s']:8.1f} p50 {m['p50_latency']:.3f}s "
              f"p99 {m['p99_latency']:.3f}s occ {m['mean_occupancy']:.2f}")
    peak_rate = RHOS[-1] * crit_rate
    rep_static = engine.run(make_trace(trace_cfg(peak_rate)),
                            policy="static")
    ms = rep_static.metrics
    results.append({
        "policy": "static", "rho": RHOS[-1], "offered_rate": peak_rate,
        "tokens_per_s": ms["tokens_per_s"],
        "p50_latency_s": ms["p50_latency"],
        "p99_latency_s": ms["p99_latency"],
        "p50_ttft_s": ms["p50_ttft"],
        "mean_occupancy": ms["mean_occupancy"],
        "completed": ms["completed"],
        "decode_steps": ms["decode_steps"],
    })
    print(f"static     rho={RHOS[-1]:<4} rate={peak_rate:7.1f}/s "
          f"tok/s {ms['tokens_per_s']:8.1f} p50 {ms['p50_latency']:.3f}s "
          f"p99 {ms['p99_latency']:.3f}s occ {ms['mean_occupancy']:.2f}")
    toy = toy_static_run(model, make_trace(trace_cfg(peak_rate)), slots)
    toy["rho"] = RHOS[-1]
    toy["offered_rate"] = peak_rate
    results.append(toy)
    print(f"toy        rho={RHOS[-1]:<4} rate={peak_rate:7.1f}/s "
          f"tok/s {toy['tokens_per_s']:8.1f} p50 {toy['p50_latency_s']:.3f}s "
          f"p99 {toy['p99_latency_s']:.3f}s")

    peak = results[len(RHOS) - 1]
    ratio = peak["tokens_per_s"] / max(toy["tokens_per_s"], 1e-9)
    ratio_engine = peak["tokens_per_s"] / max(ms["tokens_per_s"], 1e-9)
    payload = {
        "bench": "serve",
        "model": label,
        "slots": slots,
        "page_size": engine.pool_cfg.page_size,
        "num_pages": engine.pool_cfg.num_pages,
        "requests": requests,
        "cache": "int8" if args.cache_int8 else cfg.dtype,
        "loads": [r * crit_rate for r in RHOS],
        "results": results,
        "continuous_vs_static_tokens_per_s": ratio,
        "continuous_vs_engine_static_tokens_per_s": ratio_engine,
        "tokens_per_s_peak": peak["tokens_per_s"],
        "p99_latency_s_peak": peak["p99_latency_s"],
        "prefill_compiles": engine.prefill_compiles,
        "decode_compiles": engine.decode_compiles,
    }
    path = common.write_out(args.out, payload, device)
    print(f"continuous vs toy static at peak load: {ratio:.2f}x tokens/s "
          f"(vs engine-static: {ratio_engine:.2f}x)"
          + (f" -> {path}" if path else ""))
    return payload


def run(quick: bool = True, device=None):
    """The harness contract: (name, us_per_call, derived)."""
    payload = main((["--quick"] if quick else [])
                   + (["--device", str(device)] if device else []))
    return [
        ("serve.tokens_per_s_peak", 0.0,
         f"{payload['tokens_per_s_peak']:.1f}tok/s"),
        ("serve.p99_latency_peak",
         payload["p99_latency_s_peak"] * 1e6,
         f"{payload['p99_latency_s_peak']:.3f}s"),
        ("serve.continuous_vs_static", 0.0,
         f"{payload['continuous_vs_static_tokens_per_s']:.2f}x"),
    ]


if __name__ == "__main__":
    main()
