"""Serving launcher CLI: continuous batching over the paged KV cache.
Reference: ``src/repro/launch/serve.py`` (the engine path, one replica).

    # replay a seeded open-loop trace through the serve engine on the card
    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 16 \
        --rate 8 [--policy continuous|static] [--cache-int8] [--device cpu]

Same flags and printed lines as the reference CLI, plus ``--device``
(default ``cuda``; without a card the CLI raises unless ``--device cpu``
is given). It serves the arch's smoke config with seeded random weights,
as the reference does. Flags of paths not ported yet (``--toy``,
``--replicas > 1``, ``--restore``, ``--mesh-model > 1``, ``--faults``,
``--slo-p99-ms``, ``--metrics``) are refused with a message naming the
slice that brings them.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device

# flag -> the port slice that brings it
_LATER = {
    "--toy": "serving resilience (legacy toy path)",
    "--replicas > 1": "serving resilience (replica router)",
    "--restore": "trainer and checkpoint",
    "--mesh-model > 1": "distributed serving (ROADMAP Queue 1 item 8)",
    "--faults": "fault-tolerance",
    "--slo-p99-ms": "serving resilience",
    "--metrics": "telemetry",
}


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=configs.list_archs(),
                    default="qwen3-0.6b")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    ap.add_argument("--cache-int8", action="store_true",
                    help="int8-quantized KV (per-page scale tables)")
    # -- engine path ---------------------------------------------------------
    ap.add_argument("--requests", type=int, default=16,
                    help="trace length (open-loop arrivals)")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="offered load: aggregate arrivals per second")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (power of two)")
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16,
                    help="per-request token budget cap")
    ap.add_argument("--policy", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="TP-shard decode over the mesh 'model' axis "
                    "(not ported yet)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="kept for the reference CLI's sake: the CUDA "
                    "kernels are always used on the card")
    ap.add_argument("--faults", default="",
                    help="chaos spec (not ported yet)")
    # -- replica router -------------------------------------------------------
    ap.add_argument("--replicas", type=int, default=1,
                    help="front N replica sessions with the router "
                    "(not ported yet)")
    ap.add_argument("--hedge-after", type=float, default=None,
                    help="[router] hedge threshold floor")
    ap.add_argument("--timeout", type=float, default=None,
                    help="[router] per-attempt deadline")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="SLO: windowed-p99 latency target (not ported yet)")
    ap.add_argument("--slo-mode", choices=("shed", "queue"), default="shed",
                    help="action while the SLO is violated")
    ap.add_argument("--restore", default="",
                    help="checkpoint dir (not ported yet)")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest good)")
    ap.add_argument("--ema", action="store_true",
                    help="serve the EMA weights from the checkpoint")
    # -- legacy toy path -----------------------------------------------------
    ap.add_argument("--toy", action="store_true",
                    help="legacy static-batch toy path (not ported yet)")
    ap.add_argument("--batch", type=int, default=4, help="[toy] batch size")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="[toy] prompt length")
    ap.add_argument("--tokens", type=int, default=16,
                    help="[toy] tokens to decode")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record prefill/decode/admit spans, exported as "
                    "Chrome-trace JSON (load at ui.perfetto.dev)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the metrics registry as JSONL "
                    "(not ported yet)")
    return ap


def _validate(args) -> None:
    refused = {
        "--toy": args.toy,
        "--replicas > 1": args.replicas > 1,
        "--restore": bool(args.restore),
        "--mesh-model > 1": args.mesh_model > 1,
        "--faults": bool(args.faults),
        "--slo-p99-ms": args.slo_p99_ms is not None,
        "--metrics": args.metrics is not None,
    }
    for flag, used in refused.items():
        if used:
            raise SystemExit(f"{flag} is not ported to repro_torch yet (it "
                             f"comes with the {_LATER[flag]} slice)")
    if args.step is not None or args.ema:
        raise SystemExit("--step/--ema need --restore")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    for flag, val in (("--hedge-after", args.hedge_after),
                      ("--timeout", args.timeout)):
        if val is not None:
            raise SystemExit(f"{flag} needs --replicas > 1 (the router path)")
    if args.trace is not None:
        parent = os.path.dirname(os.path.abspath(args.trace))
        if not os.path.isdir(parent):
            raise SystemExit(f"--trace {args.trace}: directory {parent} "
                             "does not exist")


def main(argv=None) -> None:
    args = _build_parser().parse_args(argv)
    _validate(args)
    device = resolve_device(args.device)
    cfg = configs.get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg, device=device, generator=gen)

    from repro_torch.serve import ServeEngine, TraceConfig, make_trace
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    engine = ServeEngine(
        cfg, model, num_slots=args.slots, page_size=args.page_size,
        max_prompt_len=args.max_prompt, max_new_cap=args.max_new,
        cache_int8=args.cache_int8, device=device, clock="wall",
        tracer=tracer)
    trace = make_trace(TraceConfig(
        num_requests=args.requests, rate=args.rate,
        prompt_len_min=2, prompt_len_max=args.max_prompt,
        max_new_min=2, max_new_max=args.max_new,
        vocab=cfg.vocab_size, seed=args.seed))
    report = engine.run(trace, policy=args.policy)
    m = report.metrics
    print(f"[serve] {args.arch} policy={args.policy} slots={args.slots} "
          f"pages={engine.pool_cfg.num_pages}x{args.page_size}"
          f"{' int8' if args.cache_int8 else ''} device={device}")
    print(f"  {m['completed']} requests, {m['total_tokens']} tokens in "
          f"{m['duration']:.2f}s -> {m['tokens_per_s']:.1f} tok/s")
    print(f"  latency p50 {m['p50_latency']:.3f}s p99 {m['p99_latency']:.3f}s"
          f" | ttft p50 {m['p50_ttft']:.3f}s"
          f" | occupancy {m['mean_occupancy']:.2f}"
          f" | compiles prefill={m['prefill_compiles']} "
          f"decode={m['decode_compiles']}")
    print(f"  wall {m['wall_time_s']:.2f}s (prefill {m['prefill_s']:.2f}s "
          f"decode {m['decode_s']:.2f}s)")
    for ev in report.events:
        print(f"  chaos: {ev}")
    for c in report.completed[:4]:
        print(f"  rid={c.rid} {c.tokens}")
    if tracer is not None:
        tracer.export(args.trace)
        print(f"[serve] trace: {args.trace} ({len(tracer)} events, "
              f"{tracer.dropped} dropped)")


if __name__ == "__main__":
    main()
