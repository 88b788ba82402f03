"""Serving launcher CLI: continuous batching over the paged KV cache.
Reference: ``src/repro/launch/serve.py`` (the engine path, the replica
router, tensor-parallel serving and the toy path).

    # replay a seeded open-loop trace through the serve engine on the card
    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 16 \
        --rate 8 [--policy continuous|static] [--cache-int8] [--device cpu] \
        [--restore /path/to/ckpt [--step N] [--ema]] [--faults slowdown@4] \
        [--slo-p99-ms 20] [--trace t.json] [--metrics m.jsonl]

    # replica router: hedging, timeouts, SLO admission, replica-scope chaos
    python -m repro_torch.launch.serve --arch qwen3-0.6b --replicas 3 \
        --hedge-after 6 --timeout 40 --slo-p99-ms 20 \
        --faults 'slowdown@0:r0:x8:d32,crash@10:r1,restart@30:r1'

    # tensor-parallel serving over M ranks (spawned, or a torchrun world)
    python -m repro_torch.launch.serve --arch qwen3-0.6b --mesh-model 2

    # toy path (static batch, contiguous cache, greedy_generate)
    python -m repro_torch.launch.serve --arch gemma3-1b --toy --batch 4 \
        --tokens 16 [--cache-int8]

Same flags and printed lines as the reference CLI, plus ``--device``
(default ``cuda``; without a card the CLI raises unless ``--device cpu``
is given). It serves the arch's smoke config, with seeded random weights
or, with ``--restore``, a training checkpoint of either package through
the verified restore bridge (``serve.engine.restore_params``).
``--replicas N`` (N > 1) fronts N replica sessions with the
``serve.ReplicaRouter`` on its virtual clock; ``--faults`` then takes the
replica-scope grammar (``kind@step:rN``). ``--mesh-model M`` (M > 1)
serves tensor-parallel: the CLI spawns M ranks (``distributed.mesh.spawn``,
NCCL with a card each, gloo on the CPU or on a shared card) or joins the
world ``torchrun`` started; every rank builds the same model and runs the
same scheduler on its slice (``serve.ServeEngine``), and rank 0 prints.
``--toy`` runs the static-batch toy path through
``train.serve_step.greedy_generate`` over the model's contiguous cache
(``--cache-int8``: the int8 cache); its prompt is
``numpy.random.default_rng(seed + 1).integers(0, vocab, (batch,
prompt_len))``, and the audio family's encoder frames, which prime the
cross cache, are ``0.1 * toy_frames(batch, encoder_seq_len, d_model)``.
The reference's cross-flag errors hold.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from repro_torch import configs
from repro_torch.distributed import mesh
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.serve import (ReplicaRouter, RouterConfig, ServeEngine,
                               SLOConfig, TraceConfig, make_trace,
                               restore_params)
from repro_torch.train.serve_step import bucketed_max_len, greedy_generate


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
                    help="TP-shard serving over the mesh 'model' axis "
                    "(M ranks)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="kept for the reference CLI's sake: the CUDA "
                    "kernels are always used on the card")
    ap.add_argument("--faults", default="",
                    help="chaos spec, slowdown/preempt kinds only "
                    "(e.g. 'slowdown@4:w0,preempt@9'); with --replicas > 1 "
                    "the replica scope (kind@step:rN)")
    # -- replica router -------------------------------------------------------
    ap.add_argument("--replicas", type=int, default=1,
                    help="front N replica sessions with the router "
                    "(virtual clock; --faults takes kind@step:rN)")
    ap.add_argument("--hedge-after", type=float, default=None,
                    help="[router] hedge stragglers past max(windowed p95, "
                    "this floor) virtual units")
    ap.add_argument("--timeout", type=float, default=None,
                    help="[router] per-attempt deadline before a jittered "
                    "backoff retry")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="SLO: windowed-p99 latency target. With --replicas "
                    "> 1 the router gates on its virtual clock (1 unit = "
                    "1 ms); with one replica the engine gates on measured "
                    "wall-clock seconds")
    ap.add_argument("--slo-mode", choices=("shed", "queue"), default="shed",
                    help="action while the SLO is violated")
    ap.add_argument("--restore", default="",
                    help="checkpoint dir: serve trained weights via the "
                    "verified restore bridge")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest good)")
    ap.add_argument("--ema", action="store_true",
                    help="serve the EMA weights from the checkpoint")
    # -- legacy toy path -----------------------------------------------------
    ap.add_argument("--toy", action="store_true",
                    help="legacy static-batch toy path (contiguous cache)")
    ap.add_argument("--batch", type=int, default=4, help="[toy] batch size")
    ap.add_argument("--prompt-len", type=int, default=8,
                    help="[toy] prompt length")
    ap.add_argument("--tokens", type=int, default=16,
                    help="[toy] tokens to decode")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record prefill/decode/admit/evict (and router "
                    "dispatch/hedge/timeout/failover) spans, exported as "
                    "Chrome-trace JSON (load at ui.perfetto.dev)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the metrics registry as JSONL (one object "
                    "per metric)")
    return ap


def _validate(args) -> None:
    if args.toy and (args.restore or args.mesh_model > 1 or args.faults):
        raise SystemExit("--toy is the legacy static path: it has no "
                         "--restore/--mesh-model/--faults support")
    if args.step is not None and not args.restore:
        raise SystemExit("--step needs --restore")
    if args.ema and not args.restore:
        raise SystemExit("--ema needs --restore")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.replicas == 1:
        for flag, val in (("--hedge-after", args.hedge_after),
                          ("--timeout", args.timeout)):
            if val is not None:
                raise SystemExit(f"{flag} needs --replicas > 1 "
                                 "(the router path)")
        if args.slo_p99_ms is not None and args.toy:
            raise SystemExit("--slo-p99-ms has no --toy support (the gate "
                             "lives in the serve engine / router)")
    elif args.toy or args.policy == "static":
        raise SystemExit("--replicas > 1 is the router path: continuous "
                         "policy only, no --toy")
    for flag, value in (("--trace", args.trace),
                        ("--metrics", args.metrics)):
        if value is None:
            continue
        if args.toy:
            raise SystemExit(f"{flag} has no --toy support (spans live in "
                             "the serve engine / router)")
        parent = os.path.dirname(os.path.abspath(value))
        if not os.path.isdir(parent):
            raise SystemExit(f"{flag} {value}: directory {parent} "
                             "does not exist")


def toy_prompt(seed: int, batch: int, prompt_len: int,
               vocab: int) -> np.ndarray:
    """The toy path's prompt ids [batch, prompt_len] from the seed."""
    return np.random.default_rng(seed + 1).integers(
        0, vocab, (batch, prompt_len), dtype=np.int64)


def toy_frames(batch: int, frames: int, d_model: int) -> np.ndarray:
    """The toy path's unit-normal encoder frames [batch, frames, d_model]
    (f32, a fixed seed, as the reference's); the path scales them by 0.1."""
    return np.random.default_rng(2).standard_normal(
        (batch, frames, d_model), dtype=np.float32)


def _toy_main(args, cfg, model, device) -> None:
    prompt = torch.from_numpy(toy_prompt(args.seed, args.batch,
                                         args.prompt_len, cfg.vocab_size))
    # power-of-two cache bucket: mixed prompt lengths share one shape
    max_len = bucketed_max_len(args.prompt_len + args.tokens + 1)
    frames = None
    if cfg.family == "audio":
        frames = 0.1 * torch.from_numpy(toy_frames(
            args.batch, cfg.encoder_seq_len, cfg.d_model)).to(device)
    marks = []
    out = greedy_generate(model, prompt.to(device), args.tokens, max_len,
                          cache_dtype=torch.int8 if args.cache_int8
                          else None, marks=marks, encoder_frames=frames)
    prefill_s, decode_s = marks[1] - marks[0], marks[2] - marks[1]
    cache = "int8" if args.cache_int8 else cfg.dtype
    print(f"[serve] {args.arch} cache={cache} prefill {prefill_s:.2f}s, "
          f"decode {args.tokens} toks x "
          f"{args.batch} seqs in {decode_s:.2f}s "
          f"({args.batch * args.tokens / max(decode_s, 1e-9):.1f} tok/s host)")
    for row in out.cpu().tolist():
        print(f"  {row}")


def _router_main(args, engine, trace, tracer=None, metrics=None,
                 say=print) -> None:
    slo = None
    if args.slo_p99_ms is not None:
        slo = SLOConfig(target_p99=args.slo_p99_ms, mode=args.slo_mode)
    router = ReplicaRouter(
        engine,
        RouterConfig(num_replicas=args.replicas, timeout=args.timeout,
                     hedge_after=args.hedge_after, seed=args.seed,
                     faults=args.faults or None, fault_seed=args.seed),
        slo=slo, tracer=tracer, metrics=metrics)
    report = router.run(trace)
    m = report.metrics
    say(f"[serve] {args.arch} router replicas={args.replicas} "
        f"slots={args.slots}x{args.replicas}"
        f"{f' hedge>{args.hedge_after}' if args.hedge_after else ''}"
        f"{f' timeout={args.timeout}' if args.timeout else ''}"
        f"{f' slo-p99={args.slo_p99_ms}({args.slo_mode})' if slo else ''}")
    say(f"  {m['completed']}/{m['total']} completed, {m['rejected']} "
        f"rejected, {m['lost_requests']} lost in {m['duration']:.1f} "
        f"virtual units -> goodput {m['goodput']:.3f} req/unit")
    say(f"  latency p50 {m['p50_latency']:.2f} p99 {m['p99_latency']:.2f}"
        f" | hedges {m['hedges']} (won {m['hedge_wins']})"
        f" | retries {m['retries']} | drained {m['drained']}"
        f" | crashes {m['crashes']} preempts {m['preempts']} "
        f"restarts {m['restarts']}")
    for ev in report.health:
        say(f"  health: {ev}")
    for rej in report.rejected[:4]:
        say(f"  rejected: {rej}")
    for c in report.completed[:4]:
        say(f"  rid={c.rid} replica={c.replica}"
            f"{' hedged' if c.hedged else ''} {c.tokens}")


def _export_obs(args, tracer, metrics) -> None:
    if tracer is not None:
        tracer.export(args.trace)
        print(f"[serve] trace: {args.trace} ({len(tracer)} events, "
              f"{tracer.dropped} dropped)")
    if metrics is not None:
        metrics.dump_jsonl(args.metrics)
        print(f"[serve] metrics: {args.metrics} ({len(metrics)} series)")


def main(argv=None) -> None:
    args = _build_parser().parse_args(argv)
    _validate(args)
    device = resolve_device(args.device)
    if args.mesh_model > 1 and not torch.distributed.is_initialized():
        if "RANK" not in os.environ:      # one new process per rank
            mesh.spawn(_rank_main, 1, device, args=(args,),
                       mesh_model=args.mesh_model)
            return
        mesh.join(1, device, mesh_model=args.mesh_model)   # from torchrun
        device = mesh.rank_device(device, mesh.rank())
    _serve(args, device)


def _rank_main(rank: int, device, args) -> None:
    _serve(args, device)


def _serve(args, device) -> None:
    leader = mesh.is_leader()
    say = print if leader else (lambda *a, **k: None)
    cfg = configs.get_smoke_config(args.arch)
    if args.restore:
        model, manifest = restore_params(args.restore, cfg, step=args.step,
                                         use_ema=args.ema, device=device)
        say(f"[serve] restored step {manifest['step']} from {args.restore}"
            f"{' (ema)' if args.ema else ''}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = get_model(cfg, device=device, generator=gen)
    if args.toy:
        _toy_main(args, cfg, model, device)
        return
    tracer = Tracer() if args.trace and leader else None
    metrics = MetricsRegistry() if args.metrics and leader else None
    engine_slo = None
    if args.slo_p99_ms is not None and args.replicas == 1:
        # one replica: the gate runs inside the engine on its wall clock
        engine_slo = SLOConfig(target_p99=args.slo_p99_ms,
                               mode=args.slo_mode)
    engine = ServeEngine(
        cfg, model, num_slots=args.slots, page_size=args.page_size,
        max_prompt_len=args.max_prompt, max_new_cap=args.max_new,
        cache_int8=args.cache_int8, mesh_model=args.mesh_model,
        device=device,
        faults=None if args.replicas > 1 else (args.faults or None),
        fault_seed=args.seed,
        clock="virtual" if args.replicas > 1 else "wall",
        slo=engine_slo, tracer=tracer, metrics=metrics)
    trace = make_trace(TraceConfig(
        num_requests=args.requests, rate=args.rate,
        prompt_len_min=2, prompt_len_max=args.max_prompt,
        max_new_min=2, max_new_max=args.max_new,
        vocab=cfg.vocab_size, seed=args.seed))
    if args.replicas > 1:
        _router_main(args, engine, trace, tracer=tracer, metrics=metrics,
                     say=say)
        _export_obs(args, tracer, metrics)
        return
    report = engine.run(trace, policy=args.policy)
    if not leader:
        return
    m = report.metrics
    print(f"[serve] {args.arch} policy={args.policy} slots={args.slots} "
          f"pages={engine.pool_cfg.num_pages}x{args.page_size}"
          f"{' int8' if args.cache_int8 else ''}"
          f"{f' tp={args.mesh_model}' if args.mesh_model > 1 else ''}"
          f" device={device}")
    print(f"  {m['completed']} requests, {m['total_tokens']} tokens in "
          f"{m['duration']:.2f}s -> {m['tokens_per_s']:.1f} tok/s")
    print(f"  latency p50 {m['p50_latency']:.3f}s p99 {m['p99_latency']:.3f}s"
          f" | ttft p50 {m['p50_ttft']:.3f}s"
          f" | occupancy {m['mean_occupancy']:.2f}"
          f" | compiles prefill={m['prefill_compiles']} "
          f"decode={m['decode_compiles']}")
    if engine_slo is not None:
        print(f"  slo: shed {m['rejected_slo_shed']} trips {m['slo_trips']}"
              f" estimate {m['slo_estimate']:.3f}s")
    print(f"  wall {m['wall_time_s']:.2f}s (prefill {m['prefill_s']:.2f}s "
          f"decode {m['decode_s']:.2f}s)")
    for ev in report.events:
        print(f"  chaos: {ev}")
    for c in report.completed[:4]:
        print(f"  rid={c.rid} {c.tokens}")
    _export_obs(args, tracer, metrics)


if __name__ == "__main__":
    main()
