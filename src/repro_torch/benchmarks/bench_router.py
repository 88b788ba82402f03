"""Replica-router bench: hedging tail-cut, chaos accounting, SLO goodput.
Reference: ``benchmarks/bench_router.py`` (its arms, lines and payload).

Everything runs on the router's deterministic virtual clock (1 decode
step = 1 unit), so the numbers are machine-independent and every arm is
bit-replayable. Five arms over one shared engine (replicas are
StepSessions of the same build; on the card each captures its decode
graph):

* ``baseline`` — R healthy replicas, moderate load.
* ``chaos_unhedged`` / ``chaos_hedged`` — one replica is a 20x
  straggler for the whole run; the hedged arm re-dispatches requests
  whose age crosses max(windowed p95, floor) to a second replica and
  takes the first completion. Headline: ``hedged_vs_unhedged_p99``.
* ``chaos_mix`` — crash + restart + preemption + slowdown with hedging
  on, run twice: ``chaos_lost_requests == 0``, byte-identical replay, and
  greedy token parity with a single-engine reference.
* ``slo_shed`` — sustained overload on one replica with and without the
  windowed-p99 admission gate; plus a burst-then-trickle trace showing
  the controller re-opening (``slo_reentered``).

The smoke model's weights are drawn from seed 0 (``model=`` hands in
others: the tests give it the reference's). Returns the payload; writes
it only to ``--out PATH``.

    python -m repro_torch.benchmarks.bench_router [--device cpu] [--quick]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.benchmarks import common
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.serve import (ReplicaRouter, RouterConfig, SLOConfig,
                               ServeEngine, TraceConfig, make_trace)

REPLICAS = 3
STRAGGLER = "slowdown@0:r0:x20:d1000"
MIX = ("slowdown@0:r0:x8:d50,crash@10:r2,restart@30:r2,"
       "preempt@40:r1:d8")


def _arm(m, **extra):
    out = {"completed": m["completed"], "rejected": m["rejected"],
           "lost_requests": m["lost_requests"], "goodput": m["goodput"],
           "p50_latency": m["p50_latency"], "p99_latency": m["p99_latency"],
           "hedges": m["hedges"], "hedge_wins": m["hedge_wins"],
           "drained": m["drained"], "crashes": m["crashes"],
           "preempts": m["preempts"], "restarts": m["restarts"],
           "shed": m["shed"]}
    out.update(extra)
    return out


def main(argv=None, *, model=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="short traces (CI canary settings)")
    ap.add_argument("--requests", type=int, default=None)
    common.add_harness_args(ap)
    args = ap.parse_args(argv)
    requests = args.requests or (32 if args.quick else 64)
    device = resolve_device(args.device)

    cfg = configs.get_smoke_config("qwen3-0.6b")
    if model is None:
        model = get_model(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))
    engine = ServeEngine(cfg, model, num_slots=2, page_size=4,
                         max_prompt_len=12, max_new_cap=8, clock="virtual",
                         device=device)

    def trace(n=requests, rate=2.0, seed=0, min_new=4, max_new=8):
        return make_trace(TraceConfig(
            num_requests=n, rate=rate, prompt_len_min=2, prompt_len_max=12,
            max_new_min=min_new, max_new_max=max_new, vocab=cfg.vocab_size,
            seed=seed))

    def route(tr, rc, slo=None):
        return ReplicaRouter(engine, rc, slo=slo).run(tr)

    arms = {}
    tr = trace()
    ref_tokens = engine.run(tr).tokens_by_rid()

    # -- baseline -------------------------------------------------------------
    base = route(tr, RouterConfig(num_replicas=REPLICAS))
    arms["baseline"] = _arm(base.metrics)
    print(f"baseline    p99 {base.metrics['p99_latency']:7.1f} "
          f"goodput {base.metrics['goodput']:.3f}")

    # -- straggler replica: hedged vs unhedged --------------------------------
    # offered load below the *healthy* capacity (2 of 3 replicas), so the
    # tail is pure straggler effect, not queueing saturation — hedging
    # fixes stragglers, it cannot manufacture capacity
    strag_tr = trace(rate=0.5, seed=1)
    unhedged = route(strag_tr, RouterConfig(num_replicas=REPLICAS,
                                            faults=STRAGGLER))
    hedged = route(strag_tr, RouterConfig(num_replicas=REPLICAS,
                                          faults=STRAGGLER, hedge_after=6.0))
    ratio = unhedged.metrics["p99_latency"] / \
        max(hedged.metrics["p99_latency"], 1e-9)
    arms["chaos_unhedged"] = _arm(unhedged.metrics)
    arms["chaos_hedged"] = _arm(hedged.metrics)
    print(f"straggler   p99 {unhedged.metrics['p99_latency']:7.1f} -> "
          f"{hedged.metrics['p99_latency']:7.1f} hedged "
          f"({ratio:.2f}x, {hedged.metrics['hedges']} hedges)")

    # -- chaos mix: zero lost, bit-identical replay, token parity -------------
    mix_cfg = lambda: RouterConfig(  # noqa: E731
        num_replicas=REPLICAS, faults=MIX, hedge_after=6.0)
    mix_a, mix_b = route(tr, mix_cfg()), route(tr, mix_cfg())
    replay_identical = (mix_a.metrics == mix_b.metrics
                        and mix_a.events == mix_b.events
                        and mix_a.health == mix_b.health
                        and mix_a.tokens_by_rid() == mix_b.tokens_by_rid())
    parity = all(ref_tokens[c.rid] == c.tokens for c in mix_a.completed)
    arms["chaos_mix"] = _arm(mix_a.metrics,
                             replay_identical=replay_identical,
                             token_parity=parity)
    print(f"chaos mix   lost {mix_a.metrics['lost_requests']} "
          f"replay_identical {replay_identical} token_parity {parity}")

    # -- SLO admission: goodput under sustained overload ----------------------
    over = trace(rate=1.0, seed=3)
    unshed = route(over, RouterConfig(num_replicas=1))
    shed = route(over, RouterConfig(num_replicas=1),
                 slo=SLOConfig(target_p99=10.0, window=16, min_samples=4))
    arms["slo_unshed"] = _arm(unshed.metrics)
    arms["slo_shed"] = _arm(shed.metrics,
                            slo_trips=shed.metrics["slo_trips"])
    shed_fraction = shed.metrics["shed"] / max(shed.metrics["total"], 1)
    print(f"slo shed    p99 {unshed.metrics['p99_latency']:7.1f} -> "
          f"{shed.metrics['p99_latency']:7.1f} shedding "
          f"{shed_fraction:.2f} of load")

    # -- SLO hysteresis: burst, then the gate must re-open --------------------
    # sizes pinned: the tail must hold enough probe completions to flush
    # the estimator window (8) or the gate can't demonstrably re-open
    burst = trace(n=24, rate=4.0, seed=3)
    tail = trace(n=20, rate=0.15, seed=4, min_new=2, max_new=4)
    t0 = burst[-1].arrival + 12.0
    btt = list(burst) + [
        dataclasses.replace(r, rid=1000 + r.rid, arrival=t0 + r.arrival)
        for r in tail]
    recov = route(btt, RouterConfig(num_replicas=1),
                  slo=SLOConfig(target_p99=15.0, window=8, min_samples=4,
                                quantile=90.0, probe_every=2))
    arms["slo_recover"] = _arm(recov.metrics,
                               slo_trips=recov.metrics["slo_trips"],
                               slo_reentered=recov.metrics["slo_reentered"])
    print(f"slo recover trips {recov.metrics['slo_trips']} "
          f"reentered {recov.metrics['slo_reentered']}")

    chaos_lost = (mix_a.metrics["lost_requests"]
                  + hedged.metrics["lost_requests"]
                  + unhedged.metrics["lost_requests"])
    payload = {
        "bench": "router",
        "model": "qwen3-0.6b smoke",
        "replicas": REPLICAS,
        "slots_per_replica": engine.pool_cfg.num_slots,
        "requests": requests,
        "arms": arms,
        "hedged_vs_unhedged_p99": ratio,
        "chaos_lost_requests": chaos_lost,
        "replay_identical": replay_identical,
        "token_parity": parity,
        "goodput_shed": shed.metrics["goodput"],
        "goodput_unshed": unshed.metrics["goodput"],
        "shed_fraction": shed_fraction,
        "slo_reentered": recov.metrics["slo_reentered"],
    }
    path = common.write_out(args.out, payload, device)
    print(f"hedged vs unhedged p99: {ratio:.2f}x, chaos lost "
          f"{chaos_lost}" + (f" -> {path}" if path else ""))
    return payload


def run(quick: bool = True, device=None):
    """The harness contract: (name, us_per_call, derived)."""
    payload = main((["--quick"] if quick else [])
                   + (["--device", str(device)] if device else []))
    return [
        ("router.hedged_vs_unhedged_p99", 0.0,
         f"{payload['hedged_vs_unhedged_p99']:.2f}x"),
        ("router.chaos_lost_requests", 0.0,
         str(payload["chaos_lost_requests"])),
        ("router.goodput_shed", 0.0, f"{payload['goodput_shed']:.3f}/u"),
    ]


if __name__ == "__main__":
    main()
