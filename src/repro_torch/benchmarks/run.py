"""The benchmark harness: the paper's figures, then the harness benches,
in the reference's order. Reference: ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` rows under the reference's names:

  bench_straggler        — Figs. 3/4 (arrival order statistics; host)
  bench_layer_staleness  — Table 1 / Fig. 1 (staleness by depth; host)
  bench_iterations_vs_n  — Fig. 5 (iterations vs N); its fit feeds
  bench_time_to_converge — Fig. 6 (optimal N/b split of 100 machines)
  bench_staleness        — Fig. 2 / §2.1 (staleness degrades the optimum)
  bench_lr_sweep         — Table 2 / Fig. 7 (speed vs final metric)
  bench_sync_vs_async    — Figs. 8/9 (the headline comparison)
  bench_event_loop       — chunked event engine vs the per-arrival loop
  bench_spmd             — SPMD mesh engine vs simulated backend
  bench_recovery         — MTTR + chaos overhead of the recovery supervisor
  bench_serve            — continuous batching vs static at 3 offered loads
  bench_obs              — tracer overhead + perfmodel predicted-vs-measured
  bench_step_time        — step-time microbenchmark per arch
  bench_router           — the replica router's hedging, chaos and SLO arms
  bench_loop_overhead    — chunked training loop vs the per-step loop

The roofline's row is not run here: it reads the dry run's records
(``repro_torch.benchmarks.roofline``). As in the reference, a bench that
raises prints ``<name>.ERROR`` and the run goes on, then exits 1.

Quick mode by default (``--full`` for the reference's full-length runs);
writes no file. ``--mesh-data D`` runs bench_spmd's cells at D ranks on
the ``'data'`` axis and ``--mesh-models M ...`` picks its ``'model'``
axes (the defaults, W and 1 2, need up to 16 cards on the card;
``--mesh-data 1 --mesh-models 1`` runs on one card).

    python -m repro_torch.benchmarks.run [--device cpu] [--full] [--steps S]
        [--mesh-data D] [--mesh-models M ...]
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import Iterable, Optional, Sequence, Tuple

from repro_torch.benchmarks import (bench_event_loop, bench_iterations_vs_n,
                                    bench_layer_staleness,
                                    bench_loop_overhead, bench_lr_sweep,
                                    bench_obs, bench_recovery, bench_router,
                                    bench_serve, bench_spmd, bench_staleness,
                                    bench_step_time, bench_straggler,
                                    bench_sync_vs_async,
                                    bench_time_to_converge)
from repro_torch.models.common import resolve_device


def _print(rows: Iterable[Tuple[str, float, str]]) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the card (the default)")
    ap.add_argument("--full", action="store_true",
                    help="the reference's full-length runs")
    ap.add_argument("--steps", type=int, default=None,
                    help="sync steps of the sync-vs-async runs")
    ap.add_argument("--mesh-data", type=int, default=None, metavar="D",
                    help="bench_spmd's 'data' ranks (default: W)")
    ap.add_argument("--mesh-models", type=int, nargs="+", default=None,
                    metavar="M", help="bench_spmd's 'model' axes "
                    "(default: 1 2)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    quick = not args.full
    fig5 = {"fit": None}

    def iterations_vs_n():
        rows, fig5["fit"] = bench_iterations_vs_n.run(quick, device=device)
        return rows

    benches = [
        ("straggler", lambda: bench_straggler.run(quick)),
        ("layer_staleness", lambda: bench_layer_staleness.run(quick)),
        ("iterations_vs_n", iterations_vs_n),
        ("time_to_converge",
         lambda: bench_time_to_converge.run(quick, fit=fig5["fit"])),
        ("staleness", lambda: bench_staleness.run(quick, device=device)),
        ("lr_sweep", lambda: bench_lr_sweep.run(quick, device=device)),
        ("sync_vs_async",
         lambda: bench_sync_vs_async.run(quick, args.steps, device=device)),
        ("event_loop", lambda: bench_event_loop.run(quick, device=device)),
        ("spmd", lambda: bench_spmd.run(quick, device=device,
                                        mesh_data=args.mesh_data,
                                        mesh_models=args.mesh_models)),
        ("recovery", lambda: bench_recovery.run(quick, device=device)),
        ("serve", lambda: bench_serve.run(quick, device=device)),
        ("obs", lambda: bench_obs.run(quick, device=device)),
        ("step_time", lambda: bench_step_time.run(quick, device=device)),
        ("router", lambda: bench_router.run(quick, device=device)),
        ("loop", lambda: bench_loop_overhead.run(quick, device=device)),
    ]
    print("name,us_per_call,derived")
    failures = 0
    for name, bench in benches:
        t0 = time.time()
        try:
            _print(bench())
        except Exception as e:  # noqa: BLE001 — report and continue
            failures += 1
            print(f"{name}.ERROR,0,{type(e).__name__}: {e}", flush=True)
            traceback.print_exc(file=sys.stderr)
        print(f"{name}.wall_s,{(time.time() - t0) * 1e6:.0f},total",
              file=sys.stderr)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
