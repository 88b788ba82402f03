"""The paper's figures, one after another, in the reference's order.
Reference: ``benchmarks/run.py`` (its rows for these seven benches).

Prints ``name,us_per_call,derived`` rows under the reference's names:

  bench_straggler        — Figs. 3/4 (arrival order statistics; host)
  bench_layer_staleness  — Table 1 / Fig. 1 (staleness by depth; host)
  bench_iterations_vs_n  — Fig. 5 (iterations vs N); its fit feeds
  bench_time_to_converge — Fig. 6 (optimal N/b split of 100 machines)
  bench_staleness        — Fig. 2 / §2.1 (staleness degrades the optimum)
  bench_lr_sweep         — Table 2 / Fig. 7 (speed vs final metric)
  bench_sync_vs_async    — Figs. 8/9 (the headline comparison)

The reference's harness benches (event loop, spmd, recovery, serve, obs,
step time) and the roofline's row are not run here: the roofline reads
the dry run's records (``repro_torch.benchmarks.roofline``).

Quick mode by default (``--full`` for the reference's full-length runs);
writes no file.

    python -m repro_torch.benchmarks.run [--device cpu] [--full] [--steps S]
"""
from __future__ import annotations

import argparse
from typing import Iterable, Optional, Sequence, Tuple

from repro_torch.benchmarks import (bench_iterations_vs_n,
                                    bench_layer_staleness, bench_lr_sweep,
                                    bench_staleness, bench_straggler,
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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    quick = not args.full
    print("name,us_per_call,derived")
    _print(bench_straggler.run(quick))
    _print(bench_layer_staleness.run(quick))
    rows, fit = bench_iterations_vs_n.run(quick, device=device)
    _print(rows)
    _print(bench_time_to_converge.run(quick, fit=fit))
    _print(bench_staleness.run(quick, device=device))
    _print(bench_lr_sweep.run(quick, device=device))
    _print(bench_sync_vs_async.run(quick, args.steps, device=device))


if __name__ == "__main__":
    main()
