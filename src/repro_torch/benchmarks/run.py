"""The paper's convergence experiments, one after another.
Reference: ``benchmarks/run.py`` (its rows for these three benches).

Prints ``name,us_per_call,derived`` rows under the reference's names:

  bench_iterations_vs_n  — Fig. 5 (iterations vs N); its fit feeds
  bench_time_to_converge — Fig. 6 (optimal N/b split of 100 machines)
  bench_sync_vs_async    — Figs. 8/9 (the headline comparison)

Quick mode by default (``--full`` for the reference's full-length runs);
writes no file.

    python -m repro_torch.benchmarks.run [--device cpu] [--full] [--steps S]
"""
from __future__ import annotations

import argparse
from typing import Iterable, Optional, Sequence, Tuple

from repro_torch.benchmarks import (bench_iterations_vs_n,
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
    rows, fit = bench_iterations_vs_n.run(quick, device=device)
    _print(rows)
    _print(bench_time_to_converge.run(quick, fit=fit))
    _print(bench_sync_vs_async.run(quick, args.steps, device=device))


if __name__ == "__main__":
    main()
