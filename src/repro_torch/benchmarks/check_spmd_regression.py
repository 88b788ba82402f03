"""SPMD perf-regression guard: a fresh spmd payload against a baseline.
Reference: ``benchmarks/check_spmd_regression.py`` (``compare``, ``main``;
the same records, lines and exit codes).

Every ``spmd_vs_sim_*`` overhead ratio present in BOTH payloads must not
drop more than ``--threshold`` (default 20%) below its baseline: a drop
means the mesh engine got structurally slower relative to the simulated
backend on the same host (the ratio is dimensionless, so it transfers
across machines in a way raw steps/s never could). The
``spmd_bytes_per_step_*`` axis is guarded in the opposite direction:
collective bytes are DETERMINISTIC (the port counts them from the step's
recorded collectives, ``launch.dryrun.plan_train``, not timed), so
growing them past the threshold means the fused reduce-then-all-reduce
lost its fusion.

Exit status 1 on any regression, with a per-cell report either way. The
payloads are the JSON ``bench_spmd --out PATH`` writes.

Usage:
    python -m repro_torch.benchmarks.check_spmd_regression BASELINE.json \
        FRESH.json [--threshold 0.2]
"""
from __future__ import annotations

import argparse
import json
import sys

RATIO_PREFIX = "spmd_vs_sim_"
BYTES_PREFIX = "spmd_bytes_per_step_"


def compare(baseline: dict, fresh: dict, threshold: float) -> list:
    """Regression records: (key, base, new, relative_change).

    Ratios regress by DROPPING, bytes regress by GROWING; keys present
    in only one payload are reported as informational skips by main()
    but never fail (the schema is allowed to gain cells).
    """
    bad = []
    for key, base in baseline.items():
        if key not in fresh or not isinstance(base, (int, float)):
            continue
        new = fresh[key]
        if key.startswith(RATIO_PREFIX) and base > 0:
            change = (new - base) / base
            if change < -threshold:
                bad.append((key, base, new, change))
        elif key.startswith(BYTES_PREFIX) and base > 0:
            change = (new - base) / base
            if change > threshold:
                bad.append((key, base, new, change))
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("baseline",
                    help="baseline spmd payload (bench_spmd --out)")
    ap.add_argument("fresh", help="fresh spmd payload (bench_spmd --out)")
    ap.add_argument("--threshold", type=float, default=0.2,
                    help="max tolerated relative regression (default 0.2)")
    args = ap.parse_args(argv)
    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.fresh) as f:
        fresh = json.load(f)

    tracked = [k for k in baseline
               if k.startswith((RATIO_PREFIX, BYTES_PREFIX))
               and isinstance(baseline[k], (int, float))]
    if not tracked:
        print("check_spmd_regression: baseline has no tracked keys "
              "(schema too old?) — nothing to guard")
        return 0
    for key in sorted(tracked):
        if key not in fresh:
            print(f"  {key}: only in baseline — skipped")
            continue
        base, new = baseline[key], fresh[key]
        change = (new - base) / base if base else 0.0
        print(f"  {key}: {base:.4g} -> {new:.4g} ({change:+.1%})")

    bad = compare(baseline, fresh, args.threshold)
    if bad:
        print(f"\nREGRESSION (> {args.threshold:.0%}):")
        for key, base, new, change in bad:
            kind = "ratio dropped" if key.startswith(RATIO_PREFIX) \
                else "bytes grew"
            print(f"  {key}: {kind} {base:.4g} -> {new:.4g} ({change:+.1%})")
        return 1
    print(f"\nOK: no tracked key regressed past {args.threshold:.0%}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
