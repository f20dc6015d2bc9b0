#!/usr/bin/env python
"""Scrub physically-impossible measurements from a sweep artifact.

A single timing measurement can spike, and a contaminated slope median can
go to zero, recording picosecond "kernel times" that no device can reach.
This tool deletes sweep records
containing such impossibilities so ``tools/sweep.py --resume`` re-measures
exactly those configs — the same repair loop as the reference's re-runnable
per-config sweep (``run_benchmark.py:46-105`` records per-config errors and
the grid is restartable).

A record is scrubbed when ANY kernel result has:
  * ``seconds`` below the hard floor (default 100 ns — no config in the
    canonical grid is remotely that fast), or
  * ``roofline_fraction`` above the cutoff (default 1.05 — above the HBM
    roofline means a broken measurement, not a fast kernel).

Usage:
    python tools/sweep_sanitize.py bench_artifacts/canonical_sweep.json
    python tools/sweep.py --output ... --resume ...   # refill scrubbed configs
"""

from __future__ import annotations

import argparse
import json


def scan(records, *, min_seconds: float, max_roofline: float):
    """Partition records into (kept, scrubbed_with_reasons)."""
    kept, scrubbed = [], []
    for rec in records:
        reasons = []
        for name, res in rec.get("results", {}).items():
            if not isinstance(res, dict) or "error" in res:
                continue  # documented skips/failures stay as-is
            sec = res.get("seconds")
            rf = res.get("roofline_fraction")
            if sec is not None and sec < min_seconds:
                reasons.append(f"{name}: seconds={sec:.3g} < {min_seconds:g}")
            elif rf is not None and rf > max_roofline:
                reasons.append(f"{name}: roofline_fraction={rf:.3g} > "
                               f"{max_roofline:g}")
        if reasons:
            scrubbed.append((rec, reasons))
        else:
            kept.append(rec)
    return kept, scrubbed


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("artifact")
    p.add_argument("--min-seconds", type=float, default=1e-7,
                   help="hard physical floor for a per-invocation time")
    p.add_argument("--max-roofline", type=float, default=1.05,
                   help="measurements above the HBM roofline are broken")
    p.add_argument("--dry-run", action="store_true",
                   help="report what would be scrubbed without rewriting")
    args = p.parse_args(argv)

    with open(args.artifact) as f:
        records = json.load(f)
    kept, scrubbed = scan(records, min_seconds=args.min_seconds,
                          max_roofline=args.max_roofline)
    for rec, reasons in scrubbed:
        tc = rec.get("test_case", {})
        print(f"scrub M={tc.get('M')} K={tc.get('K')} N={tc.get('N')} "
              f"s={tc.get('s')}: " + "; ".join(reasons))
    if not scrubbed:
        print(f"{args.artifact}: all {len(records)} records sane")
        return 0
    if args.dry_run:
        print(f"dry run: would scrub {len(scrubbed)}/{len(records)} records")
        return 0
    with open(args.artifact, "w") as f:
        json.dump(kept, f, indent=1)
    print(f"scrubbed {len(scrubbed)}/{len(records)} records -> "
          f"{args.artifact}; refill with tools/sweep.py --resume")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
