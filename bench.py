#!/usr/bin/env python
"""Headline benchmark: flagship kernels at the reference's north-star config.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Config: M=32, K=1024, N=4096, s=4 — the reference's canonical shape
(``compiler_testing/test.sh:8``, BASELINE.md). Metric: useful-adds GFLOP/s of
the best kernel (the reference's flops/cycle convention, ``readme.md:84-85``,
re-based to wall time). vs_baseline: the reference's best published number at
this config — 2.31712e7 cycles for 33,685,504 useful adds
(``compiler_testing/compiler_results_cold_cache.txt:1-2``) at the repo's own
FREQUENCY=3.2 GHz constant (``cpp_impl/perf.cpp:30``) = 4.652 GFLOP/s.

Usage: python bench.py [--all] [--correctness] [--json-out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys

#: Reference best at the north-star config (see module docstring).
REFERENCE_GFLOPS = 33_685_504 / (2.31712e7 / 3.2e9) / 1e9

#: The kernel set benchmarked by default: the serving format's kernels and
#: the dense and packed XLA formulations (the segment-sum formulations exist
#: for capability parity with the reference; include them with --all). The
#: GPU-only kernels are dropped on the CPU.
DEFAULT_KERNELS = [
    "TritonTiledBitplane_x8", "TiledBitplane_x8", "TiledBitplane",
    "DenseMXU", "DenseMXU_bf16", "DenseMXU_x8",
    "PackedMXU_2bit", "PackedMXU_base3",
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--K", type=int, default=1024)
    p.add_argument("--N", type=int, default=4096)
    p.add_argument("--s", type=int, default=4)
    p.add_argument("--all", action="store_true",
                   help="benchmark the full kernel registry")
    p.add_argument("--kernels", default=None,
                   help="comma-separated kernel names (overrides --all)")
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the host (for tests; times then "
                        "describe no device); otherwise a GPU is required")
    p.add_argument("--correctness", action="store_true",
                   help="gate every kernel vs the dense reference first")
    p.add_argument("--prelu", action="store_true")
    p.add_argument("--repeats", type=int, default=3,
                   help="independent calibrated slope estimates per kernel "
                        "(median reported, spread emitted)")
    p.add_argument("--json-out", default=None,
                   help="also write the full per-kernel records (reference "
                        "sweep schema) to this path")
    p.add_argument("--measure-beta", action="store_true",
                   help="measure achievable memory bandwidth and use it as "
                        "the roofline beta instead of the published peak")
    p.add_argument("--stacked", choices=["auto", "on", "off"], default="auto",
                   help="also measure the stacked-regime marginal (chained "
                        "L-layer program, fixed dispatch costs cancel). "
                        "auto = on a GPU at the north-star config only")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from ternary_spgemm_tpu import platform
    from ternary_spgemm_tpu.bench import BenchConfig, run_config, to_reference_json
    from ternary_spgemm_tpu.ops import all_kernels

    platform.configure_compile_cache()
    on_gpu = platform.measurement_device(args.platform).platform == "gpu"
    if args.kernels:
        kernels = args.kernels.split(",")
    elif args.all:
        kernels = None
    else:
        kernels = [k for k in DEFAULT_KERNELS
                   if on_gpu or not all_kernels()[k].gpu_only]
    cfg = BenchConfig(
        M=args.M, K=args.K, N=args.N, s=args.s, prelu=args.prelu,
        correctness=args.correctness, kernels=kernels,
        repeats=max(1, args.repeats))
    beta = None
    if args.measure_beta:
        from ternary_spgemm_tpu.bench import measure_hbm_bandwidth
        beta = measure_hbm_bandwidth()
        print(f"# measured memory bandwidth: {beta / 1e9:.1f} GB/s")
    results = run_config(cfg, verbose=args.verbose, bandwidth=beta)
    ok = [r for r in results if not r.error]
    if args.json_out:
        from ternary_spgemm_tpu.bench import dump_json
        dump_json([to_reference_json(cfg, results)], args.json_out)
    if not ok:
        print(json.dumps({"metric": "ternary_spgemm_useful_gflops",
                          "value": 0.0, "unit": "GFLOP/s", "vs_baseline": 0.0,
                          "error": "; ".join(f"{r.name}: {r.error}" for r in results)}))
        return 1
    registry = all_kernels()
    # Headline = best kernel that passes the reference's exact tolerance
    # gate ON THE REFERENCE'S FULL +-512 activation domain: statically exact,
    # unrestricted domain (the _x8 |x|<=127 kernels bench but don't set the
    # headline — different input contract), AND measured correct when
    # --correctness ran.
    exact = [r for r in ok
             if not registry[r.name].approximate and r.correct is not False
             and (registry[r.name].x_absmax is None
                  or registry[r.name].x_absmax >= 512)]
    best = max(exact or ok, key=lambda r: r.gflops)
    best_any = max(ok, key=lambda r: r.gflops)

    # Stacked-regime marginal: the same line carries the per-layer cost
    # inside a deep program, where fixed dispatch costs cancel.
    stacked = {}
    want_stacked = args.stacked == "on" or (
        args.stacked == "auto"
        and (args.M, args.K, args.N, args.s) == (32, 1024, 4096, 4)
        and on_gpu)
    if want_stacked:
        try:
            from ternary_spgemm_tpu.bench.stacked import (
                measure_stacked_marginal)
            full = measure_stacked_marginal(
                args.M, args.K, args.N, args.s,
                repeats=max(1, args.repeats), bandwidth=beta)
            stacked = {k: v for k, v in full.items() if k != "stacked_rows"}
            stacked["stacked_marginal_seconds"] = float(
                full["stacked_marginal_seconds"])
        except Exception as e:  # the isolated record must still print
            stacked = {"stacked_error": f"{type(e).__name__}: {e}"}
    import jax
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "ternary_spgemm_useful_gflops",
        "value": round(best.gflops, 3),
        "unit": "GFLOP/s",
        "vs_baseline": round(best.gflops / REFERENCE_GFLOPS, 3),
        "best_kernel": best.name,
        "seconds": best.seconds,
        "seconds_spread": round(best.seconds_spread, 4),
        "n_estimates": best.n_estimates,
        "effective_gflops": round(best.effective_gflops, 3),
        "nnz_per_s": best.nnz_per_s,
        "roofline_fraction": best.roofline_fraction,
        "own_roofline_fraction": best.own_roofline_fraction,
        "best_any_kernel": best_any.name,
        "best_any_gflops": round(best_any.gflops, 3),
        **stacked,
        "config": {"M": args.M, "K": args.K, "N": args.N, "s": args.s},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
