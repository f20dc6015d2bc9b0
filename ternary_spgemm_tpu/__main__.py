"""CLI mirroring the reference benchmark binary.

Reference usage (``readme.md:30-35``)::

    sudo ./sparseGEMM.out -M 32 -K 1024 -N 4096 -s 4 [-correctness]

Here::

    python -m ternary_spgemm_tpu -M 32 -K 1024 -N 4096 -s 4 [-correctness]

Unlike the reference (fixed positional flag order, ``main.cpp:49-52``), flags
may appear in any order. Runs every registered kernel (or ``--kernels``),
gates against the dense reference when ``-correctness`` is given
(``main.cpp:206-249``), then prints per-kernel timing, speedup vs BaseTCSC
(``main.cpp:257-263``), and the instrumented flops/OI quantities
(``main.cpp:264-271``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ternary_spgemm_tpu")
    p.add_argument("-M", type=int, default=32)
    p.add_argument("-K", type=int, default=1024)
    p.add_argument("-N", type=int, default=4096)
    p.add_argument("-s", type=int, default=4)
    p.add_argument("-correctness", action="store_true")
    p.add_argument("-prelu", action="store_true")
    p.add_argument("--kernels", default=None, help="comma-separated subset")
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the host; otherwise a GPU is required")
    args = p.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    from ternary_spgemm_tpu import platform
    from ternary_spgemm_tpu.bench import BenchConfig, run_config
    from ternary_spgemm_tpu.ops.api import BASELINE_KERNEL_NAME

    platform.configure_compile_cache()
    platform.measurement_device(args.platform)
    cfg = BenchConfig(
        M=args.M, K=args.K, N=args.N, s=args.s, prelu=args.prelu,
        correctness=args.correctness,
        kernels=args.kernels.split(",") if args.kernels else None)
    results = run_config(cfg)
    print(f"M={args.M} K={args.K} N={args.N} s={args.s} "
          f"prelu={args.prelu} correctness={args.correctness}")
    failed = False
    for r in results:
        if r.error:
            print(f"{r.name:28s} ERROR {r.error}")
            continue
        rf = r.roofline_fraction
        rf = f"{rf:6.1%}" if isinstance(rf, float) else rf
        line = (f"{r.name:28s} {r.seconds * 1e6:10.2f} us   "
                f"{r.gflops:9.2f} GF/s   OI {r.operational_intensity:7.4f}   "
                f"roofline {rf}")
        if r.speedup is not None:
            line += f"   speedup vs {BASELINE_KERNEL_NAME} {r.speedup:7.2f}x"
        if args.correctness:
            line += f"   correct={r.correct}"
            failed = failed or not r.correct
        print(line)
    # hard-exit on correctness failure like the reference (main.cpp:216-247)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
