"""Stacked-regime marginal cost: the per-layer cost inside a deep program.

An isolated kernel call pays a per-dispatch floor that a bare XLA add also
pays. The deployed regime is an L-layer jitted program where ONE dispatch
carries many layers, so the honest per-layer number there is the MARGINAL
cost of one more layer in the chain: ``(t(L2) - t(L1)) / (L2 - L1)`` cancels
every fixed cost exactly. ``bench.py`` emits it as the ``stacked_*`` fields
of its one JSON line.

Reference counterpart: the reference has no dispatch floor to amortize —
its calibrated cycle timers (``cpp_impl/perf.cpp:45-68``) time a CPU loop
whose per-call overhead is a function call; both its number and this one
are "cost per layer in steady state".
"""

from __future__ import annotations

from typing import Optional, Sequence


def measure_stacked_marginal(M: int = 32, K: int = 1024, N: int = 4096,
                             s: int = 4, *,
                             kernel: Optional[str] = None,
                             depths: Sequence[int] = (8, 16),
                             repeats: int = 3,
                             bandwidth: Optional[float] = None) -> dict:
    """Measure the chained stack marginal at the given config. ``kernel``
    defaults to the platform's choice for int8 activations over
    ``TiledBitplane`` at ``M`` rows (:mod:`ternary_spgemm_tpu.platform`).

    Returns ``{stacked_marginal_seconds, stacked_spread, stacked_gflops,
    stacked_roofline_fraction, ...}`` where the roofline fraction divides
    the kernel-honest own-bytes ideal time by the measured marginal.
    """
    import jax
    import jax.numpy as jnp

    from ternary_spgemm_tpu import native, platform
    from ternary_spgemm_tpu.bench.instrument import (
        advertised_hbm_bandwidth, instrument, own_roofline_fraction)
    from ternary_spgemm_tpu.bench.timing import time_device_loop
    from ternary_spgemm_tpu.formats import (
        TiledBitplane, generate_bias, generate_ternary, generate_x)
    from ternary_spgemm_tpu.ops import all_kernels

    gen_w = native.gen_ternary if native.native_available() else \
        generate_ternary
    L_max = max(depths)
    fmts, biases = [], []
    fmt_host = None
    for i in range(L_max):
        W = gen_w(K, N, s, seed=300 + i)
        f = TiledBitplane.from_dense(W)
        if fmt_host is None:
            fmt_host = f
        fmts.append(jax.tree_util.tree_map(jnp.asarray, f))
        biases.append(jnp.asarray(generate_bias(N)))
    if kernel is None:
        kernel = platform.bitplane_a8_kernel(fmt_host, M)
    spec = all_kernels()[kernel]
    if spec.format_cls is not TiledBitplane:
        raise ValueError("stacked protocol is defined for the TiledBitplane "
                         f"serving format, got {kernel}")
    # the kernel's exact activation domain: |x| <= 127 for the _x8 kernels
    lim = float(spec.x_absmax or 512)
    X = jnp.clip(jnp.asarray(generate_x(M, K, seed=1)), -lim, lim)

    def make_chain(L):
        def fn(x, fmts_l, bs_l):
            cur = x
            y = None
            for i in range(L):
                y = spec.fn(cur, fmts_l[i], bs_l[i])
                # the clip keeps the next layer's input in the kernel's
                # exact domain; slice + clip is the glue a real serving
                # stack pays between layers
                cur = jnp.clip(y[:, :K], -lim, lim)
            return y
        return fn

    rows = {}
    for L in depths:
        r = time_device_loop(make_chain(L), X, aux=(fmts[:L], biases[:L]),
                             repeats=repeats)
        rows[L] = r
    L1, L2 = min(depths), max(depths)
    marginal = (rows[L2].seconds - rows[L1].seconds) / (L2 - L1)
    # conservative spread propagation: the pairwise-difference spread
    spread = (rows[L2].seconds * rows[L2].seconds_spread
              + rows[L1].seconds * rows[L1].seconds_spread) / max(
        rows[L2].seconds - rows[L1].seconds, 1e-30)
    inst = instrument(M, fmt_host, x_bytes=spec.x_bytes)
    beta = bandwidth or advertised_hbm_bandwidth()   # None on the CPU
    flops = M * N * (1 + K / s)
    return {
        "stacked_marginal_seconds": marginal,
        "stacked_spread": round(float(spread), 4),
        "stacked_depths": [int(L1), int(L2)],
        "stacked_gflops": round(flops / marginal / 1e9, 3),
        "stacked_roofline_fraction": own_roofline_fraction(
            inst, marginal, beta),
        "stacked_kernel": kernel,
        "stacked_rows": {str(L): {"seconds": rows[L].seconds,
                                  "seconds_spread": rows[L].seconds_spread,
                                  "n_estimates": rows[L].n_estimates}
                         for L in depths},
    }
