"""Calibrated timing for asynchronously dispatched device kernels.

The analogue of the reference's calibrated cycle timers
(``cpp_impl/perf.cpp:38-296``). The reference's protocol: run the kernel,
doubling ``num_runs`` until total >= CYCLES_REQUIRED = 1e8 cycles, then
re-time at the calibrated count and divide (``perf.cpp:28-29,45-68``). What
a device adds, and how this module handles it:

* **Async dispatch** — ``f(x)`` returns before the device runs, so every
  timed region ends with ``jax.block_until_ready`` on the result.
* **Dispatch overhead** — a Python-to-device round trip costs far more than
  a microsecond kernel. Two defenses: (a) the kernel runs inside an
  on-device ``lax.while_loop`` whose carry forces a serial dependency
  between iterations (a multiplicative ``* (1 + s*1e-45)`` perturbation of
  the carried input's FIRST ROW — a bit-exact no-op on the f32 values,
  including zeros, which an additive epsilon would corrupt — but opaque to
  XLA), amortizing one dispatch over the whole run; (b) the per-iteration
  time is the **slope** between a run of n and a run of n/2 iterations, so
  any fixed per-call overhead cancels exactly.
* **Compilation** — the first call compiles; the warm-up call excludes it,
  like the reference's warm-up loop (``perf.cpp:45-52``).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import jax
import jax.numpy as jnp

#: Calibration target for the (t(n) - t(n/2)) slope window — plays the role
#: of the reference's CYCLES_REQUIRED=1e8 (perf.cpp:28).
MIN_SECONDS = 0.2
#: Max calibrated runs (the reference caps at 2^14, perf.cpp:55; the slope
#: method needs headroom above the per-call overhead).
MAX_RUNS = 1 << 16


@dataclasses.dataclass(frozen=True)
class TimingResult:
    seconds: float       # per-invocation seconds (slope estimate)
    runs: int            # iterations of the larger calibrated run
    total_seconds: float # wall time of the larger calibrated run
    #: relative spread (max-min)/median across the independent estimates
    seconds_spread: float = 0.0
    n_estimates: int = 1


def _device_loop(fn: Callable) -> Callable:
    """Wrap ``(x, *aux) -> y`` into ``(x, n, aux) -> scalar`` running ``fn``
    n times on-device with a serializing carry dependency. ``aux`` rides as
    plain jit arguments: not carried, not perturbed — and not baked into the
    program (closure-captured arrays become HLO literals, whose bytes ship
    with every compile and key the compile cache on the *values*)."""

    @jax.jit
    def looped(x, n, aux):
        def cond(carry):
            i, _, _ = carry
            return i < n

        def body(carry):
            i, xc, s = carry
            # The barrier forces the FULL result buffer to materialize: only
            # one scalar of y is consumed below, and without the barrier XLA
            # fuses the slice into the producer and never writes the (M, N)
            # output, so the measurement would elide the output bytes.
            y = jax.lax.optimization_barrier(fn(xc, *aux))
            # Multiplicative perturbation: 1 + s*1e-45 rounds to exactly 1.0f
            # for any |s| < ~1e37, so xc is bit-identical every iteration
            # (including zero entries) — but s is dynamic, so XLA must still
            # re-run fn. Only the FIRST ROW is touched: the carried-buffer
            # dependency already serializes iterations, and an O(row) update
            # keeps the perturbation cost negligible for large activations.
            lead = (0,) * (xc.ndim - 1)
            row = jax.lax.dynamic_slice(
                xc, lead + (0,), (1,) * (xc.ndim - 1) + (xc.shape[-1],))
            row = jnp.asarray(row * (1.0 + s * 1e-45), xc.dtype)  # int x: exact
            xc = jax.lax.dynamic_update_slice(xc, row, lead + (0,))
            return i + 1, xc, s + jnp.asarray(y, jnp.float32).ravel()[0]

        return jax.lax.while_loop(cond, body, (jnp.int32(0), x, jnp.float32(0.0)))[2]

    return looped


def time_device_loop(fn: Callable, x, *, aux=(), min_seconds: float = MIN_SECONDS,
                     max_runs: int = MAX_RUNS, repeats: int = 1) -> TimingResult:
    """Calibrated on-device-loop slope timing of ``fn(x, *aux)``.

    The serializing carry perturbs only the FIRST ROW of ``x``, so a large
    activation matrix may ride as the carried input at O(row) overhead.
    Weight containers belong in ``aux``, never in a closure (closure-captured
    arrays inline as constants that ship with every compile). ``repeats``
    independent slope estimates give the spread; the median is reported.
    """
    looped = _device_loop(fn)
    jax.block_until_ready(looped(x, 1, aux))      # compile + warm-up

    def t_at(n):
        t0 = time.perf_counter()
        jax.block_until_ready(looped(x, n, aux))
        return time.perf_counter() - t0

    n = 2
    t_half, t_n = t_at(1), t_at(2)
    while (t_n - t_half) < min_seconds and n < max_runs:
        n *= 2
        t_half, t_n = t_n, t_at(n)

    def one_estimate(first=None):
        diffs = [] if first is None else [first]
        while len(diffs) < 3:
            diffs.append(t_at(n) - t_at(n // 2))
        return max(statistics.median(diffs), 0.0) / (n - n // 2)

    estimates = [one_estimate(first=t_n - t_half)]
    for _ in range(max(0, repeats - 1)):
        estimates.append(one_estimate())
    sec = statistics.median(estimates)
    spread = (max(estimates) - min(estimates)) / sec if sec > 0 else 0.0
    return TimingResult(seconds=sec, runs=n, total_seconds=t_n,
                        seconds_spread=spread, n_estimates=len(estimates))


def time_wall(fn: Callable, x, *, aux=(), min_seconds: float = MIN_SECONDS,
              max_runs: int = MAX_RUNS, repeats: int = 1) -> TimingResult:
    """Host-dispatch wall timing (includes per-call dispatch overhead).

    What a user sees calling the op once per step from Python — the honest
    number for end-to-end layer latency, vs :func:`time_device_loop` which
    is the honest number for kernel throughput. Each timed region ends with
    ``block_until_ready`` on the last result.
    """
    f = jax.jit(fn)
    jax.block_until_ready(f(x, *aux))             # compile + warm-up

    def t_at(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = f(x, *aux)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    n = 1
    t = t_at(n)
    while t < min_seconds and n < max_runs:
        n *= 2
        t = t_at(n)
    samples = [t] + [t_at(n) for _ in range(max(0, repeats - 1))]
    sec = statistics.median(samples) / n
    spread = ((max(samples) - min(samples)) / statistics.median(samples)
              if len(samples) > 1 else 0.0)
    return TimingResult(seconds=sec, runs=n, total_seconds=t,
                        seconds_spread=spread, n_estimates=len(samples))


TIMERS = {"device_loop": time_device_loop, "wall": time_wall}
