"""Profiling, cost analysis, and memory accounting — the tracing tiers.

The reference has four observability tiers (SURVEY.md §5): (1) per-ISA cycle
timers (``tsc_x86.h``/``vct_arm.h``), (2) Apple PMU counters (``kperf.h``),
(3) compiled-in flop/byte instrumentation (``-DINSTRUMENTATION_RUN``),
(4) DynamoRIO cache simulation. The device equivalents, in the same order:

1/2. :func:`trace` — ``jax.profiler`` device traces (view in TensorBoard /
     Perfetto; includes per-kernel device time and copies), plus
     :func:`device_memory_stats` for live HBM accounting.
3.   Analytic instrumentation lives in ``bench/instrument.py`` (same
     formulas as the reference's ``main.cpp:264-271``).
4.   :func:`hlo_cost` and :func:`compiled_memory` — XLA's own cost model
     (flops, bytes accessed) and the compiled executable's memory breakdown
     (the role drcachesim played: where do the bytes move?).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a device trace under ``log_dir`` (tier-1/2 analogue).

    Example::

        with profiling.trace("/tmp/trace"):
            jax.block_until_ready(kernel(X, fmt, b))
    """
    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device=None) -> Dict[str, Any]:
    """Live device memory statistics (bytes in use, peak, limit) when the
    backend exposes them; {} otherwise."""
    dev = device or jax.devices()[0]
    try:
        return dict(dev.memory_stats() or {})
    except Exception:
        return {}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile()


def hlo_cost(fn, *args) -> Dict[str, float]:
    """XLA cost-analysis of ``jit(fn)(*args)``: flops, bytes accessed,
    transcendentals... The compiler's own view, to cross-check the analytic
    model in ``bench/instrument.py`` (tier-4 analogue)."""
    compiled = _compile(fn, *args)
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):  # older jax returns [dict]
        cost = cost[0] if cost else {}
    return dict(cost or {})


def compiled_memory(fn, *args) -> Dict[str, int]:
    """Compiled-executable memory breakdown (argument/output/temp/generated
    code sizes in bytes) — where the bytes live, the role the reference's
    cache simulation played."""
    compiled = _compile(fn, *args)
    try:
        m = compiled.memory_analysis()
    except Exception:
        return {}
    if m is None:
        return {}
    out = {}
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes"):
        v = getattr(m, k, None)
        if v is not None:
            out[k] = int(v)
    return out


def annotate(name: str):
    """Named-scope annotation so a region shows up in profiler traces."""
    return jax.named_scope(name)
