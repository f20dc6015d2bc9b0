"""Benchmark driver: correctness gate + calibrated timing per registered kernel.

Rebuild of the reference driver (``cpp_impl/main.cpp:35-296``):
build every container once from a single seeded W (``main.cpp:60-74``; format
construction deliberately outside the timed region, like the reference's
lambda-captured ``shared_ptr`` registry, ``main.cpp:76-81``), optionally gate
every kernel against the dense reference (``-correctness``,
``main.cpp:206-249``), then time each kernel calibrated
(``perf.cpp:298-339``) and report speedup vs ``BaseTCSC``
(``main.cpp:257-263``) plus the instrumented flops/bytes/OI quantities
(``main.cpp:264-271``). Results serialize to the reference sweep-JSON schema
(``plots/run_benchmark.py:44-47,103-107``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import jax
import numpy as np

from ternary_spgemm_tpu import platform, reference
from ternary_spgemm_tpu.bench.instrument import (
    Instrumentation,
    advertised_hbm_bandwidth,
    instrument,
    own_roofline_fraction,
    roofline_fraction,
)
from ternary_spgemm_tpu.bench.timing import TIMERS, TimingResult
from ternary_spgemm_tpu.formats import (
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu.ops import all_kernels
from ternary_spgemm_tpu.ops.api import BASELINE_KERNEL_NAME


@dataclasses.dataclass
class KernelResult:
    name: str
    seconds: float
    runs: int
    flops: int
    gflops: float                 # useful-adds throughput (reference convention)
    effective_gflops: float       # dense-equivalent 2MNK/t (BASELINE.json metric)
    nnz_per_s: float
    total_input_bytes: int
    operational_intensity: float
    #: of the card's memory bandwidth, reference byte formula ("not
    #: measured" on the CPU)
    roofline_fraction: object
    own_roofline_fraction: object = 0.0  # the same, kernel-honest bytes
    correct: Optional[bool] = None
    max_abs_err: Optional[float] = None
    speedup: Optional[float] = None
    error: Optional[str] = None   # sweep runners record per-config failures
                                  # instead of aborting (run_benchmark.py:46-105)
    seconds_spread: float = 0.0   # relative spread across independent slope
                                  # estimates (VERDICT round-3 weak #1)
    n_estimates: int = 1


@dataclasses.dataclass
class BenchConfig:
    M: int
    K: int
    N: int
    s: int
    prelu: bool = False
    seed: int = 0
    timer: str = "device_loop"
    min_seconds: float = 0.2
    correctness: bool = True
    kernels: Optional[Sequence[str]] = None  # None = whole registry
    #: independent slope estimates per kernel (median reported; the headline
    #: bench uses >= 3 so the scoreboard carries an error bar)
    repeats: int = 1


def _get_format(cache: Dict[type, object], format_cls, W, key=None):
    """Build (or reuse) one container per class, like the reference building
    every format once per binary invocation (main.cpp:60-74). Default ctor
    args play the role of the driver's fixed BLOCK_SIZE/UNROLL_FACTOR
    (main.cpp:7-8). Raises on incompatible shapes — callers record the error
    per kernel and keep sweeping. With a (K, N, s, seed) key, built
    containers also persist in the sweep-level cache so the canonical grid's
    M axis (8 M values per weight matrix) pays host-side construction once."""
    if key is not None:
        fkey = key + (format_cls,)
        if fkey not in _FMT_CACHE:
            _FMT_CACHE[fkey] = format_cls.from_dense(W)
        cache[format_cls] = _FMT_CACHE[fkey]
    if format_cls not in cache:
        cache[format_cls] = format_cls.from_dense(W)
    return cache[format_cls]


#: Sweep-level caches. The canonical grid (tools/sweep.py) iterates
#: (K, N) -> M -> s, so: weights cache per (K, N, s, seed) and containers per
#: (K, N, s, seed, cls) — both flushed when (K, N) changes (up to 4 s values
#: x formats alive at once); activations cache one (M, K, seed) entry.
#: Host-side generation + container construction dominate sweep setup time
#: (the reference builds formats once per binary invocation,
#: main.cpp:60-74).
_W_CACHE: Dict[tuple, object] = {}
_X_CACHE: Dict[tuple, object] = {}
_FMT_CACHE: Dict[tuple, object] = {}


def _cached_w(K, N, s, seed):
    key = (K, N, s, seed)
    if key not in _W_CACHE:
        if any(k[:2] != (K, N) for k in _W_CACHE):
            _W_CACHE.clear()
            _FMT_CACHE.clear()
        # Native Floyd-sampling generator when built (O(K*N/s) vs a full
        # argsort — the difference between seconds and tens of minutes at the
        # 11008^2 BitNet sweep shapes).
        from ternary_spgemm_tpu import native
        if native.native_available():
            _W_CACHE[key] = native.gen_ternary(K, N, s, seed=seed)
        else:
            _W_CACHE[key] = generate_ternary(K, N, s, seed=seed)
    return _W_CACHE[key]


def _cached_x(M, K, seed):
    key = (M, K, seed)
    if key not in _X_CACHE:
        _X_CACHE.clear()  # one entry: up to 4.2 GB at the grid corner
        from ternary_spgemm_tpu import native
        if native.native_available():
            _X_CACHE[key] = jax.numpy.asarray(native.gen_x(M, K, seed=seed))
        else:
            _X_CACHE[key] = jax.numpy.asarray(generate_x(M, K, seed=seed))
    return _X_CACHE[key]


def run_config(cfg: BenchConfig, *, bandwidth: Optional[float] = None,
               verbose: bool = False) -> List[KernelResult]:
    registry = all_kernels()
    if cfg.kernels is not None:
        registry = {n: registry[n] for n in cfg.kernels}
    elif platform.backend() != "gpu":
        registry = {n: s for n, s in registry.items() if not s.gpu_only}
    W = _cached_w(cfg.K, cfg.N, cfg.s, cfg.seed)
    X = _cached_x(cfg.M, cfg.K, cfg.seed + 1)
    b = generate_bias(cfg.N)
    alpha = generate_alpha(cfg.N) if cfg.prelu else None
    formats: Dict[type, object] = {}
    want = None
    if cfg.correctness:
        want = np.asarray(
            reference.dense_gemm_prelu(X, W, b, alpha) if cfg.prelu
            else reference.dense_gemm(X, W, b))
    beta = bandwidth if bandwidth is not None else advertised_hbm_bandwidth()
    timer = TIMERS[cfg.timer]

    # Restricted-domain kernels (x_absmax, e.g. int8-native _x8) run and
    # gate on X clamped INTO their domain — same X otherwise, so timings
    # stay comparable (values never affect runtime) while correctness is
    # checked against a reference on the clamped activations.
    _domain_cache: Dict[Optional[int], tuple] = {None: (X, want)}

    def _domain_inputs(absmax):
        if absmax is None or absmax >= 512:
            absmax = None
        if absmax not in _domain_cache:
            Xc = jax.numpy.clip(X, -absmax, absmax)
            wc = None
            if cfg.correctness:
                wc = np.asarray(
                    reference.dense_gemm_prelu(Xc, W, b, alpha) if cfg.prelu
                    else reference.dense_gemm(Xc, W, b))
            _domain_cache[absmax] = (Xc, wc)
        return _domain_cache[absmax]

    results: List[KernelResult] = []
    for name, spec in registry.items():
        inst = None
        try:
            fmt = _get_format(formats, spec.format_cls, W,
                              key=(cfg.K, cfg.N, cfg.s, cfg.seed))
            # Materialize any M-dependent derived views (e.g. TCSC's padded
            # gather tables for the chunked path) OUTSIDE the timed region,
            # like every other container array (main.cpp:60-81 convention).
            fmt = fmt.prepare(cfg.M)
            inst = instrument(cfg.M, fmt, prelu=cfg.prelu,
                              x_bytes=spec.x_bytes)
            # The container rides as a jit ARGUMENT (timer aux), never in a
            # closure: closure-captured leaves — numpy or device — inline as
            # HLO literals, whose bytes ship with every compile and key the
            # compile cache on the weight *values*, defeating it across the
            # sweep's s/W axis.
            fmt_dev = jax.tree_util.tree_map(jax.numpy.asarray, fmt)
            fn = lambda x, _fmt, _spec=spec: _spec.fn(x, _fmt, b, alpha)
            X_k, want_k = _domain_inputs(spec.x_absmax)
            correct = max_err = None
            if want_k is not None:
                got = np.asarray(jax.jit(fn)(X_k, fmt_dev))
                cmp = reference.compare_results(got, want_k)
                max_err = cmp.max_abs_err
                if spec.approximate:
                    # bf16 operands: per-term abs error <= |x|*2^-9 <= 1 over
                    # ~K/s terms per output (same bound as tests/test_kernels).
                    correct = max_err <= 4.0 * (cfg.K / cfg.s + 1)
                else:
                    correct = bool(cmp)
            t: TimingResult = timer(fn, X_k, aux=(fmt_dev,),
                                    min_seconds=cfg.min_seconds,
                                    repeats=cfg.repeats)
            results.append(KernelResult(
                name=name, seconds=t.seconds, runs=t.runs, flops=inst.flops,
                gflops=inst.flops / t.seconds / 1e9,
                effective_gflops=inst.dense_equiv_flops / t.seconds / 1e9,
                nnz_per_s=inst.nnz * cfg.M / t.seconds,
                total_input_bytes=inst.total_input_bytes,
                operational_intensity=inst.operational_intensity,
                roofline_fraction=roofline_fraction(inst, t.seconds, beta),
                own_roofline_fraction=own_roofline_fraction(inst, t.seconds,
                                                            beta),
                correct=correct, max_abs_err=max_err,
                seconds_spread=t.seconds_spread, n_estimates=t.n_estimates))
        except Exception as e:  # record, keep sweeping
            results.append(KernelResult(
                name=name, seconds=float("nan"), runs=0,
                flops=inst.flops if inst else 0,
                gflops=0.0, effective_gflops=0.0, nnz_per_s=0.0,
                total_input_bytes=inst.total_input_bytes if inst else 0,
                operational_intensity=inst.operational_intensity if inst else 0.0,
                roofline_fraction=0.0, error=f"{type(e).__name__}: {e}"))
        if verbose:
            r = results[-1]
            rf = r.roofline_fraction
            rf = f"{rf:6.1%}" if isinstance(rf, float) else rf
            status = r.error or (f"{r.seconds*1e6:9.2f} us  {r.gflops:8.2f} GF/s "
                                 f"(eff {r.effective_gflops:9.2f})  "
                                 f"roofline {rf}  correct={r.correct}")
            print(f"  {r.name:28s} {status}", flush=True)

    base = next((r for r in results if r.name == BASELINE_KERNEL_NAME
                 and not r.error), None)
    if base is not None:
        for r in results:
            if not r.error:
                r.speedup = base.seconds / r.seconds
    return results


def to_reference_json(cfg: BenchConfig, results: List[KernelResult]) -> dict:
    """Serialize to the reference sweep schema
    (``plots/run_benchmark.py:44-47,103-107``); ``performance`` is GFLOP/s of
    useful adds (the reference's flops/cycle re-based to wall time)."""
    test_case = {"M": cfg.M, "K": cfg.K, "N": cfg.N, "s": cfg.s}
    out = {}
    for r in results:
        if r.error:
            out[r.name] = {"error": r.error}
        else:
            out[r.name] = {
                "performance": r.gflops,
                "total_input_size": r.total_input_bytes,
                "operational_intensity": r.operational_intensity,
                "effective_gflops": r.effective_gflops,
                "nnz_per_s": r.nnz_per_s,
                "roofline_fraction": r.roofline_fraction,
                "own_roofline_fraction": r.own_roofline_fraction,
                "seconds": r.seconds,
                "seconds_spread": r.seconds_spread,
                "n_estimates": r.n_estimates,
                "speedup": r.speedup,
                "correct": r.correct,
            }
    return {"test_case": test_case, "results": out}


def dump_json(records: List[dict], path: str):
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
