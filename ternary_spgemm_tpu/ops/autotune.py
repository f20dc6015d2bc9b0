"""Measured kernel selection: time the registered candidates once per
(shape, format, domain) and remember the winner.

The reference hardcodes its per-platform winner (the registration order in
``cpp_impl/main.cpp:76-190`` IS its dispatch policy, chosen by reading the
benchmark tables). Here the registry is larger and the best kernel genuinely
may shift with shape (decode-sized and prefill-sized row counts stress
different bounds), so selection is a measurement, not a lookup.

``autotune()`` times each candidate with the calibrated device loop and
memoizes per (backend, format, M/K/N, domain) — in-process plus an optional
JSON file so serving processes skip the probe entirely.
``ternary_spgemm(..., kernel="auto")`` routes through it.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import jax
import jax.numpy as jnp

from ternary_spgemm_tpu import platform

_CACHE: dict = {}
_LOCK = threading.Lock()


def _domain(X):
    """(absmax, integer_valued) of a concrete X — two on-device reductions
    and two SCALAR readbacks (never a full-array transfer). Tracers report
    the conservative full-f32 domain (only fully-exact kernels qualify)."""
    try:
        Xj = jnp.asarray(X)
        absmax = float(jnp.max(jnp.abs(Xj))) if Xj.size else 0.0
        integer = bool(jnp.all(Xj == jnp.round(Xj)))
        return absmax, integer
    except jax.errors.TracerArrayConversionError:
        return float("inf"), False


# the registered kernels' x_absmax tiers: the memo key buckets the
# activation absmax by the next tier up, so every batch in the same
# exactness domain reuses one probe (keying on the raw absmax would
# re-measure for every new batch)
_DOMAIN_TIERS = (127.0, 256.0, 512.0)


def _domain_bucket(absmax: float, integer: bool) -> float:
    if not integer:
        return float("inf")
    for t in _DOMAIN_TIERS:
        if absmax <= t:
            return t
    return float("inf")


def _key(fmt, M: int, absmax: float, integer: bool, prelu: bool):
    return (platform.backend(), type(fmt).__name__,
            M, fmt.K, fmt.N, _domain_bucket(absmax, integer), integer, prelu)


def candidates_for(fmt, absmax: float, integer: bool):
    """Registered kernels usable for this container and activation domain
    on this platform. Restricted-domain kernels (``x_absmax``) require
    integer-valued X within their bound (the exactness contract,
    ops/api.py); GPU-only kernels require a GPU."""
    from ternary_spgemm_tpu.ops.api import all_kernels

    on_gpu = platform.backend() == "gpu"
    out = []
    for spec in all_kernels().values():
        if not isinstance(fmt, spec.format_cls) or spec.approximate:
            continue
        if spec.gpu_only and not on_gpu:
            continue
        if spec.x_absmax is not None:
            if not integer or absmax > spec.x_absmax:
                continue
        out.append(spec)
    return out


def autotune(X, fmt, bias=None, alpha=None, *,
             min_seconds: float = 0.02,
             cache_path: Optional[str] = None,
             verbose: bool = False) -> str:
    """Return the fastest registered kernel name for ``X @ fmt`` (measured).

    X must be concrete (the probe runs real timings). Results memoize under
    (backend, format type, M, K, N, activation domain, prelu); pass
    ``cache_path`` to persist/reuse across processes.
    """
    import numpy as np

    from ternary_spgemm_tpu.bench.timing import time_device_loop
    from ternary_spgemm_tpu.formats import generate_bias

    if isinstance(X, jax.core.Tracer):
        raise ValueError("autotune needs a concrete X (got a tracer); "
                         "call it outside jit and pass kernel=<result> in")
    absmax, integer = _domain(X)
    key = _key(fmt, X.shape[0], absmax, integer, alpha is not None)
    skey = "|".join(map(str, key))

    with _LOCK:
        if key in _CACHE:
            if cache_path:   # write-through: persist memo hits too
                _write_disk(cache_path, skey, _CACHE[key])
            return _CACHE[key]
        if cache_path and os.path.exists(cache_path):
            try:
                disk = json.load(open(cache_path))
                if skey in disk:
                    _CACHE[key] = disk[skey]
                    return disk[skey]
            except Exception:
                pass

    cands = candidates_for(fmt, absmax, integer)
    if not cands:
        raise TypeError(f"no exact kernel for {type(fmt).__name__} on this "
                        f"activation domain (absmax={absmax}, int={integer})")
    b = (jnp.asarray(bias, jnp.float32) if bias is not None
         else jnp.asarray(generate_bias(fmt.N)))
    al = None if alpha is None else jnp.asarray(alpha, jnp.float32)
    Xa = jnp.asarray(X, jnp.float32)
    fmt_dev = jax.tree_util.tree_map(jnp.asarray, fmt)

    best, best_t = None, float("inf")
    for spec in cands:
        try:
            t = time_device_loop(
                lambda x, f, bb: spec(x, f, bb, al), Xa, aux=(fmt_dev, b),
                min_seconds=min_seconds)
            if verbose:
                print(f"autotune {spec.name}: {t.seconds * 1e6:.1f} us",
                      flush=True)
            if t.seconds < best_t:
                best, best_t = spec.name, t.seconds
        except Exception as e:
            if verbose:
                print(f"autotune {spec.name}: FAILED {e}", flush=True)

    if best is None:
        raise RuntimeError("every candidate kernel failed to run")
    with _LOCK:
        _CACHE[key] = best
        if cache_path:
            _write_disk(cache_path, skey, best)
    return best


def _write_disk(cache_path: str, skey: str, best: str):
    disk = {}
    if os.path.exists(cache_path):
        try:
            disk = json.load(open(cache_path))
        except Exception:
            disk = {}
    if disk.get(skey) == best:
        return
    disk[skey] = best
    tmp = cache_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(disk, f, indent=1)
    os.replace(tmp, cache_path)
