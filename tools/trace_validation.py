#!/usr/bin/env python
"""Device time from a ``jax.profiler`` trace of a GPU run.

Wall-clock slopes (``bench/timing.py``) time a call from the host; this
reduces the profiler's perfetto trace to what ran on the card. In a trace
taken on an NVIDIA GPU (read by hand from an H100 run):

* the device is the process named ``/device:GPU:<n>``; the host is
  ``/host:CPU``;
* every kernel and device copy is an event on one of the device's threads
  named ``Stream #<n>(...)``, and its ``args`` carry the XLA module
  (``hlo_module``, e.g. ``jit_step``) and the HLO op (``hlo_op``) it
  belongs to; the event's name is the kernel's (a fusion, a cuBLAS or Triton
  GEMM, or a Pallas kernel under its ``name=``);
* host threads hold the Python and runtime spans (``<module>:XLA GPU
  module``, ``PjitFunction(...)``), which this reducer ignores.

:func:`parse_perfetto` returns the device events grouped by module and by
kernel name; :func:`traced_device_us` traces ``runs`` calls of a jitted
function and reports its device time per call (the sum of its kernels'
durations, so gaps between kernels do not count).

Usage from Python on the card::

    from tools.trace_validation import traced_device_us
    r = traced_device_us(fn, args, runs=20)
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

TRACE_RUNS = 20


def parse_perfetto(log_dir: str) -> dict:
    """Device events of the newest perfetto trace under ``log_dir``:
    ``{"modules": {hlo_module: [us, ...]}, "ops": {kernel: [us, ...]}}``,
    one duration per kernel event on the GPU's stream threads."""
    paths = sorted(glob.glob(os.path.join(
        log_dir, "plugins", "profile", "*", "perfetto_trace.json.gz")))
    if not paths:
        raise FileNotFoundError(f"no perfetto trace under {log_dir}")
    with gzip.open(paths[-1]) as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    proc_name, thread_name = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            proc_name[e["pid"]] = e["args"]["name"]
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            thread_name[(e["pid"], e["tid"])] = e["args"]["name"]
    modules, ops = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if not proc_name.get(e.get("pid"), "").startswith("/device:GPU"):
            continue
        if not thread_name.get((e.get("pid"), e.get("tid")), "").startswith(
                "Stream #"):
            continue
        dur = float(e["dur"])
        module = e.get("args", {}).get("hlo_module", "")
        modules.setdefault(module, []).append(dur)
        ops.setdefault(e["name"], []).append(dur)
    return {"modules": modules, "ops": ops}


def traced_device_us(fn, args, *, runs: int = TRACE_RUNS,
                     top: int = 8) -> dict:
    """Trace ``runs`` calls of jitted ``fn(*args)``; return its device time
    per call in microseconds and the ``top`` kernels by total time."""
    import jax

    jf = jax.jit(fn)
    jax.block_until_ready(jf(*args))         # compile + warm outside trace
    tmp = tempfile.mkdtemp(prefix="tv_trace_")
    try:
        jax.profiler.start_trace(tmp, create_perfetto_trace=True)
        r = None
        for _ in range(runs):
            r = jf(*args)
        jax.block_until_ready(r)
        jax.profiler.stop_trace()
        parsed = parse_perfetto(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not parsed["modules"]:
        return {"device_us": None, "n_events": 0, "ops_us": {}}
    # the traced function's module holds the most device time
    name, durs = max(parsed["modules"].items(), key=lambda kv: sum(kv[1]))
    ops = sorted(parsed["ops"].items(), key=lambda kv: -sum(kv[1]))[:top]
    return {"module": name, "n_events": len(durs),
            "device_us": float(np.sum(durs)) / runs,
            "ops_us": {k: {"total_us_per_call": float(np.sum(v)) / runs,
                           "count": len(v)} for k, v in ops}}
