"""Bench harness tests: instrumentation math, timing plumbing, JSON schema."""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ternary_spgemm_tpu.bench import (
    BenchConfig,
    instrument,
    run_config,
    time_device_loop,
    time_wall,
    to_reference_json,
)
from ternary_spgemm_tpu import platform
from ternary_spgemm_tpu.formats import TCSC, generate_ternary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_instrumentation_formulas():
    M, K, N, s = 8, 64, 128, 4
    W = generate_ternary(K, N, s, seed=0)
    fmt = TCSC.from_dense(W)
    inst = instrument(M, fmt)
    nnz = int(np.count_nonzero(W))
    assert inst.nnz == nnz
    assert inst.flops == M * (nnz + N)                      # readme.md:84-85
    assert inst.total_input_bytes == 4 * (M * K + M * N + N) + fmt.size_bytes()
    # TCSC bytes: CSP+CSN (N+1 each) + RIP+RIN (nnz), 4B each (TCSC.h:41-48)
    assert fmt.size_bytes() == 4 * (2 * (N + 1) + nnz)
    # PReLU adds one alpha vector (main.cpp:289)
    assert instrument(M, fmt, prelu=True).total_input_bytes == \
        inst.total_input_bytes + 4 * N
    assert inst.operational_intensity == inst.flops / inst.total_input_bytes


def test_timers_agree_roughly():
    import jax.numpy as jnp
    x = jnp.ones((64, 64))
    f = lambda a: a * 2.0 + 1.0
    t1 = time_device_loop(f, x, min_seconds=0.02)
    t2 = time_wall(f, x, min_seconds=0.02)
    assert t1.seconds > 0 and t2.seconds > 0
    assert t1.runs >= 1 and t2.runs >= 1
    # device-loop timing excludes dispatch: never slower than wall x5 slack
    assert t1.seconds < t2.seconds * 5


def test_run_config_and_schema():
    cfg = BenchConfig(M=4, K=32, N=64, s=4, min_seconds=0.01,
                      kernels=["BaseTCSC", "DenseMXU"])
    results = run_config(cfg)
    assert {r.name for r in results} == {"BaseTCSC", "DenseMXU"}
    for r in results:
        assert r.error is None
        assert r.correct is True
        assert r.seconds > 0
        assert r.speedup is not None           # BaseTCSC present => speedups
    rec = to_reference_json(cfg, results)
    assert rec["test_case"] == {"M": 4, "K": 32, "N": 64, "s": 4}
    for v in rec["results"].values():
        assert {"performance", "total_input_size", "operational_intensity"} <= set(v)
    json.dumps(rec)  # serializable


def test_bench_cli_runs_small():
    out = subprocess.run(
        [sys.executable, "bench.py", "--M", "4", "--K", "64", "--N", "128",
         "--platform", "cpu", "--kernels", "BaseTCSC,DenseMXU"],
        capture_output=True, text=True, cwd=REPO, timeout=1200)
    lines = [l for l in out.stdout.strip().splitlines() if l.startswith("{")]
    assert lines, f"no JSON line in stdout: {out.stdout!r}\n{out.stderr[-800:]}"
    rec = json.loads(lines[-1])
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert rec["value"] > 0


@pytest.mark.parametrize("module", [
    "bench", "ternary_spgemm_tpu.__main__", "tools.sweep", "tools.model_bench"])
def test_measuring_entry_points_need_a_gpu(module, monkeypatch, capsys):
    """Without ``--platform cpu`` a measuring entry point refuses the host:
    it raises before it times anything and prints no result."""
    monkeypatch.setattr(platform, "configure_compile_cache", lambda: "")
    main = importlib.import_module(module).main
    with pytest.raises(RuntimeError, match="no GPU"):
        main([])
    assert "{" not in capsys.readouterr().out


def test_own_bytes_accounting():
    """Per-kernel activation byte widths (VERDICT.md round-2 weak #4): the
    own-bytes roofline charges the kernel's real X operand width, so the
    own fraction is <= the reference-formula fraction for sub-4-byte X."""
    from ternary_spgemm_tpu.bench.instrument import (
        own_roofline_fraction, roofline_fraction)
    from ternary_spgemm_tpu.ops import all_kernels

    M, K, N, s = 8, 64, 128, 4
    W = generate_ternary(K, N, s, seed=0)
    fmt = TCSC.from_dense(W)
    inst4 = instrument(M, fmt, x_bytes=4.0)
    inst2 = instrument(M, fmt, x_bytes=2.0)
    assert inst4.own_bytes == inst4.total_input_bytes
    assert inst4.own_bytes - inst2.own_bytes == 2 * M * K
    beta = 8.19e11
    assert own_roofline_fraction(inst2, 1e-5, beta) < \
        roofline_fraction(inst2, 1e-5, beta)
    reg = all_kernels()
    # int8-native kernels stream 1 B/element, f32 kernels 4 B
    assert reg["TritonTiledBitplane_x8"].x_bytes == 1.0
    assert reg["TiledBitplane_x8"].x_bytes == 1.0
    assert reg["TiledBitplane"].x_bytes == 4.0
    assert reg["DenseMXU_bf16"].x_bytes == 2.0
    assert reg["BaseTCSC"].x_bytes == 4.0


def test_stacked_marginal_protocol():
    """measure_stacked_marginal (bench/stacked.py): chained stacks at two
    depths, marginal = pairwise slope; schema carries spread, depths, the
    platform's kernel choice, and the own-bytes roofline fraction, which on
    the CPU reads "not measured"."""
    from ternary_spgemm_tpu.bench import measure_stacked_marginal

    r = measure_stacked_marginal(8, 128, 256, 4, depths=(1, 2), repeats=1)
    assert r["stacked_marginal_seconds"] > 0
    assert r["stacked_depths"] == [1, 2]
    assert r["stacked_kernel"] == "TiledBitplane_x8"
    assert r["stacked_roofline_fraction"] == "not measured"
    assert set(r["stacked_rows"]) == {"1", "2"}


def test_trace_validation_parser(tmp_path):
    """tools/trace_validation.py parse_perfetto on the names an H100 trace
    holds: kernels on the /device:GPU:0 process's "Stream #" threads,
    grouped by their hlo_module arg and by kernel name; host threads and
    host-side module spans ignored."""
    import gzip
    import os
    import sys as _sys

    _sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.trace_validation import parse_perfetto

    d = tmp_path / "plugins" / "profile" / "run1"
    os.makedirs(d)
    kernel_args = {"hlo_module": "jit_step", "hlo_op": "fusion.3",
                   "correlation_id": "7"}
    events = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "pid": 1, "tid": 13, "name": "thread_name",
         "args": {"name": "Stream #13(Compute,MemcpyD2D)"}},
        {"ph": "M", "pid": 1, "tid": 14, "name": "thread_name",
         "args": {"name": "Stream #14(MemcpyH2D)"}},
        {"ph": "M", "pid": 701, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 701, "tid": 5, "name": "thread_name",
         "args": {"name": "python"}},
        {"ph": "X", "pid": 1, "tid": 13, "name": "bitplane_x8", "ts": 0,
         "dur": 5.5, "args": kernel_args},
        {"ph": "X", "pid": 1, "tid": 13, "name": "input_reduce_fusion",
         "ts": 10, "dur": 1.5, "args": kernel_args},
        {"ph": "X", "pid": 1, "tid": 14, "name": "MemcpyH2D", "ts": 0,
         "dur": 2.0, "args": {"hlo_module": "jit_put"}},
        {"ph": "X", "pid": 701, "tid": 5, "name": "jit_step:XLA GPU module",
         "ts": 0, "dur": 99.0},
    ]
    with gzip.open(d / "perfetto_trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    parsed = parse_perfetto(str(tmp_path))
    assert parsed["modules"] == {"jit_step": [5.5, 1.5], "jit_put": [2.0]}
    assert parsed["ops"] == {"bitplane_x8": [5.5],
                             "input_reduce_fusion": [1.5],
                             "MemcpyH2D": [2.0]}
    assert "jit_step:XLA GPU module" not in parsed["ops"]
