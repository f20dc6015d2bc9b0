"""Sweep-runner grid construction and JSON schema (no benchmarks run)."""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import sweep  # noqa: E402
import sweep_sanitize  # noqa: E402


def _args(**kw):
    defaults = dict(preset=None, varyonly=None, sparsityonly=False,
                    m_values=None, kn=None, s_values=None)
    defaults.update(kw)
    return argparse.Namespace(**defaults)


def test_canonical_grid_matches_reference():
    grid = list(sweep.build_grid(_args()))
    # 8 M x 8 (K,N) x 4 s (run_benchmark.py:13-24)
    assert len(grid) == 8 * 8 * 4
    assert (1, 512, 2048, 2) in grid
    assert (64000, 16384, 4096, 16) in grid
    # s varies innermost (X cache hits across sparsities), M next (W and
    # container caches hit across the M axis) — set identical to the
    # reference grid, order optimized for the host-side caches.
    s0 = grid[:4]
    assert [g[3] for g in s0] == [2, 4, 8, 16]
    assert all(g[:3] == s0[0][:3] for g in s0)
    m8 = [g[0] for g in grid[::4][:8]]
    assert m8 == [1, 16, 64, 256, 1000, 4000, 16000, 64000]


def test_varyonly_grid():
    grid = list(sweep.build_grid(_args(varyonly="K", s_values=[4])))
    assert all(m == 1024 and n == 1024 and s == 4 for m, _, n, s in grid)
    assert [k for _, k, _, _ in grid] == sweep.VARY_DIM_VALUES


def test_sparsityonly_grid():
    grid = list(sweep.build_grid(_args(sparsityonly=True)))
    assert grid == [(1024, 1024, 1024, s) for s in (2, 4, 8, 16)]


def test_bitnet_preset():
    grid = list(sweep.build_grid(_args(preset="bitnet")))
    assert len(grid) == 2 * 4 * 3
    assert (1, 4096, 4096, 2) in grid
    assert (512, 11008, 11008, 16) in grid


def test_sanitize_scrubs_impossible_measurements():
    def rec(m, **res):
        return {"test_case": {"M": m, "K": 512, "N": 2048, "s": 4},
                "results": {"X": dict(res)}}

    records = [
        rec(1, seconds=1e-5, roofline_fraction=0.8),       # sane
        rec(16, seconds=6.25e-11, roofline_fraction=0.1),  # picosecond garbage
        rec(64, seconds=1e-5, roofline_fraction=1.11),     # above HBM roofline
        # documented skips/errors are NOT measurements; never scrubbed
        {"test_case": {"M": 256, "K": 512, "N": 2048, "s": 4},
         "results": {"X": {"error": "skipped: gather too big"}}},
    ]
    kept, scrubbed = sweep_sanitize.scan(records, min_seconds=1e-7,
                                         max_roofline=1.05)
    assert [r["test_case"]["M"] for r in kept] == [1, 256]
    assert sorted(r["test_case"]["M"] for r, _ in scrubbed) == [16, 64]
    reasons = {r["test_case"]["M"]: why for r, why in scrubbed}
    assert "seconds" in reasons[16][0] and "roofline" in reasons[64][0]


def test_sweep_cli_smoke(tmp_path):
    out_path = str(tmp_path / "out.json")
    out = subprocess.run(
        [sys.executable, "tools/sweep.py", "--m-values", "4", "--kn", "32x64",
         "--s-values", "4", "--kernels", "DenseMXU", "--platform", "cpu",
         "--min-seconds", "0.01", "--output", out_path],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert "wrote 1 records" in out.stdout, out.stdout + out.stderr[-500:]
    recs = json.load(open(out_path))
    assert recs[0]["test_case"] == {"M": 4, "K": 32, "N": 64, "s": 4}
    assert "DenseMXU" in recs[0]["results"]


def test_model_bench_cli_smoke(tmp_path):
    """tools/model_bench.py runs all three regimes on the tiny preset."""
    out_path = str(tmp_path / "mb.json")
    out = subprocess.run(
        [sys.executable, "tools/model_bench.py", "--preset", "test",
         "--format", "TiledBitplane", "--platform", "cpu",
         "--min-seconds", "0.01", "--kernels", "TiledBitplane",
         "--output", out_path],
        capture_output=True, text=True, cwd=REPO, timeout=900)
    res = json.load(open(out_path))["results"]
    assert res["qat_train_step"]["seconds"] > 0, out.stdout + out.stderr[-500:]
    assert res["qat_forward"]["seconds"] > 0
    assert res["exported/TiledBitplane"]["seconds"] > 0
    assert res["a8_block"]["seconds"] > 0
