"""The platform module: backend, kernel choice by platform and rows, the
peak table, roofline shares, and the compile-cache placement."""

import os

import jax
import numpy as np
import pytest

from ternary_spgemm_tpu import platform
from ternary_spgemm_tpu.formats import TiledBitplane, generate_ternary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fmt():
    return TiledBitplane.from_dense(generate_ternary(300, 260, 2, seed=0))


def test_backend_is_cpu_here():
    assert platform.backend() == "cpu"


def test_unknown_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        platform.backend()


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.require_gpu()


def test_measurement_device_cpu_only_on_request():
    assert platform.measurement_device("cpu").platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        platform.measurement_device(None)


@pytest.mark.parametrize("M", [1, 64, 65, 2048])
def test_kernel_choice_by_platform_and_rows(monkeypatch, fmt, M):
    # on the CPU: always the XLA kernel
    assert platform.bitplane_a8_kernel(fmt, M) == "TiledBitplane_x8"
    # on a GPU: the fused Triton kernel at decode row counts only
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    want = ("TritonTiledBitplane_x8" if M <= platform.TRITON_BITPLANE_MAX_M
            else "TiledBitplane_x8")
    assert platform.bitplane_a8_kernel(fmt, M) == want


def test_kernel_choice_respects_layout(monkeypatch):
    """A layout the Triton kernel cannot take (K-block depth 16) falls back
    to the XLA kernel even on a GPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    small = TiledBitplane.from_dense(generate_ternary(64, 128, 2, seed=1),
                                     tkb=16)
    assert platform.bitplane_a8_kernel(small, 1) == "TiledBitplane_x8"


def test_triton_kernel_needs_gpu_unless_interpreted(fmt):
    from ternary_spgemm_tpu.ops.triton_bitplane import (
        triton_tiled_bitplane_x8_kernel)

    X = np.ones((2, 300), np.float32)
    b = np.zeros(260, np.float32)
    with pytest.raises(RuntimeError, match="only for a GPU"):
        triton_tiled_bitplane_x8_kernel(X, fmt, b)
    got = triton_tiled_bitplane_x8_kernel(X, fmt, b, interpret=True)
    assert got.shape == (2, 260)


def test_peak_table_h100():
    p = platform.peaks("NVIDIA H100 80GB HBM3")
    assert (p.hbm_bytes_per_s, p.bf16_flops, p.int8_ops, p.tf32_flops,
            p.fp32_flops) == (3.35e12, 989e12, 1979e12, 495e12, 67e12)
    assert "data sheet" in p.source


def test_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        platform.peaks("Unknown Card 9000")
    with pytest.raises(KeyError):
        platform.peaks("cpu")


def _inst():
    from ternary_spgemm_tpu.bench.instrument import instrument

    return instrument(8, TiledBitplane.from_dense(
        generate_ternary(64, 128, 2, seed=2)), x_bytes=1.0)


def test_roofline_share_not_measured_on_cpu():
    from ternary_spgemm_tpu.bench.instrument import (
        advertised_hbm_bandwidth, own_roofline_fraction, roofline_fraction)

    bw = advertised_hbm_bandwidth()
    assert bw is None
    assert roofline_fraction(_inst(), 1e-3, bw) == "not measured"
    assert own_roofline_fraction(_inst(), 1e-3, bw) == "not measured"


def test_roofline_share_on_a_card():
    from ternary_spgemm_tpu.bench.instrument import own_roofline_fraction

    inst = _inst()
    bw = platform.peaks("NVIDIA H100 80GB HBM3").hbm_bytes_per_s
    # twice the bandwidth floor -> share 0.5
    share = own_roofline_fraction(inst, 2 * inst.own_bytes / bw, bw)
    assert share == pytest.approx(0.5)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert platform.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = platform.configure_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the same path every call: no temporary name, pid or time in it
        assert platform.configure_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_is_git_ignored():
    rel = os.path.relpath(platform.DEFAULT_CACHE_DIR, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip().rstrip("/") for line in f}
    assert rel in ignored
