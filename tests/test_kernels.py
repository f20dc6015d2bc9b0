"""Correctness gate: every registered kernel vs the dense reference.

The analogue of the reference's ``-correctness`` path
(``cpp_impl/main.cpp:206-249``): build every format from one random W, run
every registered kernel, compare elementwise against the dense ``jnp`` GEMM
within the reference tolerance (abs 1e-5, ``sparseUtils.h:147``). Approximate
kernels (bf16 operands) get a relative tolerance instead. GPU-only kernels
(Pallas through Triton) run in Pallas' interpreter here.
"""

import numpy as np
import pytest

from ternary_spgemm_tpu import reference
from ternary_spgemm_tpu.formats import (
    BlockedEllTCSC,
    BlockedTCSC,
    DenseTernary,
    EllTCSC,
    InterleavedBlockedTCSC,
    InterleavedTCSC,
    PackedCSC,
    PackedTernary2Bit,
    PackedTernary53,
    TCSC,
    TCSR,
    TiledBitplane,
    TiledEllDeposit,
    TiledEllTCSC,
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu.ops import all_kernels

# Small enough to run the whole registry quickly on CPU (Pallas in interpret
# mode), large enough to exercise multi-tile grids in every dimension.
M, K, N, S = 40, 96, 160, 4

# Format construction kwargs sized for the test shapes (the driver's
# BLOCK_SIZE=512 analogue, main.cpp:7).
_FMT_KWARGS = {
    BlockedTCSC: dict(block_size=32),
    InterleavedBlockedTCSC: dict(block_size=32, group=2),
    BlockedEllTCSC: dict(block_k=32, tile_n=128),
    EllTCSC: dict(tile_n=128),
    TiledEllTCSC: dict(block_k=31, tile_n=128),
    TiledBitplane: dict(tkb=32, tile_n=128),
    TiledEllDeposit: dict(tile_n=128),
}


def _build(format_cls, W):
    return format_cls.from_dense(W, **_FMT_KWARGS.get(format_cls, {}))


def run_kernel(spec, X, fmt, b, alpha=None):
    """Call a registered kernel; GPU-only kernels run interpreted."""
    if spec.gpu_only:
        return spec.fn(X, fmt, b, alpha, interpret=True)
    return spec(X, fmt, b, alpha)


@pytest.fixture(scope="module")
def problem():
    W = generate_ternary(K, N, S, seed=7)
    X = generate_x(M, K, seed=8)
    b = generate_bias(N)
    alpha = generate_alpha(N)
    want = np.asarray(reference.dense_gemm(X, W, b))
    want_prelu = np.asarray(reference.dense_gemm_prelu(X, W, b, alpha))
    return W, X, b, alpha, want, want_prelu


def _domain_inputs(problem, spec):
    """Restricted-domain kernels (x_absmax, e.g. the int8-native _x8 paths)
    gate on activations clamped INTO their domain, against a reference
    computed on the same clamped X (the harness does the same)."""
    W, X, b, alpha, want, want_prelu = problem
    if spec.x_absmax is not None and spec.x_absmax < 512:
        X = np.clip(X, -spec.x_absmax, spec.x_absmax)
        want = np.asarray(reference.dense_gemm(X, W, b))
        want_prelu = np.asarray(reference.dense_gemm_prelu(X, W, b, alpha))
    return W, X, b, alpha, want, want_prelu


@pytest.mark.parametrize("name", sorted(all_kernels()))
def test_kernel_matches_dense_reference(problem, name):
    spec = all_kernels()[name]
    W, X, b, alpha, want, _ = _domain_inputs(problem, spec)
    fmt = _build(spec.format_cls, W)
    got = np.asarray(run_kernel(spec, X, fmt, b))
    if spec.approximate:
        # bf16 operands: per-term abs error <= |x|*2^-9 <= 1, f32 accumulate
        # => bound = nnz-per-column ~= K/S terms of error 1 each.
        np.testing.assert_allclose(got, want, atol=2.0 * (K // S))
    else:
        res = reference.compare_results(got, want)
        assert res, f"{name}: {res}"


@pytest.mark.parametrize("name", sorted(all_kernels()))
def test_kernel_fused_prelu(problem, name):
    spec = all_kernels()[name]
    W, X, b, alpha, _, want_prelu = _domain_inputs(problem, spec)
    fmt = _build(spec.format_cls, W)
    got = np.asarray(run_kernel(spec, X, fmt, b, alpha))
    if spec.approximate:
        np.testing.assert_allclose(got, want_prelu, atol=2.0 * (K // S))
    else:
        res = reference.compare_results(got, want_prelu)
        assert res, f"{name}: {res}"


@pytest.mark.parametrize("m", [1, 3, 32])
def test_north_star_shape_small_m(m):
    """M=1 row (the reference sweep's smallest M) through the default path."""
    W = generate_ternary(64, 256, 4, seed=3)
    X = generate_x(m, 64, seed=4)
    b = generate_bias(256)
    want = np.asarray(reference.dense_gemm(X, W, b))
    for cls in (TCSC, DenseTernary, PackedTernary53):
        spec = next(s for s in all_kernels().values()
                    if s.format_cls is cls and not s.approximate)
        got = np.asarray(spec(X, cls.from_dense(W), b))
        assert reference.compare_results(got, want), spec.name


def test_default_dispatch_is_safe_and_exact():
    """Default ternary_spgemm dispatch must pick a fully-exact float32
    kernel: never an approximate, restricted-domain (_x8) or GPU-only one."""
    from ternary_spgemm_tpu.formats import BlockPackedTernary
    from ternary_spgemm_tpu.ops import ternary_spgemm

    W = generate_ternary(64, 128, 4, seed=9)
    b = generate_bias(128)
    # non-integer activations: the default path must stay exact
    X_float = generate_x(4, 64, seed=10) + 0.25
    want = np.asarray(reference.dense_gemm(X_float, W, b))
    got = np.asarray(ternary_spgemm(X_float, DenseTernary.from_dense(W), b))
    assert reference.compare_results(got, want)
    # formats with restricted or GPU-only kernels too: the exact one wins
    for cls in (BlockPackedTernary, TiledBitplane):
        got_i = np.asarray(ternary_spgemm(X_float, cls.from_dense(W), b))
        assert reference.compare_results(got_i, want), cls.__name__


def test_empty_column_and_row():
    """Columns/rows with no nonzeros must still produce bias-only outputs."""
    W = np.zeros((32, 64), np.int8)
    W[0, 0] = 1
    W[5, 1] = -1
    # value_range inside every kernel's activation domain (incl. _x8 |x|<=127)
    X = generate_x(4, 32, seed=0, value_range=127)
    b = generate_bias(64)
    want = np.asarray(reference.dense_gemm(X, W, b))
    for name, spec in all_kernels().items():
        if spec.approximate:
            continue
        fmt = _build(spec.format_cls, W)
        got = np.asarray(run_kernel(spec, X, fmt, b))
        assert reference.compare_results(got, want), name


def test_basetcsc_chunked_matches_unchunked(monkeypatch):
    """The M-chunked BaseTCSC path (sweep feasibility at every canonical
    config, VERDICT.md round-2 missing #4) is bit-identical to the direct
    segment-sum formulation."""
    import jax.numpy as jnp

    from ternary_spgemm_tpu.ops import xla_kernels

    W = generate_ternary(K, N, S, seed=11)
    X = jnp.asarray(generate_x(M, K, seed=12))
    b = generate_bias(N)
    a = generate_alpha(N)
    fmt = TCSC.from_dense(W)
    direct = np.asarray(xla_kernels.tcsc_kernel(X, fmt, b, a))
    # force chunking with MC > 1 and an M remainder (M=40, MC=ceil)
    nnz = int(np.count_nonzero(W))
    monkeypatch.setattr(xla_kernels, "_GATHER_CHUNK_FLOATS", 7 * nnz)
    chunked = np.asarray(xla_kernels.tcsc_kernel(X, fmt, b, a))
    np.testing.assert_array_equal(direct, chunked)
    # and MC == 1 (nnz exceeds the budget entirely)
    monkeypatch.setattr(xla_kernels, "_GATHER_CHUNK_FLOATS", 1)
    np.testing.assert_array_equal(
        direct, np.asarray(xla_kernels.tcsc_kernel(X, fmt, b, a)))


@pytest.mark.parametrize("M_big", [200, 300])
def test_bitplane_family_unstacked_large_m(M_big):
    """Prefill-sized M: several row blocks of the Triton grid (interpreted),
    and the XLA kernels, with the PReLU epilogue."""
    import jax.numpy as jnp

    from ternary_spgemm_tpu.ops import all_kernels

    W = generate_ternary(K, N, S, seed=21)
    Xb = jnp.asarray(generate_x(M_big, K, seed=22))
    b = generate_bias(N)
    a = generate_alpha(N)
    fmt = _build(TiledBitplane, W)
    want = np.asarray(Xb, np.float64) @ np.asarray(W, np.float64) \
        + np.asarray(b)[None, :]
    want = np.where(want > 0, want, np.asarray(a)[None, :] * want)
    reg = all_kernels()
    for name in ("TritonTiledBitplane_x8", "TiledBitplane_x8",
                 "TiledBitplane"):
        lim = reg[name].x_absmax or 512
        Xk = jnp.clip(Xb, -lim, lim)
        wk = np.asarray(Xk, np.float64) @ np.asarray(W, np.float64) \
            + np.asarray(b)[None, :]
        wk = np.where(wk > 0, wk, np.asarray(a)[None, :] * wk)
        got = np.asarray(run_kernel(reg[name], Xk, fmt, b, a))
        np.testing.assert_allclose(got, wk, atol=1e-5, err_msg=name)
