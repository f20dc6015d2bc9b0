"""Round-trip tests: dense -> format -> dense equality for every container.

The analogue of the reference's data-structure test harness
(``cpp_impl/test_data_structure.cpp:47-150``): exhaustive small grids x many
seeds (``testMany``) plus the canonical (K, N) x sparsity shapes
(``testRequired``, scaled to test-friendly sizes).
"""

import numpy as np
import pytest

from ternary_spgemm_tpu.formats import (
    TCSC,
    TCSR,
    BlockedEllTCSC,
    BlockedTCSC,
    BlockPackedTernary,
    EllTCSC,
    DenseTernary,
    InterleavedBlockedTCSC,
    InterleavedTCSC,
    PackedCSC,
    PackedTernary2Bit,
    PackedTernary53,
    TiledBitplane,
    TiledBlockPacked,
    TiledNibblePair,
    TiledDenseTernary,
    TiledEllDeposit,
    TiledEllTCSC,
    all_formats,
    generate_ternary,
    pack_signs_base3,
    unpack_signs_base3,
)

SIMPLE_FORMATS = [TCSC, TCSR, InterleavedTCSC, PackedCSC,
                  PackedTernary2Bit, PackedTernary53, BlockPackedTernary,
                  TiledDenseTernary, TiledBlockPacked,
                  EllTCSC, BlockedEllTCSC, TiledEllTCSC, TiledBitplane, TiledNibblePair,
                  TiledEllDeposit, DenseTernary]
BLOCKED_FORMATS = [BlockedTCSC, InterleavedBlockedTCSC]


def _roundtrip(fmt_cls, W, **kw):
    fmt = fmt_cls.from_dense(W, **kw)
    np.testing.assert_array_equal(fmt.to_dense(), W.astype(np.int8))
    assert fmt.shape == W.shape
    assert fmt.size_bytes() > 0
    assert fmt.nnz == int(np.count_nonzero(W))


@pytest.mark.parametrize("fmt_cls", SIMPLE_FORMATS)
@pytest.mark.parametrize("seed", range(5))
def test_small_roundtrip_many_seeds(fmt_cls, seed):
    # testMany analogue: small exhaustive-ish shapes, many seeds.
    for K, N in [(3, 4), (8, 8), (17, 33), (64, 40)]:
        for s in (2, 4):
            if N // s == 0:
                continue
            W = generate_ternary(K, N, s, seed=seed)
            _roundtrip(fmt_cls, W)


@pytest.mark.parametrize("fmt_cls", BLOCKED_FORMATS)
@pytest.mark.parametrize("seed", range(3))
def test_blocked_roundtrip(fmt_cls, seed):
    for K, N, B in [(32, 24, 8), (128, 64, 32), (64, 16, 64)]:
        for s in (2, 4):
            W = generate_ternary(K, N, s, seed=seed)
            _roundtrip(fmt_cls, W, block_size=B)


def test_interleaved_blocked_grouped_ctor():
    # Reference's second ctor: groups of UF/2 (driver UF=12 -> group 6).
    W = generate_ternary(128, 64, 2, seed=0)
    _roundtrip(InterleavedBlockedTCSC, W, block_size=32, group=6)


@pytest.mark.parametrize("fmt_cls", SIMPLE_FORMATS)
@pytest.mark.parametrize("s", [2, 4, 8, 16])
def test_required_shapes(fmt_cls, s):
    # testRequired analogue (test_data_structure.cpp:110-145), scaled down:
    # same aspect ratios, test-friendly sizes.
    for K, N in [(128, 512), (256, 128), (512, 256)]:
        W = generate_ternary(K, N, s, seed=42)
        _roundtrip(fmt_cls, W)


def test_blocked_requires_divisible_k():
    W = generate_ternary(100, 16, 2, seed=0)
    with pytest.raises(ValueError):
        BlockedTCSC.from_dense(W, block_size=32)


def test_blockpacked_base3_roundtrip():
    # factor=5 codec variant (default param covers factor=4)
    for K, N in [(100, 64), (2560, 128)]:
        W = generate_ternary(K, N, 4, seed=1)
        f = BlockPackedTernary.from_dense(W, factor=5, tile_kq=128)
        np.testing.assert_array_equal(f.to_dense(), W)
        assert f.size_bytes() == f.packed.size


def test_base3_codec_stream():
    rng = np.random.default_rng(0)
    for n in [0, 1, 4, 5, 6, 123]:
        signs = rng.integers(-1, 2, size=n).astype(np.int8)
        packed = pack_signs_base3(signs)
        assert packed.dtype == np.uint8
        np.testing.assert_array_equal(unpack_signs_base3(packed, n), signs)


def test_ell_padding_is_per_tile_not_global_tail():
    # The fix for VectorTCSC's over-padding (VectorTCSC.h:21): a dense first
    # tile must not inflate the capacity accounting of later sparse tiles.
    K, N, tile = 64, 256, 128
    W = np.zeros((K, N), np.int8)
    W[:, :tile] = 1            # first tile: full columns
    W[0, tile:] = 1            # later tiles: 1 nnz per column
    f = EllTCSC.from_dense(W, tile_n=tile, cap_align=8)
    assert f.tile_cap_pos[0] == 64
    assert f.tile_cap_pos[1] == 8
    # accounting must use per-tile caps
    assert f.size_bytes() < 4 * (64 * N * 2)


def test_format_registry_has_all():
    names = set(all_formats())
    assert {"TCSC", "TCSR", "BlockedTCSC", "BlockedEllTCSC",
            "InterleavedTCSC", "InterleavedBlockedTCSC", "EllTCSC",
            "PackedCSC", "PackedTernary2Bit", "PackedTernary53",
            "BlockPackedTernary", "DenseTernary", "TiledEllTCSC",
            "TiledBitplane", "TiledEllDeposit"} <= names


def test_formats_are_pytrees():
    import jax
    W = generate_ternary(32, 64, 4, seed=0)
    f = TCSC.from_dense(W)
    # the padded gather tables are lazy (ADVICE round 3): 6 leaves until
    # prepare()/with_ell_tables() materializes them (None = empty subtree)
    assert len(jax.tree_util.tree_leaves(f)) == 6
    fe = f.with_ell_tables()
    assert len(jax.tree_util.tree_leaves(fe)) == len(TCSC.ARRAY_FIELDS) == 8
    assert fe.ell_pos.shape[1] == f.N
    assert f.prepare(1) is f          # small M never needs the tables
    f2 = jax.tree_util.tree_map(lambda x: x, f)
    np.testing.assert_array_equal(f2.to_dense(), W)
    np.testing.assert_array_equal(fe.to_dense(), W)
