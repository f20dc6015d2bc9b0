"""Native host core: bit-exactness vs numpy reference implementations.

The packers and TCSC builder must match formats/packed.py / formats/tcsc.py
bit-for-bit (the contract in ternary_spgemm_tpu/native.py); the generator is
checked for its distribution invariants (per-row counts, value domain,
determinism). All tests skip if the .so has not been built.
"""

import numpy as np
import pytest

from ternary_spgemm_tpu import native
from ternary_spgemm_tpu.formats import (
    PackedTernary2Bit,
    PackedTernary53,
    TCSC,
    generate_ternary,
)

pytestmark = pytest.mark.skipif(
    not native.native_available(), reason="native core not built (make -C native)")

SHAPES = [(16, 32), (128, 96), (100, 257), (1024, 512)]


@pytest.mark.parametrize("K,N", SHAPES)
def test_pack_2bit_bit_exact(K, N):
    W = generate_ternary(K, N, 4, seed=K + N)
    np.testing.assert_array_equal(native.pack_2bit(W),
                                  PackedTernary2Bit.from_dense(W).packed)


@pytest.mark.parametrize("K,N", SHAPES)
def test_pack_base3_bit_exact(K, N):
    W = generate_ternary(K, N, 4, seed=K + N)
    np.testing.assert_array_equal(native.pack_base3(W),
                                  PackedTernary53.from_dense(W).packed)


@pytest.mark.parametrize("K,N", SHAPES)
def test_tcsc_bit_exact(K, N):
    W = generate_ternary(K, N, 4, seed=K * 3 + N)
    ref = TCSC.from_dense(W)
    csp, csn, rip, rin, cip, cin = native.tcsc_arrays(W)
    np.testing.assert_array_equal(csp, ref.col_start_pos)
    np.testing.assert_array_equal(csn, ref.col_start_neg)
    np.testing.assert_array_equal(rip, ref.row_index_pos)
    np.testing.assert_array_equal(rin, ref.row_index_neg)
    np.testing.assert_array_equal(cip, ref.col_ids_pos)
    np.testing.assert_array_equal(cin, ref.col_ids_neg)


def test_gen_ternary_distribution():
    K, N, s = 256, 1024, 4
    W = native.gen_ternary(K, N, s, seed=7)
    assert W.shape == (K, N) and W.dtype == np.int8
    assert set(np.unique(W)) <= {-1, 0, 1}
    half = (N // s) // 2
    pos = (W == 1).sum(axis=1)
    neg = (W == -1).sum(axis=1)
    # limit_pos + limit_neg == 2*half exactly, per row (generate.py docstring)
    np.testing.assert_array_equal(pos + neg, 2 * half)
    vari_hi = N // s // 20 + 1
    assert (pos - half).min() >= 0 and (pos - half).max() <= vari_hi
    # determinism + seed sensitivity
    np.testing.assert_array_equal(W, native.gen_ternary(K, N, s, seed=7))
    assert (W != native.gen_ternary(K, N, s, seed=8)).any()


def test_gen_x_range_and_determinism():
    X = native.gen_x(64, 128, seed=3)
    assert X.shape == (64, 128) and X.dtype == np.float32
    assert X.min() >= -512 and X.max() <= 512
    assert np.all(X == np.round(X))
    np.testing.assert_array_equal(X, native.gen_x(64, 128, seed=3))


def test_pack_bitplane_matches_numpy():
    """Native bitplane packer == the numpy from_dense path, including
    K/N padding, over odd shapes."""
    from ternary_spgemm_tpu.formats.bitplane import TiledBitplane

    for (K, N, tkb, tn, seed) in [(64, 128, 4, 128, 0), (100, 200, 4, 128, 1),
                                  (257, 300, 8, 128, 2), (512, 512, 32, 256, 3)]:
        W = np.asarray(generate_ternary(K, N, 4, seed=seed))
        got = native.pack_bitplane(W, tkb, tn)
        assert got is not None
        # numpy reference: force the pure-numpy branch (small sizes do)
        ref = TiledBitplane.from_dense(W, tkb=tkb, tile_n=tn)
        np.testing.assert_array_equal(got, ref.plane)


def test_ell_deposit_arrays_match_numpy():
    """Native ELL-deposit packer == the numpy from_dense path (plane slot
    order, caps), incl. K/N padding and an empty-sign edge."""
    from ternary_spgemm_tpu.formats.ell_deposit import TiledEllDeposit

    cases = [(64, 128, 4, 128, 0), (300, 200, 2, 128, 1),
             (497, 300, 8, 128, 2), (992, 512, 16, 256, 3)]
    for (K, N, s, tn, seed) in cases:
        W = np.asarray(generate_ternary(K, N, s, seed=seed))
        got = native.ell_deposit_arrays(W, tn)
        assert got is not None
        plane, cp, cm = got
        ref = TiledEllDeposit.from_dense(W, tile_n=tn)
        np.testing.assert_array_equal(plane, ref.plane)
        np.testing.assert_array_equal(cp, ref.cap_pos)
        np.testing.assert_array_equal(cm, ref.cap_neg)
