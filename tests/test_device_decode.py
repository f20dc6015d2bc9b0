"""The jittable device decoders of the tiled formats equal each format's
host ``to_dense`` (and the original matrix) at hostile shapes."""

import jax
import numpy as np
import pytest

from ternary_spgemm_tpu.formats import (
    BlockPackedTernary,
    TiledBitplane,
    TiledBlockPacked,
    TiledDenseTernary,
    TiledEllDeposit,
    TiledEllTCSC,
    TiledNibblePair,
    generate_ternary,
)
from ternary_spgemm_tpu.ops import tiled_kernels as tk

FORMATS = [
    pytest.param(TiledBitplane, {}, tk.decode_bitplane, id="bitplane"),
    pytest.param(TiledNibblePair, {}, tk.decode_nibble_pair, id="nibble"),
    pytest.param(BlockPackedTernary, dict(factor=5, tile_kq=16),
                 tk.decode_block_packed, id="blockpacked-base3"),
    pytest.param(TiledDenseTernary, dict(tile_k=32, tile_n=128),
                 tk.decode_tiled_dense, id="tileddense"),
    pytest.param(TiledBlockPacked, dict(tile_kq=8, tile_n=128),
                 tk.decode_tiled_block_packed, id="tiledblockpacked"),
    pytest.param(TiledEllTCSC, dict(block_k=31, tile_n=128),
                 tk.decode_tiled_ell, id="tiledell"),
    pytest.param(TiledEllDeposit, dict(tile_n=128), tk.decode_ell_deposit,
                 id="elldeposit"),
]

# (K, N, s): prime dims, one row, N below one tile, fully dense
SHAPES = [pytest.param((131, 257, 2), id="prime"),
          pytest.param((1, 130, 2), id="K1"),
          pytest.param((300, 60, 4), id="N-lt-tile"),
          pytest.param((64, 129, 1), id="dense")]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cls,kwargs,decoder", FORMATS)
def test_device_decode_matches_to_dense(cls, kwargs, decoder, shape):
    K, N, s = shape
    W = generate_ternary(K, N, s, seed=K * N)
    fmt = cls.from_dense(W, **kwargs)
    got = np.asarray(jax.jit(decoder)(fmt))
    np.testing.assert_array_equal(got, fmt.to_dense())
    np.testing.assert_array_equal(got, W)
