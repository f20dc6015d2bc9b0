"""Registry-wide hostile-shape gate (VERDICT round-3 weak #5).

The reference's ``testMany`` loops exhaustively over small shapes
(``test_data_structure.cpp:76-145``); the round-3 registry gate ran every
kernel at exactly ONE friendly shape. Padding/alignment bugs in block index
maps and device decoders are exactly the class a shape fuzz catches, so every
registered kernel gates at a small battery of adversarial shapes (GPU-only
kernels in Pallas' interpreter):

* ``M=1`` — the sweep grid's smallest M (a single activation row);
* all-prime dims — nothing divides any tile, block, or packing factor;
* ``N`` smaller than one N-tile and not a multiple of 128;
* ``K`` smaller than one K-block (the grid's K axis degenerates);
* ``s=1`` — fully dense (both sign streams at maximum load, ELL caps = K).

Every case checks the fused-PReLU path too (the epilogue reads a second
operand whose padding must line up with the output tile).
"""

import numpy as np
import pytest

from ternary_spgemm_tpu import reference
from ternary_spgemm_tpu.formats import (
    BlockedEllTCSC,
    BlockedTCSC,
    EllTCSC,
    InterleavedBlockedTCSC,
    TiledBitplane,
    TiledEllDeposit,
    TiledEllTCSC,
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu.ops import all_kernels

# (M, K, N, s) — see module docstring for what each case attacks.
SHAPES = [
    pytest.param((1, 64, 128, 4), id="M1"),
    pytest.param((37, 131, 257, 4), id="prime-dims"),
    pytest.param((5, 96, 100, 2), id="N-lt-tile"),
    pytest.param((8, 24, 160, 4), id="K-lt-block"),
    pytest.param((16, 96, 160, 1), id="dense-s1"),
]

# Small-tile ctor kwargs (the test-scale BLOCK_SIZE analogues, as in
# tests/test_kernels.py).
_FMT_KWARGS = {
    BlockedTCSC: dict(block_size=32),
    InterleavedBlockedTCSC: dict(block_size=32, group=2),
    BlockedEllTCSC: dict(block_k=32, tile_n=128),
    EllTCSC: dict(tile_n=128),
    TiledEllTCSC: dict(block_k=31, tile_n=128),
    TiledBitplane: dict(tkb=32, tile_n=128),
    TiledEllDeposit: dict(tile_n=128),
}


@pytest.fixture(scope="module")
def problems():
    cache = {}

    def get(shape):
        if shape not in cache:
            M, K, N, s = shape
            W = generate_ternary(K, N, s, seed=sum(shape))
            X = generate_x(M, K, seed=sum(shape) + 1)
            cache[shape] = (W, X, generate_bias(N), generate_alpha(N))
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(all_kernels()))
def test_kernel_hostile_shape(problems, name, shape):
    spec = all_kernels()[name]
    W, X, b, alpha = problems(shape)
    if spec.x_absmax is not None and spec.x_absmax < 512:
        X = np.clip(X, -spec.x_absmax, spec.x_absmax)
    want = np.asarray(reference.dense_gemm_prelu(X, W, b, alpha))
    kwargs = dict(_FMT_KWARGS.get(spec.format_cls, {}))
    if "block_size" in kwargs and W.shape[0] % kwargs["block_size"]:
        # BlockedTCSC requires block_size | K (the reference asserts the
        # same, BlockedTCSC.h:5) — at prime K the only legal block is K
        # itself, which is its own hostile case (a single block).
        kwargs["block_size"] = W.shape[0]
    fmt = spec.format_cls.from_dense(W, **kwargs)
    fmt = fmt.prepare(X.shape[0])
    if spec.gpu_only:
        got = np.asarray(spec.fn(X, fmt, b, alpha, interpret=True))
    else:
        got = np.asarray(spec(X, fmt, b, alpha))
    assert got.shape == want.shape, name
    if spec.approximate:
        K, s = shape[1], shape[3]
        np.testing.assert_allclose(got, want, atol=2.0 * (K // s + 1),
                                   err_msg=name)
    else:
        res = reference.compare_results(got, want)
        assert res, f"{name} @ {shape}: {res}"


def test_triton_split_k_covers_every_block():
    """The Triton kernel's K-split: every K-block lands in exactly one
    split and no split is empty, for any block count and grid width."""
    from ternary_spgemm_tpu.ops.triton_bitplane import split_k

    for nb in range(1, 70):
        for programs in (1, 7, 25, 75, 300):
            splits, per = split_k(nb, programs)
            covered = [kb for s in range(splits)
                       for kb in range(s * per, min(nb, (s + 1) * per))]
            assert covered == list(range(nb)), (nb, programs)
            assert all(s * per < nb for s in range(splits)), (nb, programs)
