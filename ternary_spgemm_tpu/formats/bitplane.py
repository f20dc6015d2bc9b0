"""Tile-contiguous split-sign bitplane container — 2 bits/weight.

The serving weight layout. The reference's roadmap codec packs ternary
values into a few bits each (``readme.md:108-111``); this layout keeps two
bits per weight and makes the decode a shift and a mask:

* Weights are stored as two **bitplanes** per K-block: byte-row ``t`` holds,
  in bit ``j``, the pos (resp. neg) flag of a dense row; 8 dense rows per
  byte, 2 bits per weight total across both planes.
* Bit ``j`` of byte-row ``t`` is dense row ``4t + j`` of the block for
  ``j < 4`` and ``4*tkb + 4t + (j - 4)`` for ``j >= 4`` (:func:`bitplane_rowmap`;
  the packer uses it and ``to_dense`` inverts it). So the low nibbles of a
  ``(tkb, N)`` slab expand, in order, to the block's first ``4*tkb`` rows,
  and the high nibbles to the rest.
* Each ``(K-block, N-tile)`` plane is contiguous in memory: one block of a
  kernel reads one contiguous slab.

The device decoder (``ops/tiled_kernels.decode_bitplane``) and the fused
Triton kernel (``ops/triton_bitplane.py``) rely on the same mapping.
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.utils import round_up


def bitplane_rowmap(tkb: int):
    """Dense-row -> (byte-row, bit) mapping of the decode pipeline.

    Decoded row r of a block of B = 8*tkb dense rows comes from:
      r <  4*tkb: byte-row t = r//4, bit j = r%4     (low-nibble deposit)
      r >= 4*tkb: t = (r-4*tkb)//4, j = (r-4*tkb)%4+4 (high-nibble deposit)

    """
    rt = np.empty(8 * tkb, np.int64)
    rj = np.empty(8 * tkb, np.int64)
    r = np.arange(8 * tkb)
    lo = r < 4 * tkb
    rt[lo] = r[lo] // 4
    rj[lo] = r[lo] % 4
    rh = r[~lo] - 4 * tkb
    rt[~lo] = rh // 4
    rj[~lo] = rh % 4 + 4
    return rt, rj


@register_format
class TiledBitplane(TernaryFormat):
    """Tile-contiguous pos/neg bitplanes."""

    ARRAY_FIELDS = ("plane",)

    plane: np.ndarray   # (nb, gn, 2*tkb, tile_n) uint8: pos rows then neg rows
    K: int
    N: int
    tkb: int            # byte-rows per block; block covers 8*tkb dense rows
    tile_n: int

    @classmethod
    def from_dense(cls, W: np.ndarray, tkb: int = 32,
                   tile_n: int = 128) -> "TiledBitplane":
        # Defaults: K-blocks of 8*32 = 256 dense rows and N-tiles of 128
        # columns. They bound the padding at 255 rows and 127 columns (the
        # BitNet-3B widths 3200/8640/9600 pad by at most 4%), and they are
        # the smallest blocks the fused Triton kernel takes: an int8 dot
        # wants a depth of 32, and its column block is 128 wide.
        W = _as_int8_dense(W)
        K, N = W.shape
        B = 8 * tkb
        tile_n = min(tile_n, round_up(N, 128))
        if K * N >= (1 << 20):
            # the native packer is much faster than the numpy path;
            # bit-exact equivalence property-tested in tests/test_native.py
            from ternary_spgemm_tpu import native
            plane = native.pack_bitplane(W, tkb, tile_n)
            if plane is not None:
                return cls(plane=plane, K=K, N=N, tkb=tkb, tile_n=tile_n)
        Kp, Np = round_up(K, B), round_up(N, tile_n)
        Wp = np.zeros((Kp, Np), np.int8)
        Wp[:K, :N] = W
        nb, gn = Kp // B, Np // tile_n
        Wb = Wp.reshape(nb, B, gn, tile_n)
        rt, rj = bitplane_rowmap(tkb)
        # scatter dense rows into (byte-row, bit) positions, vectorized over r
        pos = np.zeros((nb, tkb, gn, tile_n), np.uint8)
        neg = np.zeros((nb, tkb, gn, tile_n), np.uint8)
        for t in range(tkb):
            rows = np.nonzero(rt == t)[0]
            shifts = rj[rows]
            blk = Wb[:, rows]                       # (nb, 8, gn, tile_n)
            pos[:, t] = ((blk == 1).astype(np.uint8)
                         << shifts[None, :, None, None]).sum(axis=1)
            neg[:, t] = ((blk == -1).astype(np.uint8)
                         << shifts[None, :, None, None]).sum(axis=1)
        plane = np.ascontiguousarray(
            np.concatenate([pos, neg], axis=1).transpose(0, 2, 1, 3))
        return cls(plane=plane, K=K, N=N, tkb=tkb, tile_n=tile_n)

    @property
    def num_blocks(self) -> int:
        return self.plane.shape[0]

    def to_dense(self) -> np.ndarray:
        nb, gn, _, tn = self.plane.shape
        tkb = self.tkb
        both = self.plane.transpose(0, 2, 1, 3).reshape(nb, 2 * tkb, gn * tn)
        pos, neg = both[:, :tkb], both[:, tkb:]
        rt, rj = bitplane_rowmap(tkb)
        W = np.zeros((nb * 8 * tkb, gn * tn), np.int8)
        for r in range(8 * tkb):
            t, j = int(rt[r]), int(rj[r])
            p = (pos[:, t] >> j) & 1
            n = (neg[:, t] >> j) & 1
            # rows r, r+B, r+2B, ... = offset r of each block
            W[r::8 * tkb] = p.astype(np.int8) - n.astype(np.int8)
        return W[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.plane.size)

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class TiledNibblePair(TernaryFormat):
    """Tile-contiguous signed-nibble words — 4 bits/weight, half the decode ops.

    Trades 2x the plane bytes of :class:`TiledBitplane` for a cheaper
    decode. Each int32 word holds 8 weights as 4-bit two's-complement
    nibbles (+1 -> 0x1, -1 -> 0xF, 0 -> 0x0); decode is one mask (low
    nibbles), one shift+mask (high nibbles) and a sign-extend. Same
    reference lineage as TiledBitplane (the ``readme.md:108-111`` roadmap
    codec).

    Dense-row mapping (mirrors :func:`bitplane_rowmap` with nibbles for
    bits): decoded row r of a B = 8*tkb block comes from word row ``r // 4``
    byte ``r % 4`` — LOW nibble for r < 4*tkb, HIGH nibble (shifted) for
    r >= 4*tkb, like the bitplane halves.
    """

    ARRAY_FIELDS = ("words",)

    words: np.ndarray   # (nb, gn, tkb, tile_n) int32 nibble-pair words
    K: int
    N: int
    tkb: int            # word-rows per block; block covers 8*tkb dense rows
    tile_n: int

    @classmethod
    def from_dense(cls, W: np.ndarray, tkb: int = None,
                   tile_n: int = 4096) -> "TiledNibblePair":
        W = _as_int8_dense(W)
        K, N = W.shape
        if tkb is None:
            tkb = min(128, max(16, round_up(K, 128) // 8))
        B = 8 * tkb
        tile_n = min(tile_n, round_up(N, 128))
        Kp, Np = round_up(K, B), round_up(N, tile_n)
        Wp = np.zeros((Kp, Np), np.int8)
        Wp[:K, :N] = W
        nb, gn = Kp // B, Np // tile_n
        Wb = Wp.reshape(nb, B, gn, tile_n)
        H = 4 * tkb
        # 4-bit two's complement: -1 (0xFF as uint8) & 0xF = 0xF
        codes = Wb.view(np.uint8) & 0xF
        nib = codes[:, :H] | (codes[:, H:] << 4)        # (nb, H, gn, tn)
        # word row t, byte b <- nibble row 4t+b (little-endian)
        words = np.ascontiguousarray(
            nib.reshape(nb, tkb, 4, gn, tile_n).transpose(0, 3, 1, 4, 2))
        words = words.view(np.int32)[..., 0]            # (nb, gn, tkb, tn)
        return cls(words=words, K=K, N=N, tkb=tkb, tile_n=tile_n)

    @property
    def num_blocks(self) -> int:
        return self.words.shape[0]

    def to_dense(self) -> np.ndarray:
        nb, gn, tkb, tn = self.words.shape
        u8 = np.ascontiguousarray(self.words).view(np.uint8).reshape(
            nb, gn, tkb, tn, 4)
        # nibble row 4t+b = byte b of word row t
        nib = u8.transpose(0, 2, 4, 1, 3).reshape(nb, 4 * tkb, gn * tn)
        lo = (nib & 0xF).astype(np.int16)
        hi = (nib >> 4).astype(np.int16)
        sx = lambda v: (((v + 8) & 0xF) - 8).astype(np.int8)
        W = np.concatenate([sx(lo), sx(hi)], axis=1).reshape(-1, gn * tn)
        return W[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(4 * self.words.size)

    @property
    def shape(self):
        return (self.K, self.N)
