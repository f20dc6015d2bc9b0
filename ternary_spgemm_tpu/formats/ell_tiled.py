"""Tile-contiguous blocked-ELL container with exact per-tile capacities.

A tile-contiguous variant of :class:`BlockedEllTCSC`:

* **Tile-contiguous planes.** The plane is 4-D ``(nb, gn, CAPS, TN)`` so one
  (K-block, N-tile) is one contiguous ``CAPS*TN``-byte read, instead of
  ``CAPS`` strided ``TN``-byte strips of an ``(nb, CAP, N_pad)`` layout.
* **Exact per-tile capacities.** ``cap_pos/cap_neg`` hold the exact
  per-(K-block, N-tile) capacity, for byte accounting and loop bounds.
  ``size_bytes`` reports the *physical* array (global-cap padded).

Layout details:

* A K-block covers ``block_k = 127`` dense rows. The padding sentinel is
  local offset ``block_k`` — a *valid* index into a block-local X slice with
  one appended zero column, so padded slots contribute 0 with no mask (the
  reference's VectorTCSC resolves its -1 sentinels by writing ``X[-1] = 0``
  — UB, ``comp.h:1078``; this is the sound rendering of the same idea).
* Pos and neg offsets share one plane: rows ``[0, cap_p_max)`` are pos,
  ``[cap_p_max, cap_p_max + cap_n_max)`` neg.

The device decoder (``ops/tiled_kernels.decode_tiled_ell``) expands the
planes into the dense ternary matrix for an exact dot.

Reference analogue: ``cpp_impl/data_structures/VectorTCSC.h:5-73`` (padded
ELL for branch-free SIMD) with the per-tile capacity scan done right
(``VectorTCSC.h:21`` over-pads to the max of all *remaining* columns).
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.utils import cdiv, round_up


@register_format
class TiledEllTCSC(TernaryFormat):
    """Tile-contiguous split-sign ELL with exact per-tile capacities."""

    ARRAY_FIELDS = ("plane", "cap_pos", "cap_neg")

    plane: np.ndarray     # (nb, gn, CAPS, TN) int8 local offsets; sentinel=block_k
    cap_pos: np.ndarray   # (nb, gn) int32 exact per-(block, tile) capacity
    cap_neg: np.ndarray   # (nb, gn) int32
    K: int
    N: int
    block_k: int          # dense rows per block (offset block_k = empty)
    tile_n: int
    cap_p_max: int        # static row where the neg half of the plane starts

    @classmethod
    def from_dense(cls, W: np.ndarray, block_k: int = 127,
                   tile_n: int = 512) -> "TiledEllTCSC":
        if not 0 < block_k <= 127:
            raise ValueError(
                f"block_k={block_k}: local offsets plus the sentinel "
                "must fit 128 values")
        W = _as_int8_dense(W)
        K, N = W.shape
        nb = cdiv(K, block_k)
        tile_n = min(tile_n, round_up(N, 128))
        if tile_n % 128:
            raise ValueError(
                f"tile_n={tile_n} must be a multiple of 128 (the kernel "
                "gathers in 128-lane register chunks)")
        Np = round_up(N, tile_n)
        gn = Np // tile_n

        def planes(value):
            mask = np.zeros((nb * block_k, Np), bool)
            mask[:K, :N] = (W == value)
            m3 = mask.reshape(nb, block_k, Np)
            counts = m3.sum(axis=1, dtype=np.int32)             # (nb, Np)
            caps = counts.reshape(nb, gn, tile_n).max(axis=2)   # (nb, gn)
            # Section size rounded to 8 slot-rows; rows past the exact cap
            # are sentinels and contribute nothing.
            cap = max(round_up(int(caps.max()), 8), 8)
            slot3 = m3.cumsum(axis=1, dtype=np.int32) - 1
            b_idx, r_idx, n_idx = np.nonzero(m3)
            idx = np.full((nb, cap, Np), block_k, dtype=np.int8)
            idx[b_idx, slot3[b_idx, r_idx, n_idx], n_idx] = r_idx.astype(np.int8)
            return idx, caps

        ip, cp = planes(1)
        im, cm = planes(-1)
        cap_p_max = ip.shape[1]
        both = np.concatenate([ip, im], axis=1)  # (nb, CAPS, Np)
        plane = np.ascontiguousarray(
            both.reshape(nb, both.shape[1], gn, tile_n).transpose(0, 2, 1, 3))
        return cls(plane=plane, cap_pos=cp, cap_neg=cm, K=K, N=N,
                   block_k=block_k, tile_n=tile_n, cap_p_max=cap_p_max)

    @property
    def num_blocks(self) -> int:
        return self.plane.shape[0]

    @property
    def num_tiles(self) -> int:
        return self.plane.shape[1]

    @property
    def cap_n_max(self) -> int:
        return self.plane.shape[2] - self.cap_p_max

    def to_dense(self) -> np.ndarray:
        nb, gn, CAPS, TN = self.plane.shape
        flat = self.plane.transpose(0, 2, 1, 3).reshape(nb, CAPS, gn * TN)
        W = np.zeros((nb * self.block_k, gn * TN), np.int8)
        for b in range(nb):
            base = b * self.block_k
            for lo, hi, v in ((0, self.cap_p_max, 1),
                              (self.cap_p_max, CAPS, -1)):
                rows = flat[b, lo:hi]
                slots, cols = np.nonzero(rows < self.block_k)
                W[base + rows[slots, cols].astype(np.int64), cols] = v
        return W[:self.K, :self.N]

    def size_bytes(self) -> int:
        # Physical truth: the global-cap padded plane, plus the per-tile
        # capacity tables.
        return int(self.plane.size + 4 * (self.cap_pos.size + self.cap_neg.size))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.plane < self.block_k).sum())
