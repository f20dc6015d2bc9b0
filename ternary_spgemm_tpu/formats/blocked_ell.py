"""Blocked-ELL split-sign container — the block-local gather format.

The reference's ``VectorTCSC`` (``cpp_impl/data_structures/VectorTCSC.h:5-73``)
pads per-4-column capacities so NEON can gather branch-free; its indices are
*global* K positions. This layout blocks K into ``block_k``-wide chunks
(default 128) and stores per (K-block, column) the *local* row offsets
within the block, so a gather only ever reaches one small K-slice of X:

* ``idx_pos`` / ``idx_neg`` — ``(nb, CAP, N_pad)`` int8, local offsets in
  ``[0, block_k)``, padding sentinel ``-1``;
* ``CAP`` is the max per-(block, column) count per sign over the whole matrix,
  rounded up to ``cap_align`` (static shape — mandatory for XLA);
* ``tile_cap_pos/neg`` — ``(nb, num_tiles)`` int32 honest per-(block, N-tile)
  capacities for byte accounting and tighter loop bounds.

The XLA kernel (``ops/xla_kernels.py::BlockedEllTCSC``) runs the
reference's gather loop (``comp.h:44-61``) as masked gathers over those
planes, vectorized over all output columns with zero branches.

Local offsets fit in one byte (``block_k <= 128``), and the planes are
physically int8, so the asymptotic memory cost is 8 bits/nonzero = ``8/s`` bits
per dense weight position — exactly what ``size_bytes`` accounts (per-tile
honest capacities, not the global CAP).
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.utils import cdiv, round_up


def _blocked_planes(W: np.ndarray, value: int, block_k: int, tile_n: int, cap_align: int):
    K, N = W.shape
    nb = cdiv(K, block_k)
    N_pad = round_up(N, tile_n)
    num_tiles = N_pad // tile_n
    # Pad K to whole blocks and N to whole tiles; padding is all-False.
    mask = np.zeros((nb * block_k, N_pad), bool)
    mask[:K, :N] = (W == value)
    m3 = mask.reshape(nb, block_k, N_pad)
    counts = m3.sum(axis=1)                      # (nb, N_pad)
    tile_caps = counts.reshape(nb, num_tiles, tile_n).max(axis=2)
    tile_caps = (np.ceil(tile_caps / cap_align) * cap_align).astype(np.int32)
    cap = max(int(tile_caps.max()) if tile_caps.size else 0, cap_align)
    # slot of entry (b, r, n) = its rank among the column's entries in the
    # block = exclusive running count down the block axis (vectorized fill).
    # Local offsets < block_k <= 128 fit int8 (sentinel -1) — the physical
    # layout matches the 1-byte/slot accounting of size_bytes.
    slot3 = m3.cumsum(axis=1, dtype=np.int32) - 1
    b_idx, r_idx, n_idx = np.nonzero(m3)
    idx = np.full((nb, cap, N_pad), -1, dtype=np.int8)
    idx[b_idx, slot3[b_idx, r_idx, n_idx], n_idx] = r_idx.astype(np.int8)
    return idx, tile_caps


@register_format
class BlockedEllTCSC(TernaryFormat):
    """Per-K-block local-offset ELL planes (see module docstring)."""

    ARRAY_FIELDS = ("idx_pos", "idx_neg", "tile_cap_pos", "tile_cap_neg")

    idx_pos: np.ndarray       # (nb, CAP_p, N_pad) int8, local, sentinel -1
    idx_neg: np.ndarray       # (nb, CAP_n, N_pad) int8
    tile_cap_pos: np.ndarray  # (nb, num_tiles) int32
    tile_cap_neg: np.ndarray  # (nb, num_tiles) int32
    K: int
    N: int
    block_k: int
    tile_n: int
    cap_align: int

    @classmethod
    def from_dense(cls, W: np.ndarray, block_k: int = 128, tile_n: int = 128,
                   cap_align: int = 8) -> "BlockedEllTCSC":
        if not 0 < block_k <= 128:
            raise ValueError(
                f"block_k={block_k}: local offsets must fit int8 and one "
                "128-lane vector register (the whole point of the layout)")
        W = _as_int8_dense(W)
        K, N = W.shape
        ip, cp = _blocked_planes(W, 1, block_k, tile_n, cap_align)
        im, cm = _blocked_planes(W, -1, block_k, tile_n, cap_align)
        return cls(idx_pos=ip, idx_neg=im, tile_cap_pos=cp, tile_cap_neg=cm,
                   K=K, N=N, block_k=block_k, tile_n=tile_n, cap_align=cap_align)

    @property
    def num_blocks(self) -> int:
        return cdiv(self.K, self.block_k)

    @property
    def num_tiles(self) -> int:
        return cdiv(self.N, self.tile_n)

    def to_dense(self) -> np.ndarray:
        W = np.zeros((self.K, self.N), np.int8)
        for b in range(self.num_blocks):
            base = b * self.block_k
            for plane, v in ((self.idx_pos, 1), (self.idx_neg, -1)):
                rows_all = plane[b][:, :self.N]
                slots, cols = np.nonzero(rows_all >= 0)
                W[base + rows_all[slots, cols].astype(np.int64), cols] = v
        return W

    def size_bytes(self) -> int:
        # Honest per-(block, tile) capacity accounting at the 1-byte-per-slot
        # physical layout (local offsets < block_k <= 256 fit uint8).
        per = (self.tile_cap_pos.astype(np.int64) + self.tile_cap_neg.astype(np.int64))
        return int(per.sum() * self.tile_n + 4 * 2 * self.tile_cap_pos.size)

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.idx_pos >= 0).sum() + (self.idx_neg >= 0).sum())
