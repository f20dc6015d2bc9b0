"""Rectangular (ELL-style) split-sign container — the static-shape gather format.

This is the reference's ``VectorTCSC``
(``cpp_impl/data_structures/VectorTCSC.h:5-73``) with static shapes. The
reference pads every group of 4 columns to a common per-sign capacity so its
NEON kernels are branch-free — but its capacity scan loops over all
*remaining* columns (``VectorTCSC.h:21``), massively over-padding, and it
resolves the ``-1`` padding sentinel by writing to ``X_row_m[-1]``
(``comp.h:1078,1160``), which is UB for the first row. Here:

* columns are tiled in groups of ``tile_n`` (default 128), and the padded
  capacity is the max nonzero count *within the tile*, rounded up to a
  multiple of ``cap_align`` (default 8);
* the index arrays are rectangular ``(CAP, N_pad)`` int32 with padding
  sentinel ``K`` — kernels append one zero row to X (or use fill-gather), so
  padded slots contribute exactly 0 with no UB;
* per-tile capacities are kept (``tile_cap_pos/neg``) for honest byte
  accounting and per-tile loop bounds, so the global rectangle costs no extra
  memory traffic in kernels that bound their slot loop by the tile capacity.

Rectangular, statically-shaped index planes are what make the gather
formulation expressible under jit at all: XLA requires static shapes, and
the (slot, column) layout keeps the columns on the minor axis.
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.utils import cdiv, round_up


def _ell_plane(W: np.ndarray, value: int, tile_n: int, cap_align: int):
    """Build (idx_plane (CAP, N_pad) int32 sentinel=K, tile_caps (T,) int32)."""
    K, N = W.shape
    N_pad = round_up(N, tile_n)
    counts = (W == value).sum(axis=0)
    counts_pad = np.zeros(N_pad, np.int64)
    counts_pad[:N] = counts
    tiles = counts_pad.reshape(-1, tile_n)
    tile_max = tiles.max(axis=1)
    tile_caps = (np.ceil(tile_max / cap_align).astype(np.int64) * cap_align).astype(np.int32)
    cap = int(tile_caps.max()) if len(tile_caps) else 0
    cap = max(cap, cap_align)  # keep a non-empty plane for shape stability
    idx = np.full((cap, N_pad), K, dtype=np.int32)
    mask = (W == value)
    # slot of entry (k, n) = its rank within column n (vectorized fill)
    slots = mask.cumsum(axis=0, dtype=np.int32) - 1
    k_idx, n_idx = np.nonzero(mask)
    idx[slots[k_idx, n_idx], n_idx] = k_idx.astype(np.int32)
    return idx, tile_caps


@register_format
class EllTCSC(TernaryFormat):
    """Padded split-sign ELL (``VectorTCSC.h`` re-designed; see module doc)."""

    ARRAY_FIELDS = ("idx_pos", "idx_neg", "tile_cap_pos", "tile_cap_neg")

    idx_pos: np.ndarray       # (CAP_pos, N_pad) int32, sentinel = K
    idx_neg: np.ndarray       # (CAP_neg, N_pad) int32, sentinel = K
    tile_cap_pos: np.ndarray  # (num_tiles,) int32
    tile_cap_neg: np.ndarray  # (num_tiles,) int32
    K: int
    N: int
    tile_n: int
    cap_align: int

    @classmethod
    def from_dense(cls, W: np.ndarray, tile_n: int = 128, cap_align: int = 8) -> "EllTCSC":
        W = _as_int8_dense(W)
        K, N = W.shape
        ip, cp = _ell_plane(W, 1, tile_n, cap_align)
        im, cm = _ell_plane(W, -1, tile_n, cap_align)
        return cls(idx_pos=ip, idx_neg=im, tile_cap_pos=cp, tile_cap_neg=cm,
                   K=K, N=N, tile_n=tile_n, cap_align=cap_align)

    @property
    def num_tiles(self) -> int:
        return cdiv(self.N, self.tile_n)

    def to_dense(self) -> np.ndarray:
        W = np.zeros((self.K + 1, self.N), dtype=np.int8)  # +1 sentinel row
        for n in range(self.N):
            W[self.idx_pos[:, n], n] = 1
            W[self.idx_neg[:, n], n] = -1
        W[self.K, :] = 0
        return W[:self.K]

    def size_bytes(self) -> int:
        # Honest accounting: per-tile capacities (what a per-tile-bounded
        # kernel actually reads), not the global rectangle.
        per_tile = (self.tile_cap_pos.astype(np.int64) + self.tile_cap_neg.astype(np.int64))
        return int(4 * (per_tile.sum() * self.tile_n + 2 * self.num_tiles))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.idx_pos != self.K).sum() + (self.idx_neg != self.K).sum())
