"""K-blocked split-sign containers.

Re-designs of the reference's cache-blocking formats:

* :class:`BlockedTCSC` — TCSC built per K-block
  (``cpp_impl/data_structures/BlockedTCSC.h:6-49``): the K dimension is cut
  into ``K/B`` row-blocks and a split-sign CSC is stored for each block, so a
  kernel can stream one activation K-slice at a time. The reference stores
  column-pointer arrays of ``(K/B)*N + 1`` entries; we keep that layout
  (block-major, then column) with *global* row indices.
* :class:`InterleavedBlockedTCSC` — blocked + sign-interleaved streams
  (``cpp_impl/data_structures/InterleavedBlockedTCSC.h:7-157``). The reference
  has two constructors: "base" interleaves one +1 index with one -1 index
  while both remain (``:15-75``); "grouped" interleaves ``UF/2`` positives
  with ``UF/2`` negatives (``:78-148``, driver uses UF=12). Here that is one
  class with a ``group`` parameter (group=1 == base).

On the CPU the blocking exists to keep the active X-slice in L1/L2; on an
accelerator that role belongs to a kernel's own tiling, so these containers
are primarily *logical* formats (capability parity + layout
experiments). Each carries flattened companion views (per-nonzero column ids,
signs, and per-block stream offsets) that the XLA kernels consume with
trace-time block loops + ``segment_sum``.
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.utils import cdiv


def _check_block(K: int, block_size: int):
    if K % block_size != 0:
        raise ValueError(
            f"K={K} must be divisible by block_size={block_size} "
            "(reference asserts the same, BlockedTCSC.h:5)")


@register_format
class BlockedTCSC(TernaryFormat):
    """Per-K-block split-sign CSC (reference ``BlockedTCSC.h:6-49``)."""

    ARRAY_FIELDS = (
        "col_start_pos", "col_start_neg", "row_index_pos", "row_index_neg",
        "col_ids_pos", "col_ids_neg", "block_ptr_pos", "block_ptr_neg",
    )

    col_start_pos: np.ndarray  # (num_blocks*N + 1,) int32, block-major
    col_start_neg: np.ndarray  # (num_blocks*N + 1,) int32
    row_index_pos: np.ndarray  # (nnz_pos,) int32, *global* row ids
    row_index_neg: np.ndarray  # (nnz_neg,) int32
    col_ids_pos: np.ndarray    # (nnz_pos,) int32 companion
    col_ids_neg: np.ndarray    # (nnz_neg,) int32
    block_ptr_pos: np.ndarray  # (num_blocks+1,) int32 stream offsets per block
    block_ptr_neg: np.ndarray  # (num_blocks+1,) int32
    K: int
    N: int
    block_size: int

    @classmethod
    def from_dense(cls, W: np.ndarray, block_size: int = 512) -> "BlockedTCSC":
        W = _as_int8_dense(W)
        K, N = W.shape
        _check_block(K, block_size)
        nb = K // block_size

        def build(value):
            col_start = [0]
            row_idx, col_ids, block_ptr = [], [], [0]
            for b in range(nb):
                blk = W[b * block_size:(b + 1) * block_size]
                n_idx, k_idx = np.nonzero(blk.T == value)  # column-major in block
                counts = np.bincount(n_idx, minlength=N)
                base = col_start[-1]
                col_start.extend((base + np.cumsum(counts)).tolist())
                row_idx.append(k_idx.astype(np.int32) + b * block_size)
                col_ids.append(n_idx.astype(np.int32))
                block_ptr.append(base + len(k_idx))
            return (np.asarray(col_start, np.int32),
                    np.concatenate(row_idx) if row_idx else np.zeros(0, np.int32),
                    np.concatenate(col_ids) if col_ids else np.zeros(0, np.int32),
                    np.asarray(block_ptr, np.int32))

        csp, rip, cip, bpp = build(1)
        csn, rin, cin, bpn = build(-1)
        return cls(col_start_pos=csp, col_start_neg=csn,
                   row_index_pos=rip, row_index_neg=rin,
                   col_ids_pos=cip, col_ids_neg=cin,
                   block_ptr_pos=bpp, block_ptr_neg=bpn,
                   K=K, N=N, block_size=block_size)

    @property
    def num_blocks(self) -> int:
        return self.K // self.block_size

    def to_dense(self) -> np.ndarray:
        W = np.zeros((self.K, self.N), dtype=np.int8)
        for b in range(self.num_blocks):
            for n in range(self.N):
                i = b * self.N + n
                lo, hi = self.col_start_pos[i], self.col_start_pos[i + 1]
                W[self.row_index_pos[lo:hi], n] = 1
                lo, hi = self.col_start_neg[i], self.col_start_neg[i + 1]
                W[self.row_index_neg[lo:hi], n] = -1
        return W

    def size_bytes(self) -> int:
        # two pointer tables of (K/B)*N+1 entries + the two index streams,
        # mirroring BlockedTCSC::getDataStructureSize.
        return 4 * (2 * (self.num_blocks * self.N + 1)
                    + len(self.row_index_pos) + len(self.row_index_neg))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.row_index_pos) + len(self.row_index_neg)


def _interleave_streams(pos: np.ndarray, neg: np.ndarray, group: int):
    """Interleave ``group`` positives with ``group`` negatives while both
    streams have a full group left; returns (indices, signs, n_interleaved_pairs).

    Mirrors the interleaving rule of ``InterleavedTCSC.h:44-72`` (group=4) and
    both ``InterleavedBlockedTCSC`` constructors (group=1 / group=UF/2).
    """
    g = group
    pairs = min(len(pos) // g, len(neg) // g)
    idx, sgn = [], []
    for i in range(pairs):
        idx.append(pos[i * g:(i + 1) * g])
        sgn.append(np.ones(g, np.int8))
        idx.append(neg[i * g:(i + 1) * g])
        sgn.append(-np.ones(g, np.int8))
    idx.append(pos[pairs * g:])
    sgn.append(np.ones(len(pos) - pairs * g, np.int8))
    idx.append(neg[pairs * g:])
    sgn.append(-np.ones(len(neg) - pairs * g, np.int8))
    return (np.concatenate(idx) if idx else np.zeros(0, np.int32),
            np.concatenate(sgn) if sgn else np.zeros(0, np.int8),
            pairs)


@register_format
class InterleavedBlockedTCSC(TernaryFormat):
    """Blocked + sign-interleaved container (reference
    ``InterleavedBlockedTCSC.h:7-157``); ``group=1`` is the reference's base
    constructor, ``group=UF/2`` the unrolled one (driver used UF=12 → group=6,
    ``main.cpp:8,72``)."""

    ARRAY_FIELDS = ("all_indices", "signs", "seg_ptr", "col_ids", "block_ptr")

    all_indices: np.ndarray  # (nnz,) int32 global row ids, block/col-major interleaved
    signs: np.ndarray        # (nnz,) int8 companion sign stream
    seg_ptr: np.ndarray      # (num_blocks*3N + 1,) int32: per (block, col) 3 segments
    col_ids: np.ndarray      # (nnz,) int32 companion
    block_ptr: np.ndarray    # (num_blocks+1,) int32
    K: int
    N: int
    block_size: int
    group: int

    @classmethod
    def from_dense(cls, W: np.ndarray, block_size: int = 512, group: int = 1):
        W = _as_int8_dense(W)
        K, N = W.shape
        _check_block(K, block_size)
        nb = K // block_size
        all_idx, all_sgn, all_col = [], [], []
        seg_ptr = [0]
        block_ptr = [0]
        total = 0
        for b in range(nb):
            blk = W[b * block_size:(b + 1) * block_size]
            for n in range(N):
                pos = (np.nonzero(blk[:, n] == 1)[0] + b * block_size).astype(np.int32)
                neg = (np.nonzero(blk[:, n] == -1)[0] + b * block_size).astype(np.int32)
                idx, sgn, pairs = _interleave_streams(pos, neg, group)
                inter = 2 * pairs * group
                n_pos_left = len(pos) - pairs * group
                all_idx.append(idx)
                all_sgn.append(sgn)
                all_col.append(np.full(len(idx), n, np.int32))
                seg_ptr.extend([total + inter,
                                total + inter + n_pos_left,
                                total + len(idx)])
                total += len(idx)
            block_ptr.append(total)
        return cls(
            all_indices=np.concatenate(all_idx) if all_idx else np.zeros(0, np.int32),
            signs=np.concatenate(all_sgn) if all_sgn else np.zeros(0, np.int8),
            seg_ptr=np.asarray(seg_ptr, np.int32),
            col_ids=np.concatenate(all_col) if all_col else np.zeros(0, np.int32),
            block_ptr=np.asarray(block_ptr, np.int32),
            K=K, N=N, block_size=block_size, group=group)

    @property
    def num_blocks(self) -> int:
        return self.K // self.block_size

    def to_dense(self) -> np.ndarray:
        # Decode from the canonical (all_indices, seg_ptr) layout — the sign
        # of every index is implied by the segment structure, exactly like the
        # reference kernels read it (comp.h:782-848).
        W = np.zeros((self.K, self.N), dtype=np.int8)
        g = self.group
        for b in range(self.num_blocks):
            for n in range(self.N):
                i = b * self.N + n
                base, a, p, e = (self.seg_ptr[3 * i], self.seg_ptr[3 * i + 1],
                                 self.seg_ptr[3 * i + 2], self.seg_ptr[3 * i + 3])
                inter = self.all_indices[base:a]
                j = np.arange(len(inter))
                sgn = np.where((j // g) % 2 == 0, 1, -1).astype(np.int8)
                W[inter, n] = sgn
                W[self.all_indices[a:p], n] = 1
                W[self.all_indices[p:e], n] = -1
        return W

    def size_bytes(self) -> int:
        # index stream + segment-pointer table (the sign stream is implied by
        # the segment structure in the reference layout; the explicit `signs`
        # companion here is derived data, not counted).
        return 4 * (len(self.all_indices) + len(self.seg_ptr))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.all_indices)
