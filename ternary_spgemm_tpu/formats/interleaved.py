"""Sign-interleaved split-sign CSC.

Re-design of the reference's ``InterleavedTCSC``
(``cpp_impl/data_structures/InterleavedTCSC.h:7-84``): a single
``all_indices`` row-index stream with a 3-segment-per-column pointer table
``col_segment_ptr`` (3N+1 entries). Per column: segment 1 holds interleaved
groups of 4 positive then 4 negative indices (while both signs have >= 4
left), segment 2 the leftover positives, segment 3 the leftover negatives
(``InterleavedTCSC.h:44-72``). The layout removes per-nonzero sign branching
— on the CPU that killed branch prediction; under jit the analogous win is
a branch-free signed stream, which the companion ``signs`` array makes explicit
for the vectorized segment-sum kernel.
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.formats.blocked import _interleave_streams


@register_format
class InterleavedTCSC(TernaryFormat):
    """Interleaved split-sign CSC (reference ``InterleavedTCSC.h:7-84``)."""

    ARRAY_FIELDS = ("all_indices", "col_segment_ptr", "signs", "col_ids")

    all_indices: np.ndarray      # (nnz,) int32
    col_segment_ptr: np.ndarray  # (3N+1,) int32
    signs: np.ndarray            # (nnz,) int8 companion (derived)
    col_ids: np.ndarray          # (nnz,) int32 companion (derived)
    K: int
    N: int
    group: int

    @classmethod
    def from_dense(cls, W: np.ndarray, group: int = 4) -> "InterleavedTCSC":
        W = _as_int8_dense(W)
        K, N = W.shape
        all_idx, all_sgn, all_col = [], [], []
        seg_ptr = [0]
        total = 0
        for n in range(N):
            pos = np.nonzero(W[:, n] == 1)[0].astype(np.int32)
            neg = np.nonzero(W[:, n] == -1)[0].astype(np.int32)
            idx, sgn, pairs = _interleave_streams(pos, neg, group)
            inter = 2 * pairs * group
            n_pos_left = len(pos) - pairs * group
            all_idx.append(idx)
            all_sgn.append(sgn)
            all_col.append(np.full(len(idx), n, np.int32))
            seg_ptr.extend([total + inter, total + inter + n_pos_left, total + len(idx)])
            total += len(idx)
        return cls(
            all_indices=np.concatenate(all_idx) if all_idx else np.zeros(0, np.int32),
            col_segment_ptr=np.asarray(seg_ptr, np.int32),
            signs=np.concatenate(all_sgn) if all_sgn else np.zeros(0, np.int8),
            col_ids=np.concatenate(all_col) if all_col else np.zeros(0, np.int32),
            K=K, N=N, group=group)

    def to_dense(self) -> np.ndarray:
        # Decode from the canonical (all_indices, col_segment_ptr) layout.
        W = np.zeros((self.K, self.N), dtype=np.int8)
        g = self.group
        for n in range(self.N):
            base, a, p, e = (self.col_segment_ptr[3 * n], self.col_segment_ptr[3 * n + 1],
                             self.col_segment_ptr[3 * n + 2], self.col_segment_ptr[3 * n + 3])
            inter = self.all_indices[base:a]
            j = np.arange(len(inter))
            W[inter, n] = np.where((j // g) % 2 == 0, 1, -1).astype(np.int8)
            W[self.all_indices[a:p], n] = 1
            W[self.all_indices[p:e], n] = -1
        return W

    def size_bytes(self) -> int:
        # index stream + 3N+1 pointer table (InterleavedTCSC::getDataStructureSize).
        return 4 * (len(self.all_indices) + len(self.col_segment_ptr))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.all_indices)
