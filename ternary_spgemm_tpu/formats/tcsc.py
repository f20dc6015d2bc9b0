"""Split-sign compressed-column / compressed-row ternary containers.

Re-design of the reference's central formats:

* :class:`TCSC` — split-sign CSC (``cpp_impl/data_structures/TCSC.h:5-50``):
  per-column pointer arrays ``col_start_pos``/``col_start_neg`` (N+1 each,
  "CSP/CSN") plus row-index streams ``row_index_pos``/``row_index_neg``
  ("RIP/RIN"). No values array — the sign is implied by which stream an index
  lives in. Memory = ``N*(K/s + 2) * 4`` bytes (``readme.md:97-101``).
* :class:`TCSR` — the row-major dual (``cpp_impl/data_structures/TCSR.h:5-50``).

Under jit the per-column ragged slices cannot be looped over dynamically, so each container additionally carries a *flattened
companion view*: per-nonzero segment ids (``col_ids`` for TCSC, expanded from
CSP/CSN exactly like a CSR->COO expansion). The XLA kernels
(``ops/xla_kernels.py``) consume the companion view with gather +
``segment_sum``; the pointer arrays remain the canonical logical layout and
are what ``to_dense``/round-trip tests exercise. The companion view is derived
data and is *not* counted in ``size_bytes`` (it is the same information as
CSP/CSN in unary form).
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format


def _csc_arrays(W: np.ndarray, value: int):
    """(col_start, row_index, col_ids) for entries of W equal to ``value``,
    ordered column-major (by column, then row) — the CSC stream order."""
    K, N = W.shape
    n_idx, k_idx = np.nonzero(W.T == value)  # sorted by column, then row
    counts = np.bincount(n_idx, minlength=N)
    col_start = np.zeros(N + 1, dtype=np.int32)
    np.cumsum(counts, out=col_start[1:])
    return col_start, k_idx.astype(np.int32), n_idx.astype(np.int32)


def _ell_table(row_index, col_start, col_ids, K: int, N: int) -> np.ndarray:
    """Padded per-column gather table (cap, N): slot s of column n = the
    s-th row index of column n's stream; empty slots point at K (callers
    append a zero column). Columns on the minor axis, so a gather of one
    slot reads contiguous memory."""
    cap = int(np.diff(col_start).max(initial=0))
    tbl = np.full((max(cap, 1), N), K, np.int32)
    slot = np.arange(len(row_index), dtype=np.int64) \
        - col_start[col_ids].astype(np.int64)
    tbl[slot, col_ids] = row_index
    return tbl


def _csr_arrays(W: np.ndarray, value: int):
    """(row_start, col_index, row_ids) for entries equal to ``value``,
    ordered row-major — the CSR stream order."""
    K, N = W.shape
    k_idx, n_idx = np.nonzero(W == value)
    counts = np.bincount(k_idx, minlength=K)
    row_start = np.zeros(K + 1, dtype=np.int32)
    np.cumsum(counts, out=row_start[1:])
    return row_start, n_idx.astype(np.int32), k_idx.astype(np.int32)


@register_format
class TCSC(TernaryFormat):
    """Split-sign ternary CSC (reference ``TCSC.h:5-50``)."""

    ARRAY_FIELDS = (
        "col_start_pos", "col_start_neg", "row_index_pos", "row_index_neg",
        "col_ids_pos", "col_ids_neg", "ell_pos", "ell_neg",
    )

    col_start_pos: np.ndarray  # (N+1,) int32
    col_start_neg: np.ndarray  # (N+1,) int32
    row_index_pos: np.ndarray  # (nnz_pos,) int32
    row_index_neg: np.ndarray  # (nnz_neg,) int32
    # flattened companion view (derived; see module docstring)
    col_ids_pos: np.ndarray    # (nnz_pos,) int32
    col_ids_neg: np.ndarray    # (nnz_neg,) int32
    K: int
    N: int
    # Padded per-column gather tables (cap, N), derived like col_ids: slot s
    # of column n holds the s-th row index of n's stream, padded with K (an
    # appended zero column). Consumed ONLY by the huge-config M-chunked
    # kernel path, where XLA's narrow scatter collapses (ops/xla_kernels.py).
    # Built LAZILY (prepare()/with_ell_tables()): cap is the max column
    # degree, so one dense-ish column makes them dwarf the CSC arrays —
    # building them eagerly paid cap*N*4 bytes of host RAM + device
    # transfer on every instance even when the chunked path never ran.
    # Not counted in size_bytes (derived data), but they ARE the real memory
    # stream of the chunked kernel — its own-bytes accounting must use
    # them, not the CSC arrays.
    ell_pos: np.ndarray = None  # (cap_pos, N) int32, or None until prepared
    ell_neg: np.ndarray = None  # (cap_neg, N) int32, or None until prepared

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "TCSC":
        W = _as_int8_dense(W)
        K, N = W.shape
        if K * N >= (1 << 20):
            # the C++ builder is bit-exact vs _csc_arrays (tested in
            # tests/test_native.py) and ~an order of magnitude faster on
            # this host class
            from ternary_spgemm_tpu import native
            if native.native_available():
                csp, csn, rip, rin, cip, cin = native.tcsc_arrays(W)
                return cls(col_start_pos=csp, col_start_neg=csn,
                           row_index_pos=rip, row_index_neg=rin,
                           col_ids_pos=cip, col_ids_neg=cin, K=K, N=N)
        csp, rip, cip = _csc_arrays(W, 1)
        csn, rin, cin = _csc_arrays(W, -1)
        return cls(col_start_pos=csp, col_start_neg=csn,
                   row_index_pos=rip, row_index_neg=rin,
                   col_ids_pos=cip, col_ids_neg=cin, K=K, N=N)

    def with_ell_tables(self) -> "TCSC":
        """A copy carrying the padded per-column gather tables (host-built
        from the canonical CSC arrays; a no-op if already present). The
        copy is memoized on the instance so a sweep's M axis builds the
        tables at most once per container."""
        if self.ell_pos is not None:
            return self
        cached = getattr(self, "_ell_cached", None)
        if cached is None:
            import dataclasses as _dc
            csp = np.asarray(self.col_start_pos)
            csn = np.asarray(self.col_start_neg)
            rip = np.asarray(self.row_index_pos)
            rin = np.asarray(self.row_index_neg)
            cached = _dc.replace(
                self,
                ell_pos=_ell_table(rip, csp, np.asarray(self.col_ids_pos),
                                   self.K, self.N),
                ell_neg=_ell_table(rin, csn, np.asarray(self.col_ids_neg),
                                   self.K, self.N))
            object.__setattr__(self, "_ell_cached", cached)
        return cached

    def prepare(self, M: int) -> "TCSC":
        """Materialize the gather tables iff an (M, ...) SpMM would take the
        M-chunked path (the kernel cannot build host tables under a trace)."""
        from ternary_spgemm_tpu.ops.xla_kernels import _GATHER_CHUNK_FLOATS
        if M * self.nnz > _GATHER_CHUNK_FLOATS:
            return self.with_ell_tables()
        return self

    def to_dense(self) -> np.ndarray:
        W = np.zeros((self.K, self.N), dtype=np.int8)
        for n in range(self.N):
            W[self.row_index_pos[self.col_start_pos[n]:self.col_start_pos[n + 1]], n] = 1
            W[self.row_index_neg[self.col_start_neg[n]:self.col_start_neg[n + 1]], n] = -1
        return W

    def size_bytes(self) -> int:
        # CSP + CSN (N+1 each) + RIP + RIN, all int32 — matches
        # TCSC::getDataStructureSize (TCSC.h:41-48).
        return 4 * (2 * (self.N + 1) + len(self.row_index_pos) + len(self.row_index_neg))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.row_index_pos) + len(self.row_index_neg)


@register_format
class TCSR(TernaryFormat):
    """Split-sign ternary CSR (reference ``TCSR.h:5-50``) — scatter-style dual."""

    ARRAY_FIELDS = (
        "row_start_pos", "row_start_neg", "col_index_pos", "col_index_neg",
        "row_ids_pos", "row_ids_neg",
    )

    row_start_pos: np.ndarray  # (K+1,) int32
    row_start_neg: np.ndarray  # (K+1,) int32
    col_index_pos: np.ndarray  # (nnz_pos,) int32
    col_index_neg: np.ndarray  # (nnz_neg,) int32
    row_ids_pos: np.ndarray    # (nnz_pos,) int32 (derived companion)
    row_ids_neg: np.ndarray    # (nnz_neg,) int32
    K: int
    N: int

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "TCSR":
        W = _as_int8_dense(W)
        K, N = W.shape
        rsp, cip, kip = _csr_arrays(W, 1)
        rsn, cin, kin = _csr_arrays(W, -1)
        return cls(row_start_pos=rsp, row_start_neg=rsn,
                   col_index_pos=cip, col_index_neg=cin,
                   row_ids_pos=kip, row_ids_neg=kin, K=K, N=N)

    def to_dense(self) -> np.ndarray:
        W = np.zeros((self.K, self.N), dtype=np.int8)
        for k in range(self.K):
            W[k, self.col_index_pos[self.row_start_pos[k]:self.row_start_pos[k + 1]]] = 1
            W[k, self.col_index_neg[self.row_start_neg[k]:self.row_start_neg[k + 1]]] = -1
        return W

    def size_bytes(self) -> int:
        return 4 * (2 * (self.K + 1) + len(self.col_index_pos) + len(self.col_index_neg))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return len(self.col_index_pos) + len(self.col_index_neg)
