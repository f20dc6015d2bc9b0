"""XLA-native ternary SpMM kernel family.

Re-designs of the reference's kernel taxonomy (``cpp_impl/comp.h``, 1439 LoC
of scalar/NEON C++). The reference's unroll variants exist to create
independent CPU accumulator chains; on a device that role is played by XLA's own
vectorization and fusion, so each *algorithmic strategy* gets one kernel here:

====================  =========================================================
Kernel                Strategy (reference analogue)
====================  =========================================================
BaseTCSC              gather + sorted segment-sum over column ids
                      (``BaseTCSC``/``Unrolled*TCSC``, ``comp.h:25-265``)
BaseTCSR              scatter formulation: row-major stream, unsorted
                      segment-sum (``BaseTCSR``/``UnrolledTCSR``,
                      ``comp.h:478-603``)
BlockedTCSC           K-block partial sums, then reduce over blocks
                      (``Base/UnrolledBlockedTCSC``, ``comp.h:607-780``)
InterleavedTCSC       single branch-free signed stream
                      (``Base/UnrolledInterleavedTCSC``, ``comp.h:267-474``)
InterleavedBlocked    blocked x signed-stream combination
TCSC                  (``comp.h:782-932``)
EllTCSC               rectangular padded gather, one vectorized slot axis
                      (``NeonTCSCVertical``/``HorizontalAdvanced``,
                      ``comp.h:1068-1225`` — the NEON lane dimension becomes
                      the column dimension)
DenseMXU              densified int8 weights -> exact f32 matmul (HIGHEST)
DenseMXU_bf16         same with bf16 operands (production speed, approximate)
PackedMXU_2bit        2-bit packed weights, decode-then-dot (4 values/byte)
PackedMXU_base3       base-3 packed weights, decode-then-dot (5 values/byte,
                      the roadmap codec, ``readme.md:108-111``)
PackedCSC             sparse CSC stream with base-3 packed value codes
====================  =========================================================

All kernels share the signature ``(X, fmt, bias, alpha=None) -> Y`` and fuse
the bias + optional PReLU epilogue (``comp_prelu.h``) via
:func:`ternary_spgemm_tpu.ops.api.finish`.

Exactness: every kernel accumulates in float32. For the integer-valued test
distributions (X integer in [-512,512], W ternary) f32 accumulation is exact,
so all kernels except the bf16 path meet the reference's absolute 1e-5
tolerance bit-for-bit (``sparseUtils.h:147``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ternary_spgemm_tpu.formats import (
    BlockedEllTCSC,
    BlockedTCSC,
    DenseTernary,
    EllTCSC,
    InterleavedBlockedTCSC,
    InterleavedTCSC,
    PackedCSC,
    PackedTernary2Bit,
    PackedTernary53,
    TCSC,
    TCSR,
)
from ternary_spgemm_tpu.ops.api import finish, register_kernel

_HIGH = jax.lax.Precision.HIGHEST


def _segment_cols(data, col_ids, N, *, sorted_ids):
    """Sum ``data[:, i]`` into output column ``col_ids[i]``.

    data: (M, nnz) -> (M, N). The gather/segment formulation is how both the
    reference's gather (CSC) and scatter (CSR) loops map onto XLA: the only
    difference is the stream order, captured by ``sorted_ids``.
    """
    seg = jax.ops.segment_sum(data.T, col_ids, num_segments=N,
                              indices_are_sorted=sorted_ids)
    return seg.T


#: Cap (in f32 elements) for the materialized (M-chunk, nnz) gather stream.
#: Above it the kernel scans over M-chunks so the full (M, nnz) intermediate
#: never exists — this is what makes BaseTCSC feasible (hence a real speedup
#: denominator) at every canonical grid config instead of 112/256
#: (VERDICT.md round-2 missing #4). 2^26 floats = 256 MB per chunk.
_GATHER_CHUNK_FLOATS = 1 << 26


#: Chunk-intermediate budget (f32 elements) for the padded-gather path:
#: (MC, cap, N) per sign per step. Bigger chunks = wider effective gathers;
#: measured 2055 -> 240 ms at (M=4000, K=1024, N=4096, s=2) going from 2^26
#: to 2^28 and the EllTCSC column-minor orientation.
_CHUNK_BUDGET_FLOATS = 1 << 28


def _tcsc_chunked(X, fmt: TCSC):
    """Scan over M-chunks with per-column PADDED gathers (no scatter).

    The direct formulation's ``segment_sum`` lowers to an XLA scatter whose
    update rows are only MC elements wide — and MC = budget/nnz shrinks
    exactly where nnz grows, collapsing throughput at the grid corners
    (measured: 8x slower than the padded gather at the chipgate shape). The
    chunked path instead consumes the container's padded per-column gather
    tables (``TCSC.ell_pos/ell_neg``, built lazily by ``fmt.prepare(M)`` —
    they are cap*N*4 bytes each and only this path reads them; they, not
    the CSC arrays, are this path's real HBM weight stream): every M-chunk
    is a pure gather + slot-axis reduction, columns on the minor axis.
    Summation stays exact for the integer test distribution (|partial
    sums| < 2^24), so results match the direct path bit-for-bit there."""
    M, K = X.shape
    N = fmt.N
    # Section the slot axis so the per-gather intermediate is (MC, SEC, N)
    # with SEC <= 1024: at the (16384, 4096) grid corners cap reaches ~8400
    # and an unsectioned chunk forces MC ~ 7 rows, collapsing gather
    # efficiency. Sections keep MC wide at identical math.
    SEC = 1024
    sec_rows = min(SEC, max(fmt.ell_pos.shape[0], fmt.ell_neg.shape[0], 1))
    MC = max(1, _CHUNK_BUDGET_FLOATS // (N * sec_rows))
    steps = -(-M // MC)
    Xp = jnp.pad(X, ((0, steps * MC - M), (0, 1)))       # zero column at K

    def chunk(xc):  # (MC, K+1) -> (MC, N)
        acc = jnp.zeros((xc.shape[0], N), jnp.float32)
        for tbl, sign in ((fmt.ell_pos, 1.0), (fmt.ell_neg, -1.0)):
            for s0 in range(0, tbl.shape[0], SEC):
                part = jnp.take(xc, tbl[s0:s0 + SEC], axis=1).sum(axis=1)
                acc = acc + sign * part
        return acc

    ys = jax.lax.map(chunk, Xp.reshape(steps, MC, K + 1))  # (steps, MC, N)
    return ys.reshape(steps * MC, N)[:M]


@register_kernel(
    "BaseTCSC", TCSC,
    description="split-sign gather + sorted segment-sum (speedup baseline); "
                "scans over M-chunks when the (M, nnz) stream exceeds the "
                "device budget, so every canonical config is feasible",
    reference="cpp_impl/comp.h:25-69 (BaseTCSC), 71-265 (Unrolled*)")
def tcsc_kernel(X, fmt: TCSC, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    nnz = int(fmt.row_index_pos.shape[0] + fmt.row_index_neg.shape[0])
    if X.shape[0] * nnz > _GATHER_CHUNK_FLOATS:
        if fmt.ell_pos is None:
            # The gather tables are built lazily (they can dwarf the CSC
            # arrays; ADVICE round 3). Eager calls build them here; under a
            # trace the leaves are abstract, so the caller must prepare()
            # the container first (the bench harness does).
            if isinstance(fmt.row_index_pos, jax.core.Tracer):
                raise ValueError(
                    "M-chunked BaseTCSC needs the padded gather tables: "
                    "call fmt.prepare(M) (or fmt.with_ell_tables()) before "
                    "jit-tracing the kernel")
            fmt = fmt.with_ell_tables()
        return finish(_tcsc_chunked(X, fmt), bias, alpha)
    pos = _segment_cols(jnp.take(X, fmt.row_index_pos, axis=1),
                        fmt.col_ids_pos, fmt.N, sorted_ids=True)
    neg = _segment_cols(jnp.take(X, fmt.row_index_neg, axis=1),
                        fmt.col_ids_neg, fmt.N, sorted_ids=True)
    return finish(pos - neg, bias, alpha)


@register_kernel(
    "BaseTCSR", TCSR,
    description="row-major scatter formulation (unsorted segment-sum)",
    reference="cpp_impl/comp.h:478-603 (BaseTCSR/UnrolledTCSR)")
def tcsr_kernel(X, fmt: TCSR, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    # Row-major stream: entry i scatters X[:, row_ids[i]] into column
    # col_index[i] — segment ids are NOT sorted, exactly the reference's
    # scatter hazard (comp.h:490-527) which XLA resolves with a real scatter.
    pos = _segment_cols(jnp.take(X, fmt.row_ids_pos, axis=1),
                        fmt.col_index_pos, fmt.N, sorted_ids=False)
    neg = _segment_cols(jnp.take(X, fmt.row_ids_neg, axis=1),
                        fmt.col_index_neg, fmt.N, sorted_ids=False)
    return finish(pos - neg, bias, alpha)


@register_kernel(
    "BlockedTCSC", BlockedTCSC,
    description="per-K-block partial column sums, reduced over blocks",
    reference="cpp_impl/comp.h:607-780 (Base/UnrolledBlockedTCSC)")
def blocked_tcsc_kernel(X, fmt: BlockedTCSC, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    nb, N, B = fmt.num_blocks, fmt.N, fmt.block_size

    def plane(row_index, col_ids):
        # Segment key = (block, column): keeps the blocked partial-sum
        # structure (comp.h:642 accumulates Y += per-block y) visible to XLA.
        block_ids = row_index // B
        seg = block_ids * N + col_ids
        part = jax.ops.segment_sum(jnp.take(X, row_index, axis=1).T, seg,
                                   num_segments=nb * N, indices_are_sorted=True)
        return part.reshape(nb, N, -1).sum(axis=0).T

    return finish(plane(fmt.row_index_pos, fmt.col_ids_pos)
                  - plane(fmt.row_index_neg, fmt.col_ids_neg), bias, alpha)


@register_kernel(
    "InterleavedTCSC", InterleavedTCSC,
    description="single branch-free signed stream + segment-sum",
    reference="cpp_impl/comp.h:267-474 (Base/UnrolledInterleavedTCSC)")
def interleaved_tcsc_kernel(X, fmt: InterleavedTCSC, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    vals = jnp.take(X, fmt.all_indices, axis=1) * fmt.signs.astype(jnp.float32)[None, :]
    return finish(_segment_cols(vals, fmt.col_ids, fmt.N, sorted_ids=True),
                  bias, alpha)


@register_kernel(
    "InterleavedBlockedTCSC", InterleavedBlockedTCSC,
    description="blocked signed stream (block-partial sums over one stream)",
    reference="cpp_impl/comp.h:782-932 (Base/UnrolledInterleavedBlockedTCSC)")
def interleaved_blocked_kernel(X, fmt: InterleavedBlockedTCSC, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    nb, N, B = fmt.num_blocks, fmt.N, fmt.block_size
    vals = jnp.take(X, fmt.all_indices, axis=1) * fmt.signs.astype(jnp.float32)[None, :]
    seg = (fmt.all_indices // B) * N + fmt.col_ids
    part = jax.ops.segment_sum(vals.T, seg, num_segments=nb * N,
                               indices_are_sorted=True)
    return finish(part.reshape(nb, N, -1).sum(axis=0).T, bias, alpha)


@register_kernel(
    "EllTCSC", EllTCSC,
    description="rectangular padded gather over the slot axis (lane = column)",
    reference="cpp_impl/comp.h:1068-1225 (NeonTCSCVertical/HorizontalAdvanced) "
              "+ VectorTCSC.h:5-73, with the over-padding and X[-1] UB fixed")
def ell_tcsc_kernel(X, fmt: EllTCSC, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    M = X.shape[0]
    # Sentinel index == K gathers from an appended zero column: padded slots
    # contribute exactly 0 (no UB, unlike the reference's X_row[-1]=0 trick,
    # comp.h:1078).
    Xp = jnp.concatenate([X, jnp.zeros((M, 1), X.dtype)], axis=1)
    pos = jnp.take(Xp, fmt.idx_pos, axis=1).sum(axis=1)   # (M, CAP_p, N_pad) -> (M, N_pad)
    neg = jnp.take(Xp, fmt.idx_neg, axis=1).sum(axis=1)
    return finish((pos - neg)[:, :fmt.N], bias, alpha)


@register_kernel(
    "BlockedEllTCSC", BlockedEllTCSC,
    description="masked gather over per-K-block local-offset ELL planes "
                "(block-local offsets, one masked gather per plane)",
    reference="cpp_impl/comp.h:1068-1149 + VectorTCSC.h, blocked "
              "(formats/blocked_ell.py)")
def blocked_ell_kernel(X, fmt: BlockedEllTCSC, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    M = X.shape[0]
    nb, BK = fmt.num_blocks, fmt.block_k
    Xp = jnp.pad(X, ((0, 0), (0, nb * BK - fmt.K)))
    Xb = Xp.reshape(M, nb, BK)

    def gather_plane(idx):  # (nb, CAP, N_pad) local offsets, sentinel -1
        # g[m, b, c, n] = Xb[m, b, safe[b, c, n]]; masked slots contribute 0
        valid = idx >= 0
        safe = jnp.where(valid, idx, 0)
        g = jax.vmap(lambda xb: xb[jnp.arange(nb)[:, None, None], safe])(Xb)
        return jnp.where(valid[None], g, 0.0).sum(axis=(1, 2))

    pos = gather_plane(jnp.asarray(fmt.idx_pos, jnp.int32))
    neg = gather_plane(jnp.asarray(fmt.idx_neg, jnp.int32))
    return finish((pos - neg)[:, :fmt.N], bias, alpha)


@register_kernel(
    "DenseMXU", DenseTernary,
    description="densified int8 weights, exact f32 matmul (HIGHEST)",
    reference="strategy inversion of cpp_impl/comp.h (see ops/__init__) — the "
              "multiplication-free trick is free on matrix units, so dense "
              "wins")
def dense_mxu_kernel(X, fmt: DenseTernary, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    W = fmt.dense.astype(jnp.float32)
    Y = jnp.dot(X, W, precision=_HIGH, preferred_element_type=jnp.float32)
    return finish(Y, bias, alpha)


@register_kernel(
    "DenseMXU_bf16", DenseTernary,
    description="bf16 matmul (fast path; inexact for |X|>256)",
    approximate=True, x_bytes=2.0)
def dense_mxu_bf16_kernel(X, fmt: DenseTernary, bias, alpha=None):
    Xb = jnp.asarray(X, jnp.bfloat16)
    W = fmt.dense.astype(jnp.bfloat16)  # {-1,0,1} is exact in bf16
    Y = jnp.dot(Xb, W, preferred_element_type=jnp.float32)
    return finish(Y, bias, alpha)


@register_kernel(
    "DenseMXU_x8", DenseTernary,
    description="int8-native XLA matmul: int8 activations x int8 ternary "
                "plane with int32 accumulation — the XLA formulation of the "
                "bitplane _x8 kernels (exact for integer activations |x|<=127, "
                "clamps outside)",
    reference="BitNet W1.58-A8 regime (SURVEY.md \u00a76)",
    x_absmax=127, x_bytes=1.0)
def dense_mxu_x8_kernel(X, fmt: DenseTernary, bias, alpha=None):
    x8 = jnp.clip(jnp.round(jnp.asarray(X, jnp.float32)),
                  -127.0, 127.0).astype(jnp.int8)
    # precision pinned: an ambient default_matmul_precision("highest")
    # context must not attach fp32 contract precision to an i8 dot
    Y = jnp.dot(x8, fmt.dense, preferred_element_type=jnp.int32,
                precision=jax.lax.Precision.DEFAULT)
    return finish(Y.astype(jnp.float32), bias, alpha)


def decode_2bit(packed, K: int):
    """Decode a stride-packed 2-bit plane ``(Kq, N) uint8 -> (K, N) int8``.

    Field j of byte row k' holds dense row ``j*Kq + k'`` (stride layout,
    formats/packed.py). Codes: 0->0, 1->+1, 3->-1; ``w = (c&1) - (c&2)``
    maps them without a lookup table.
    """
    fields = []
    for j in range(4):
        c = (packed >> (2 * j)) & 3
        fields.append((c & 1).astype(jnp.int8) - (c & 2).astype(jnp.int8))
    return jnp.concatenate(fields, axis=0)[:K]


def decode_base3(packed, K: int):
    """Decode a stride-packed base-3 plane ``(Kq, N) uint8 -> (K, N) int8``.

    Digits {0,1,2} -> weights {0,+1,-1} via ``w = d - 3*(d >> 1)``.
    """
    p = packed.astype(jnp.int16)
    fields = []
    for j in range(5):
        d = (p // (3 ** j)) % 3
        fields.append((d - 3 * (d >> 1)).astype(jnp.int8))
    return jnp.concatenate(fields, axis=0)[:K]


@register_kernel(
    "PackedMXU_2bit", PackedTernary2Bit,
    description="2-bit packed weights (4/byte): decode -> exact f32 dot",
    reference="readme.md:108-111 roadmap codec, power-of-two variant")
def packed2_mxu_kernel(X, fmt: PackedTernary2Bit, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    # K from the activation side: under shard_map fmt.K is reconstructed from
    # the padded packed rows (round_up(K, factor)) and may exceed local K.
    W = decode_2bit(fmt.packed, X.shape[1]).astype(jnp.float32)
    Y = jnp.dot(X, W, precision=_HIGH, preferred_element_type=jnp.float32)
    return finish(Y, bias, alpha)


@register_kernel(
    "PackedMXU_base3", PackedTernary53,
    description="base-3 packed weights (5/byte): decode -> exact f32 dot",
    reference="readme.md:108-111 ('8 bits for 5 values')")
def packed53_mxu_kernel(X, fmt: PackedTernary53, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    W = decode_base3(fmt.packed, X.shape[1]).astype(jnp.float32)  # see 2-bit note
    Y = jnp.dot(X, W, precision=_HIGH, preferred_element_type=jnp.float32)
    return finish(Y, bias, alpha)


@register_kernel(
    "PackedCSC", PackedCSC,
    description="sparse CSC stream with base-3 packed value codes",
    reference="readme.md:108-111 (roadmap packed-CSC)")
def packed_csc_kernel(X, fmt: PackedCSC, bias, alpha=None):
    X = jnp.asarray(X, jnp.float32)
    nnz = fmt._nnz
    # In-kernel base-3 value decode of the packed sign stream.
    p = fmt.packed_values.astype(jnp.int16)
    digits = jnp.stack([(p // (3 ** j)) % 3 for j in range(5)], axis=1).reshape(-1)[:nnz]
    signs = (digits - 3 * (digits >> 1)).astype(jnp.float32)
    vals = jnp.take(X, fmt.row_index, axis=1) * signs[None, :]
    return finish(_segment_cols(vals, fmt.col_ids, fmt.N, sorted_ids=True),
                  bias, alpha)
