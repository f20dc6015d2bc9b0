"""Packed ternary containers — the dense-product physical layouts.

The reference's optimization roadmap calls for compressing the ternary values
("normal CSC with compressed values vector — 1s and -1s, 8 bits for 5
values", ``readme.md:108-111``). On an accelerator with matrix units the
winning strategy inverts the reference's: the multiplies are nearly free, so
at the benchmarked densities (1/2 .. 1/16) the fastest kernel is a *dense*
matmul over compressed ternary weights, decoded right before the product.
Memory traffic per weight value drops to 2 bits (:class:`PackedTernary2Bit`)
or 1.6 bits (:class:`PackedTernary53`) — below even the reference's TCSC
index stream (32/s bits per *dense position*, i.e. 8 bits at s=4).

Stride packing
==============
Both dense packed formats pad K to a multiple of the packing factor ``F`` and
pack along K with **stride** ``Kq = K_pad / F``: the byte at packed row ``k'``
holds the weights of dense rows ``{k' + j*Kq : j < F}``. Decoding field ``j``
of a packed K-tile therefore yields a *contiguous* weight tile for dense rows
``[j*Kq + k0, j*Kq + k0 + tile)`` — a kernel runs F small matmuls against
contiguous X slices and never has to interleave rows, which a
``(Kq, F, N) -> (K, N)`` reshape would require.

Codes are chosen so the all-zero byte decodes to weight 0, making zero-padding
of K free:

* 2-bit: ``code = w & 3`` -> {0: 0, +1: 1, -1: 3}; decode ``w = (c & 1) - (c & 2)``.
* base-3 digit: ``{0: 0, +1: 1, -1: 2}``; decode ``w = d - 3*(d >> 1)``.

:class:`PackedCSC` is the roadmap sparse format itself: standard (not
split-sign) CSC whose value stream is base-3 packed 5-per-byte.
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.utils import cdiv, round_up

_POW3 = np.array([1, 3, 9, 27, 81], dtype=np.uint8)


def pack_signs_base3(signs: np.ndarray) -> np.ndarray:
    """Pack a 1-D stream of {-1,0,+1} into base-3 bytes, 5 values per byte."""
    signs = np.asarray(signs, np.int8)
    n = len(signs)
    n_pad = round_up(max(n, 1), 5)
    digits = np.zeros(n_pad, np.uint8)
    digits[:n] = np.where(signs < 0, 2, signs).astype(np.uint8)
    return (digits.reshape(-1, 5) * _POW3[None, :]).sum(axis=1, dtype=np.uint16).astype(np.uint8)


def unpack_signs_base3(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_signs_base3`; returns ``n`` int8 signs."""
    p = packed.astype(np.uint16)
    digits = np.stack([(p // int(f)) % 3 for f in _POW3], axis=1).reshape(-1)[:n]
    return (digits - 3 * (digits >> 1)).astype(np.int8)


def _pad_k(W: np.ndarray, factor: int) -> np.ndarray:
    K, N = W.shape
    K_pad = round_up(K, factor)
    if K_pad != K:
        W = np.concatenate([W, np.zeros((K_pad - K, N), np.int8)], axis=0)
    return W


@register_format
class PackedTernary2Bit(TernaryFormat):
    """Dense ternary packed 4 values/byte (2-bit codes), stride layout."""

    ARRAY_FIELDS = ("packed",)
    FACTOR = 4

    packed: np.ndarray  # (Kq, N) uint8, Kq = round_up(K, 4) / 4
    K: int
    N: int

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "PackedTernary2Bit":
        W = _as_int8_dense(W)
        K, N = W.shape
        Wp = _pad_k(W, cls.FACTOR)
        Kq = Wp.shape[0] // cls.FACTOR
        codes = (Wp.astype(np.uint8) & 3)          # 0->0, +1->1, -1->3
        fields = codes.reshape(cls.FACTOR, Kq, N)  # field j = rows [j*Kq, (j+1)*Kq)
        packed = np.zeros((Kq, N), np.uint8)
        for j in range(cls.FACTOR):
            packed |= fields[j] << (2 * j)
        return cls(packed=packed, K=K, N=N)

    @property
    def k_quarter(self) -> int:
        return self.packed.shape[0]

    def to_dense(self) -> np.ndarray:
        Kq = self.k_quarter
        out = np.zeros((Kq * self.FACTOR, self.N), np.int8)
        for j in range(self.FACTOR):
            c = (self.packed >> (2 * j)) & 3
            out[j * Kq:(j + 1) * Kq] = (c & 1).astype(np.int8) - (c & 2).astype(np.int8)
        return out[:self.K]

    def size_bytes(self) -> int:
        return int(self.packed.size)

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class PackedTernary53(TernaryFormat):
    """Dense ternary packed 5 values/byte (base-3 codes), stride layout."""

    ARRAY_FIELDS = ("packed",)
    FACTOR = 5

    packed: np.ndarray  # (Kq, N) uint8, Kq = round_up(K, 5) / 5
    K: int
    N: int

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "PackedTernary53":
        W = _as_int8_dense(W)
        K, N = W.shape
        Wp = _pad_k(W, cls.FACTOR)
        Kq = Wp.shape[0] // cls.FACTOR
        digits = np.where(Wp < 0, 2, Wp).astype(np.uint16).reshape(cls.FACTOR, Kq, N)
        packed = np.zeros((Kq, N), np.uint16)
        for j in range(cls.FACTOR):
            packed += digits[j] * int(_POW3[j])
        return cls(packed=packed.astype(np.uint8), K=K, N=N)

    @property
    def k_fifth(self) -> int:
        return self.packed.shape[0]

    def to_dense(self) -> np.ndarray:
        Kq = self.k_fifth
        out = np.zeros((Kq * self.FACTOR, self.N), np.int8)
        p = self.packed.astype(np.uint16)
        for j in range(self.FACTOR):
            d = (p // int(_POW3[j])) % 3
            out[j * Kq:(j + 1) * Kq] = (d - 3 * (d >> 1)).astype(np.int8)
        return out[:self.K]

    def size_bytes(self) -> int:
        return int(self.packed.size)

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class BlockPackedTernary(TernaryFormat):
    """Block-local stride-packed ternary — the single-dot layout.

    The global stride layouts above decode into ``factor`` *separate* weight
    tiles per K-step, forcing ``factor`` small dots per step. Here the stride is
    applied *within blocks of ``factor * tile_kq`` dense rows*: packed row
    ``blk*tile_kq + kq`` holds dense rows ``blk*B + j*tile_kq + kq`` (B =
    ``factor * tile_kq``). Decoding a ``(tile_kq, TN)`` packed tile and
    concatenating the ``factor`` fields along sublanes yields the weight tile
    of B *contiguous* dense rows — one dot against a contiguous X slice,
    no field-reshape of X at all.

    ``factor`` = 4 (2-bit codes) or 5 (base-3 codes); codecs as above. The
    block size couples the physical layout to the kernel's K-tile, exactly
    like the reference's cache-coupled ``BlockedTCSC<B=512>`` (``main.cpp:7``).
    """

    ARRAY_FIELDS = ("packed",)

    packed: np.ndarray  # (nb * tile_kq, N) uint8
    K: int
    N: int
    factor: int
    tile_kq: int

    @classmethod
    def from_dense(cls, W: np.ndarray, factor: int = 4,
                   tile_kq: int = 256) -> "BlockPackedTernary":
        if factor not in (4, 5):
            raise ValueError("factor must be 4 (2-bit) or 5 (base-3)")
        W = _as_int8_dense(W)
        K, N = W.shape
        B = factor * tile_kq
        Wp = _pad_k(W, B)
        nb = Wp.shape[0] // B
        view = Wp.reshape(nb, factor, tile_kq, N)
        if factor == 4:
            codes = (view.astype(np.uint8) & 3)
            packed = np.zeros((nb, tile_kq, N), np.uint8)
            for j in range(4):
                packed |= codes[:, j] << (2 * j)
        else:
            digits = np.where(view < 0, 2, view).astype(np.uint16)
            acc = np.zeros((nb, tile_kq, N), np.uint16)
            for j in range(5):
                acc += digits[:, j] * int(_POW3[j])
            packed = acc.astype(np.uint8)
        return cls(packed=packed.reshape(nb * tile_kq, N), K=K, N=N,
                   factor=factor, tile_kq=tile_kq)

    @property
    def num_blocks(self) -> int:
        return self.packed.shape[0] // self.tile_kq

    def to_dense(self) -> np.ndarray:
        nb, tkq, f = self.num_blocks, self.tile_kq, self.factor
        p = self.packed.reshape(nb, tkq, self.N)
        out = np.zeros((nb, f, tkq, self.N), np.int8)
        for j in range(f):
            if f == 4:
                c = (p >> (2 * j)) & 3
                out[:, j] = (c & 1).astype(np.int8) - (c & 2).astype(np.int8)
            else:
                d = (p.astype(np.uint16) // int(_POW3[j])) % 3
                out[:, j] = (d - 3 * (d >> 1)).astype(np.int8)
        return out.reshape(nb * f * tkq, self.N)[:self.K]

    def size_bytes(self) -> int:
        return int(self.packed.size)

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class PackedCSC(TernaryFormat):
    """Standard CSC with base-3 packed value codes (roadmap format,
    ``readme.md:108-111``): one column-pointer table, one row-index stream,
    and the {-1,+1} value stream packed 5 values/byte."""

    ARRAY_FIELDS = ("col_start", "row_index", "packed_values", "col_ids")

    col_start: np.ndarray      # (N+1,) int32
    row_index: np.ndarray      # (nnz,) int32
    packed_values: np.ndarray  # (ceil(nnz/5),) uint8
    col_ids: np.ndarray        # (nnz,) int32 companion (derived)
    K: int
    N: int
    _nnz: int

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "PackedCSC":
        W = _as_int8_dense(W)
        K, N = W.shape
        n_idx, k_idx = np.nonzero(W.T != 0)  # column-major order
        signs = W.T[n_idx, k_idx]
        counts = np.bincount(n_idx, minlength=N)
        col_start = np.zeros(N + 1, np.int32)
        np.cumsum(counts, out=col_start[1:])
        return cls(col_start=col_start, row_index=k_idx.astype(np.int32),
                   packed_values=pack_signs_base3(signs),
                   col_ids=n_idx.astype(np.int32), K=K, N=N, _nnz=len(k_idx))

    def to_dense(self) -> np.ndarray:
        W = np.zeros((self.K, self.N), np.int8)
        signs = unpack_signs_base3(self.packed_values, self._nnz)
        for n in range(self.N):
            lo, hi = self.col_start[n], self.col_start[n + 1]
            W[self.row_index[lo:hi], n] = signs[lo:hi]
        return W

    def size_bytes(self) -> int:
        return int(4 * (self.N + 1) + 4 * len(self.row_index) + self.packed_values.size)

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return self._nnz


@register_format
class DenseTernary(TernaryFormat):
    """Dense int8 ternary matrix — the trivial container backing the plain
    dense kernels and the correctness oracle."""

    ARRAY_FIELDS = ("dense",)

    dense: np.ndarray  # (K, N) int8
    K: int
    N: int

    @classmethod
    def from_dense(cls, W: np.ndarray) -> "DenseTernary":
        W = _as_int8_dense(W)
        return cls(dense=W, K=W.shape[0], N=W.shape[1])

    def to_dense(self) -> np.ndarray:
        return self.dense

    def size_bytes(self) -> int:
        return int(self.dense.size)

    @property
    def shape(self):
        return (self.K, self.N)
