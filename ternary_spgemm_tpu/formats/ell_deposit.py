"""Bit-deposit ELL container — index-stream storage, dense compute.

This layout keeps the *storage* sparse (one int8 local offset per nonzero,
padded to per-tile capacity — bytes scale with 1/s like the reference's
index formats, ``TCSC.h:5-50``) while the compute can stay dense: each
K-superblock's weight tile is rebuilt by depositing each offset as one bit of
a 32-bit word, and the words expand to rows of the ternary tile.

Layout:

* A **superblock** covers ``8 * 31 = 248`` dense rows: 8 int32 deposit words,
  31 data bits each. Bit 31 of every word is the **sentinel**: padding slots
  store offset 31, which decodes to no row.
* ``plane[sb, gn, 8*s + w, n]`` = local dense row (0..30) of the ``s``-th
  nonzero of word ``w``, column ``n`` — slot-major rows, so one slot of all
  8 words is one contiguous slab.
* ``cap_pos/cap_neg[sb, gn]`` = exact per-(superblock, N-tile) slot counts;
  the *storage* pads to the global max — ``size_bytes`` reports the physical
  arrays.

Word ``w``'s offset ``r`` is local row ``w*31 + r`` of its superblock; the
device decoder (``ops/tiled_kernels.decode_ell_deposit``) and ``to_dense``
both use that mapping. :func:`deposit_rowmap` and
:func:`activation_row_order` give the permutation a byte-row decode of the
words produces, for kernels that decode that way.

Reference analogue: the ELL/``VectorTCSC`` family (``VectorTCSC.h:5-73``)
with capacities scanned per tile instead of over all remaining columns
(fixing ``VectorTCSC.h:21``).
"""

from __future__ import annotations

import functools

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.utils import cdiv, round_up

#: Dense rows addressed by one deposit word (bit 31 = sentinel).
WORD_ROWS = 31
#: Deposit words per superblock.
WORDS = 8
#: Dense rows per superblock.
SB_ROWS = WORDS * WORD_ROWS


@functools.lru_cache(maxsize=None)
def deposit_rowmap() -> np.ndarray:
    """(8, 32) table: decoded row of bit ``j`` of deposit word ``w``.

    Derived by simulating the kernel's decode chain (int32 word -> byte rows
    via little-endian bitcast -> nibble magic-multiply deposit -> byte rows)
    on each single-bit word, so format and kernel can never disagree about
    the permutation.
    """
    dec = np.empty((WORDS, 32), np.int64)
    mul, lob = np.uint64(0x00204081), np.uint64(0x01010101)
    for w in range(WORDS):
        for j in range(32):
            word = np.uint64(1) << np.uint64(j)
            rows = np.zeros(32, np.uint64)      # byte rows of the 8 words
            for b in range(4):
                rows[4 * w + b] = (word >> np.uint64(8 * b)) & np.uint64(0xFF)
            lo = ((rows & np.uint64(0xF)) * mul) & lob
            hi = (((rows >> np.uint64(4)) & np.uint64(0xF)) * mul) & lob
            cat = np.zeros(256, np.uint64)
            for u in range(32):
                for b in range(4):
                    cat[4 * u + b] = (lo[u] >> np.uint64(8 * b)) & np.uint64(0xFF)
                    cat[128 + 4 * u + b] = (hi[u] >> np.uint64(8 * b)) & np.uint64(0xFF)
            (p,) = np.nonzero(cat)[0]
            dec[w, j] = p
    return dec


@functools.lru_cache(maxsize=None)
def activation_row_order() -> np.ndarray:
    """(256,) gather indices g: decoded row ``p`` reads restructured
    activation column ``g[p]`` of a (M, 249) superblock slice — ``w*31 + j``
    for data bits, 248 (the appended zero column) for the 8 sentinel rows."""
    dec = deposit_rowmap()
    g = np.full(256, SB_ROWS, np.int32)
    for w in range(WORDS):
        for j in range(WORD_ROWS):
            g[dec[w, j]] = w * WORD_ROWS + j
    return g


@register_format
class TiledEllDeposit(TernaryFormat):
    """Bit-deposit ELL: int8 offset slots, per-tile caps."""

    ARRAY_FIELDS = ("plane", "cap_pos", "cap_neg")

    plane: np.ndarray     # (nsb, gn, 8*CAPS, TN) int8 offsets; sentinel=31
    cap_pos: np.ndarray   # (nsb, gn) int32 exact slot counts
    cap_neg: np.ndarray   # (nsb, gn) int32
    K: int
    N: int
    tile_n: int
    cap_p_max: int        # static slot row where the neg section starts

    @classmethod
    def from_dense(cls, W: np.ndarray, tile_n: int = 4096) -> "TiledEllDeposit":
        # caps are set by the global max anyway, so wide tiles cost no
        # extra padding
        W = _as_int8_dense(W)
        K, N = W.shape
        nsb = cdiv(K, SB_ROWS)
        tile_n = min(tile_n, round_up(N, 128))
        if tile_n % 128:
            raise ValueError(f"tile_n={tile_n} must be a multiple of 128")
        Np = round_up(N, tile_n)
        gn = Np // tile_n
        if K * N >= (1 << 20):
            # native packer (~100x this host's numpy path; bit-exactness
            # property-tested in tests/test_native.py)
            from ternary_spgemm_tpu import native
            packed = native.ell_deposit_arrays(W, tile_n)
            if packed is not None:
                plane, cp, cm = packed
                return cls(plane=plane, cap_pos=cp, cap_neg=cm,
                           K=K, N=N, tile_n=tile_n,
                           cap_p_max=max(int(cp.max()), 1))

        def planes(value):
            mask = np.zeros((nsb * SB_ROWS, Np), bool)
            mask[:K, :N] = (W == value)
            m4 = mask.reshape(nsb, WORDS, WORD_ROWS, Np)
            counts = m4.sum(axis=2, dtype=np.int32)               # (nsb, 8, Np)
            caps = counts.reshape(nsb, WORDS, gn, tile_n).max(axis=(1, 3))
            cap = max(int(caps.max()), 1)
            slot = m4.cumsum(axis=2, dtype=np.int32) - 1
            idx = np.full((nsb, cap, WORDS, Np), WORD_ROWS, dtype=np.int8)
            sb, w, r, n = np.nonzero(m4)
            idx[sb, slot[sb, w, r, n], w, n] = r.astype(np.int8)
            return idx.reshape(nsb, cap * WORDS, Np), caps

        ip, cp = planes(1)
        im, cm = planes(-1)
        cap_p_max = ip.shape[1] // WORDS
        both = np.concatenate([ip, im], axis=1)                   # (nsb, R, Np)
        plane = np.ascontiguousarray(
            both.reshape(nsb, both.shape[1], gn, tile_n).transpose(0, 2, 1, 3))
        return cls(plane=plane, cap_pos=cp, cap_neg=cm,
                   K=K, N=N, tile_n=tile_n, cap_p_max=cap_p_max)

    @property
    def num_superblocks(self) -> int:
        return self.plane.shape[0]

    @property
    def cap_n_max(self) -> int:
        return self.plane.shape[2] // WORDS - self.cap_p_max

    def to_dense(self) -> np.ndarray:
        nsb, gn, R, TN = self.plane.shape
        flat = self.plane.transpose(0, 2, 1, 3).reshape(nsb, R, gn * TN)
        W = np.zeros((nsb * SB_ROWS, gn * TN), np.int8)
        for sb in range(nsb):
            for lo, hi, v in ((0, WORDS * self.cap_p_max, 1),
                              (WORDS * self.cap_p_max, R, -1)):
                rows = flat[sb, lo:hi]
                slots, cols = np.nonzero(rows < WORD_ROWS)
                w = (lo + slots) % WORDS
                W[sb * SB_ROWS + w * WORD_ROWS
                  + rows[slots, cols].astype(np.int64), cols] = v
        return W[:self.K, :self.N]

    def size_bytes(self) -> int:
        # Physical truth: the global-cap padded plane, plus the cap tables.
        return int(self.plane.size
                   + 4 * (self.cap_pos.size + self.cap_neg.size))

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def nnz(self) -> int:
        return int((self.plane < WORD_ROWS).sum())
