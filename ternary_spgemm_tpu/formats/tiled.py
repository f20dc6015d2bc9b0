"""Tile-contiguous layouts — the large-shape bandwidth formats.

The containers for large weights store their planes pre-tiled on the host: a
4-D ``(grid_k, grid_n, tile_k, tile_n)`` array whose every kernel block is
one contiguous read, however the full matrix is laid out.

Two containers:

* :class:`TiledDenseTernary` — int8 plane, 8 bits/weight;
* :class:`TiledBlockPacked` — 2-bit or base-3 codes with block-local stride
  (see ``BlockPackedTernary``), 2 / 1.6 bits per weight: here
  ``tile_k = factor * tile_kq`` *is* the stride block, so one packed tile
  decodes into one contiguous weight tile.

Both decode on the device (``ops/tiled_kernels.py``) before an exact dot.
"""

from __future__ import annotations

import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat, _as_int8_dense, register_format
from ternary_spgemm_tpu.formats.packed import _POW3
from ternary_spgemm_tpu.utils import round_up


def _tile4(plane: np.ndarray, tk: int, tn: int) -> np.ndarray:
    """(R, C) -> contiguous (R/tk, C/tn, tk, tn), zero-padding to multiples."""
    R, C = plane.shape
    Rp, Cp = round_up(R, tk), round_up(C, tn)
    if (Rp, Cp) != (R, C):
        p = np.zeros((Rp, Cp), plane.dtype)
        p[:R, :C] = plane
        plane = p
    return np.ascontiguousarray(
        plane.reshape(Rp // tk, tk, Cp // tn, tn).transpose(0, 2, 1, 3))


def _untile4(t4: np.ndarray) -> np.ndarray:
    gk, gn, tk, tn = t4.shape
    return t4.transpose(0, 2, 1, 3).reshape(gk * tk, gn * tn)


@register_format
class TiledDenseTernary(TernaryFormat):
    """Tile-contiguous int8 ternary plane (see module docstring)."""

    ARRAY_FIELDS = ("tiles",)

    tiles: np.ndarray  # (gk, gn, tile_k, tile_n) int8
    K: int
    N: int
    tile_k: int
    tile_n: int

    @classmethod
    def from_dense(cls, W: np.ndarray, tile_k: int = 256,
                   tile_n: int = 4096) -> "TiledDenseTernary":
        W = _as_int8_dense(W)
        K, N = W.shape
        tile_n = min(tile_n, round_up(N, 128))
        tile_k = min(tile_k, round_up(K, 32))
        return cls(tiles=_tile4(W, tile_k, tile_n), K=K, N=N,
                   tile_k=tile_k, tile_n=tile_n)

    def to_dense(self) -> np.ndarray:
        return _untile4(self.tiles)[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.tiles.size)

    @property
    def shape(self):
        return (self.K, self.N)


@register_format
class TiledBlockPacked(TernaryFormat):
    """Tile-contiguous block-local packed codes (see module docstring).

    The K-stride block equals one tile: packed tile ``(b, j)`` holds, at
    packed row ``kq``, the codes of dense rows ``b*factor*tile_kq + f*tile_kq
    + kq`` for fields ``f < factor`` — decoding and concatenating fields
    yields the contiguous dense-row tile ``[b*factor*tile_kq, ...)``.
    """

    ARRAY_FIELDS = ("tiles",)

    tiles: np.ndarray  # (nb, gn, tile_kq, tile_n) uint8
    K: int
    N: int
    factor: int
    tile_kq: int
    tile_n: int

    @classmethod
    def from_dense(cls, W: np.ndarray, factor: int = 4, tile_kq: int = 256,
                   tile_n: int = 4096) -> "TiledBlockPacked":
        if factor not in (4, 5):
            raise ValueError("factor must be 4 (2-bit) or 5 (base-3)")
        W = _as_int8_dense(W)
        K, N = W.shape
        tile_n = min(tile_n, round_up(N, 128))
        B = factor * tile_kq
        Kp, Np = round_up(K, B), round_up(N, tile_n)
        Wp = np.zeros((Kp, Np), np.int8)
        Wp[:K, :N] = W
        nb, gn = Kp // B, Np // tile_n
        view = Wp.reshape(nb, factor, tile_kq, gn, tile_n)
        if factor == 4:
            codes = view.astype(np.uint8) & 3
            packed = np.zeros((nb, tile_kq, gn, tile_n), np.uint8)
            for j in range(4):
                packed |= codes[:, j] << (2 * j)
        else:
            digits = np.where(view < 0, 2, view).astype(np.uint16)
            acc = np.zeros((nb, tile_kq, gn, tile_n), np.uint16)
            for j in range(5):
                acc += digits[:, j] * int(_POW3[j])
            packed = acc.astype(np.uint8)
        return cls(tiles=np.ascontiguousarray(packed.transpose(0, 2, 1, 3)),
                   K=K, N=N, factor=factor, tile_kq=tile_kq, tile_n=tile_n)

    @property
    def num_blocks(self) -> int:
        return self.tiles.shape[0]

    def to_dense(self) -> np.ndarray:
        nb, gn, tkq, tn = self.tiles.shape
        p = self.tiles.transpose(0, 2, 1, 3).reshape(nb, tkq, gn * tn)
        f = self.factor
        out = np.zeros((nb, f, tkq, gn * tn), np.int8)
        for j in range(f):
            if f == 4:
                c = (p >> (2 * j)) & 3
                out[:, j] = (c & 1).astype(np.int8) - (c & 2).astype(np.int8)
            else:
                d = (p.astype(np.uint16) // int(_POW3[j])) % 3
                out[:, j] = (d - 3 * (d >> 1)).astype(np.int8)
        return out.reshape(nb * f * tkq, gn * tn)[:self.K, :self.N]

    def size_bytes(self) -> int:
        return int(self.tiles.size)

    @property
    def shape(self):
        return (self.K, self.N)
