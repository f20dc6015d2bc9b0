"""Plain-XLA kernels for the tiled containers: decode on the device, then dot.

Each tiled format gets one jittable decoder that mirrors its host
``to_dense`` (same layout facts, in ``jax.numpy``), and one exact kernel: the
decoded int8 matrix widened to float32 and multiplied at
``Precision.HIGHEST``, which is exact for integer activations. XLA fuses the
decode into one elementwise pass; whether it also fuses it into the product
is XLA's choice, visible only in a device trace.

:class:`~ternary_spgemm_tpu.formats.TiledBitplane`, the serving format, also
gets an int8-native kernel: int8 activations times the decoded int8 plane
with int32 accumulation. It is the baseline the fused Triton kernel
(``ops/triton_bitplane.py``) has to beat.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ternary_spgemm_tpu.formats import (
    BlockPackedTernary,
    TiledBitplane,
    TiledBlockPacked,
    TiledDenseTernary,
    TiledEllDeposit,
    TiledEllTCSC,
    TiledNibblePair,
)
from ternary_spgemm_tpu.formats.ell_deposit import SB_ROWS, WORD_ROWS, WORDS
from ternary_spgemm_tpu.formats.packed import _POW3
from ternary_spgemm_tpu.ops.api import finish, register_kernel
from ternary_spgemm_tpu.ops.triton_bitplane import to_x8


# ---------------------------------------------------------------------------
# Device decoders: container arrays -> (K, N) int8, equal to fmt.to_dense()
# ---------------------------------------------------------------------------


def decode_bitplane(fmt: TiledBitplane):
    """Bit ``j`` of byte-row ``t`` is dense row ``4t + j`` (``j < 4``) or
    ``4*tkb + 4t + j - 4`` (``j >= 4``) of its K-block."""
    nb, gn, _, tn = fmt.plane.shape
    tkb = fmt.tkb
    shifts = jnp.arange(8, dtype=jnp.uint8)[None, None, :, None, None]

    def bits(p):                       # (nb, gn, tkb, tn) -> (nb, gn, 8, tkb, tn)
        return ((p[:, :, None] >> shifts) & 1).astype(jnp.int8)

    w = bits(fmt.plane[:, :, :tkb]) - bits(fmt.plane[:, :, tkb:])
    # (nb, gn, half, jj, t, tn) -> rows (nb, half, t, jj), columns (gn, tn)
    w = w.reshape(nb, gn, 2, 4, tkb, tn).transpose(0, 2, 4, 3, 1, 5)
    return w.reshape(nb * 8 * tkb, gn * tn)[:fmt.K, :fmt.N]


def decode_nibble_pair(fmt: TiledNibblePair):
    """Byte ``b`` of word-row ``t`` holds nibble-row ``4t + b``: its low
    nibble is dense row ``4t + b`` of the K-block, its high nibble row
    ``4*tkb + 4t + b``; nibbles are 4-bit two's complement."""
    nb, gn, tkb, tn = fmt.words.shape
    sh = 8 * jnp.arange(4, dtype=jnp.int32)
    byte = (fmt.words[..., None] >> sh) & 0xFF         # (nb, gn, tkb, tn, 4)
    sx = lambda v: (((v + 8) & 0xF) - 8).astype(jnp.int8)
    w = jnp.stack([sx(byte & 0xF), sx(byte >> 4)], axis=2)
    # (nb, gn, half, t, tn, b) -> rows (nb, half, t, b), columns (gn, tn)
    w = w.transpose(0, 2, 3, 5, 1, 4)
    return w.reshape(nb * 8 * tkb, gn * tn)[:fmt.K, :fmt.N]


def _decode_fields(p, factor: int):
    """Packed codes ``(..., R, C)`` -> ``(..., factor, R, C)`` int8 fields:
    2-bit codes ``w = (c & 1) - (c & 2)``, base-3 digits ``w = d - 3*(d >> 1)``."""
    fields = []
    for j in range(factor):
        if factor == 4:
            c = (p >> (2 * j)) & 3
            fields.append((c & 1).astype(jnp.int8) - (c & 2).astype(jnp.int8))
        else:
            d = (p.astype(jnp.int32) // int(_POW3[j])) % 3
            fields.append((d - 3 * (d >> 1)).astype(jnp.int8))
    return jnp.stack(fields, axis=-3)


def decode_block_packed(fmt: BlockPackedTernary):
    """Packed row ``blk*tile_kq + kq`` holds dense rows
    ``blk*factor*tile_kq + j*tile_kq + kq`` in field ``j``."""
    tkq, f, N = fmt.tile_kq, fmt.factor, fmt.N
    nb = fmt.packed.shape[0] // tkq
    w = _decode_fields(fmt.packed.reshape(nb, tkq, N), f)   # (nb, f, tkq, N)
    return w.reshape(nb * f * tkq, N)[:fmt.K]


def decode_tiled_dense(fmt: TiledDenseTernary):
    gk, gn, tk, tn = fmt.tiles.shape
    w = fmt.tiles.transpose(0, 2, 1, 3).reshape(gk * tk, gn * tn)
    return w[:fmt.K, :fmt.N]


def decode_tiled_block_packed(fmt: TiledBlockPacked):
    """Tile ``(b, g)`` holds, at packed row ``kq``, field ``j`` of dense row
    ``b*factor*tile_kq + j*tile_kq + kq``."""
    nb, gn, tkq, tn = fmt.tiles.shape
    p = fmt.tiles.transpose(0, 2, 1, 3).reshape(nb, tkq, gn * tn)
    w = _decode_fields(p, fmt.factor)                      # (nb, f, tkq, Np)
    return w.reshape(nb * fmt.factor * tkq, gn * tn)[:fmt.K, :fmt.N]


def _one_hot_rows(offsets, n_rows: int):
    """``offsets (..., S, C)`` -> ``(..., n_rows, C)`` int8 counts of each
    row value over the slot axis (negative offsets are empty slots)."""
    r = jnp.arange(n_rows, dtype=jnp.int32)[:, None, None]
    return (offsets[..., None, :, :] == r).sum(axis=-2, dtype=jnp.int8)


def decode_tiled_ell(fmt: TiledEllTCSC):
    """Plane rows ``[0, cap_p_max)`` hold positive, the rest negative local
    offsets; offset ``block_k`` is the empty-slot sentinel."""
    nb, gn, caps, tn = fmt.plane.shape
    bk = fmt.block_k
    flat = fmt.plane.transpose(0, 2, 1, 3).reshape(nb, caps, gn * tn)
    flat = jnp.where(flat < bk, flat.astype(jnp.int32), -1)
    cp = fmt.cap_p_max
    w = _one_hot_rows(flat[:, :cp], bk) - _one_hot_rows(flat[:, cp:], bk)
    return w.reshape(nb * bk, gn * tn)[:fmt.K, :fmt.N]


def decode_ell_deposit(fmt: TiledEllDeposit):
    """Plane row ``8*s + w`` holds slot ``s`` of deposit word ``w``: local
    row ``w*31 + offset`` of the superblock; offset 31 is the sentinel.
    Rows ``[0, 8*cap_p_max)`` are positive, the rest negative."""
    nsb, gn, R, tn = fmt.plane.shape
    flat = fmt.plane.transpose(0, 2, 1, 3).reshape(nsb, R, gn * tn)
    word = (jnp.arange(R, dtype=jnp.int32) % WORDS)[None, :, None]
    off = flat.astype(jnp.int32)
    local = jnp.where(off < WORD_ROWS, word * WORD_ROWS + off, -1)
    cp = WORDS * fmt.cap_p_max
    w = (_one_hot_rows(local[:, :cp], SB_ROWS)
         - _one_hot_rows(local[:, cp:], SB_ROWS))
    return w.reshape(nsb * SB_ROWS, gn * tn)[:fmt.K, :fmt.N]


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def exact_dot(X, W8, bias, alpha=None):
    """``X @ W8 + bias`` (then PReLU) in float32 at ``Precision.HIGHEST``:
    exact for integer activations whatever the card's default precision."""
    X = jnp.asarray(X, jnp.float32)
    Y = jnp.dot(X, W8.astype(jnp.float32), precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
    return finish(Y, bias, alpha)


def _register_exact(name, format_cls, decoder, reference):
    @register_kernel(
        name, format_cls,
        description=f"device decode of the {format_cls.__name__} layout, "
                    "then an exact float32 dot (Precision.HIGHEST)",
        reference=reference)
    def kernel(X, fmt, bias, alpha=None):
        # K from the activation side: under shard_map the container's
        # static K may describe the unsharded matrix
        return exact_dot(X, decoder(fmt)[:X.shape[1]], bias, alpha)

    kernel.__name__ = f"{name.lower()}_kernel"
    return kernel


tiled_bitplane_kernel = _register_exact(
    "TiledBitplane", TiledBitplane, decode_bitplane,
    "readme.md:108-111 roadmap codec (2 bits/weight, split-sign planes)")
tiled_nibble_pair_kernel = _register_exact(
    "TiledNibblePair", TiledNibblePair, decode_nibble_pair,
    "readme.md:108-111 roadmap codec (4-bit signed nibbles)")
block_packed_kernel = _register_exact(
    "BlockPacked", BlockPackedTernary, decode_block_packed,
    "readme.md:108-111 roadmap codec (block-local stride packing)")
tiled_dense_kernel = _register_exact(
    "TiledDense", TiledDenseTernary, decode_tiled_dense,
    "the reference's dense GEMM (sparseUtils.h:93-108) over tiled int8")
tiled_block_packed_kernel = _register_exact(
    "TiledBlockPacked", TiledBlockPacked, decode_tiled_block_packed,
    "readme.md:108-111 roadmap codec (tile-contiguous block packing)")
tiled_ell_kernel = _register_exact(
    "TiledEll", TiledEllTCSC, decode_tiled_ell,
    "cpp_impl/data_structures/VectorTCSC.h:5-73 (padded ELL)")
ell_deposit_kernel = _register_exact(
    "EllDeposit", TiledEllDeposit, decode_ell_deposit,
    "cpp_impl/data_structures/VectorTCSC.h:5-73 (ELL with per-tile caps)")


@register_kernel(
    "TiledBitplane_x8", TiledBitplane,
    description="device decode of the split-sign bitplanes, then an int8 x "
                "int8 -> int32 dot (exact for integer activations |x|<=127, "
                "clamps outside)",
    reference="BitNet W1.58-A8 regime (SURVEY.md §6)",
    x_absmax=127, x_bytes=1.0)
def tiled_bitplane_x8_kernel(X, fmt: TiledBitplane, bias, alpha=None):
    W8 = decode_bitplane(fmt)[:X.shape[1]]
    # precision pinned: an ambient default_matmul_precision("highest")
    # must not attach float32 contract precision to an integer dot
    Y = jax.lax.dot_general(to_x8(X), W8, (((1,), (0,)), ((), ())),
                            precision=jax.lax.Precision.DEFAULT,
                            preferred_element_type=jnp.int32)
    return finish(Y.astype(jnp.float32), bias, alpha)
