"""Fused bitplane-decode int8 GEMM for Hopper, written in Pallas through Triton.

Decode streams 2-bit weights and is bound by memory bandwidth. The plain XLA
path (:func:`ternary_spgemm_tpu.ops.tiled_kernels.tiled_bitplane_x8_kernel`)
decodes each :class:`~ternary_spgemm_tpu.formats.TiledBitplane` into an int8
matrix before the product, unless XLA fuses the decode into the GEMM. This
kernel never writes that int8 copy: each block loads a ``(tkb, BN)`` slab of
the positive and negative bitplanes, expands bit ``j`` of every byte into an
int8 tile in registers and feeds it straight to an int8 ``dot``.

Layout facts it relies on (``formats/bitplane.py``): bit ``j`` of byte-row
``t`` in a K-block holds dense row ``4t + j`` for ``j < 4`` and
``4*tkb + 4t + (j - 4)`` for ``j >= 4``. Permuting the activation columns of
each K-block to the order ``(j, t)`` outside the kernel (a cheap copy of the
small ``(M, K)`` operand) turns every bit into one ``(BM, tkb) x (tkb, BN)``
product against a contiguous activation slice.

The grid is ``(M blocks, N blocks, K splits)``. At decode there are only
``N / BN`` column blocks, fewer than the card's 132 SMs, so the K-blocks are
split across programs and a second pass (an XLA reduction) sums the int32
partials. Integer sums are exact in any order, so the result does not depend
on the split.

The kernel compiles only for a GPU. It runs in Pallas' interpreter only when
the caller passes ``interpret=True`` (the CPU tests do).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ternary_spgemm_tpu import platform
from ternary_spgemm_tpu.formats import TiledBitplane
from ternary_spgemm_tpu.ops.api import finish, register_kernel
from ternary_spgemm_tpu.utils import cdiv, round_up

#: Column block: one program's output width. Must divide the format's tile_n.
BLOCK_N = 128
#: Programs the grid aims for: two waves of the H100's 132 SMs.
TARGET_PROGRAMS = 264
#: Triton launch parameters (warps per program, software-pipeline stages).
NUM_WARPS, NUM_STAGES = 4, 3


def supports(fmt: TiledBitplane) -> bool:
    """Whether the format's layout fits the kernel's block shapes: Triton
    wants power-of-two tiles, and an int8 ``dot`` wants a depth of 32."""
    tkb = fmt.tkb
    return (tkb >= 32 and tkb & (tkb - 1) == 0
            and fmt.tile_n % BLOCK_N == 0)


def _block_m(M: int) -> int:
    """Row block: 16 (the int8 dot's minimum) up to 64, as a power of two."""
    return min(64, max(16, 1 << (M - 1).bit_length()))


def split_k(nb: int, programs: int):
    """``(splits, per_split)``: K-blocks per program so that the grid has
    about :data:`TARGET_PROGRAMS` programs; every block lands in exactly
    one split and no split is empty."""
    splits = max(1, min(nb, cdiv(TARGET_PROGRAMS, programs)))
    per_split = cdiv(nb, splits)
    return cdiv(nb, per_split), per_split


def _permute_activations(x8, tkb: int, nb: int):
    """Reorder each K-block's columns from dense-row order to (bit, byte-row)
    order, so bit ``j`` of the plane pairs with columns ``[j*tkb, (j+1)*tkb)``
    of the block."""
    Mp = x8.shape[0]
    return (x8.reshape(Mp, nb, 2, tkb, 4).transpose(0, 1, 2, 4, 3)
            .reshape(Mp, nb * 8 * tkb))


def _kernel(x_ref, p_ref, o_ref, *, tkb: int, nb: int, per_split: int):
    B = 8 * tkb
    lo = pl.program_id(2) * per_split
    hi = jnp.minimum(nb, lo + per_split)

    def body(kb, acc):
        pos = p_ref[kb, pl.ds(0, tkb), :]
        neg = p_ref[kb, pl.ds(tkb, tkb), :]
        for j in range(8):
            w = (((pos >> j) & 1).astype(jnp.int8)
                 - ((neg >> j) & 1).astype(jnp.int8))
            x = x_ref[:, pl.ds(kb * B + j * tkb, tkb)]
            acc += pl.dot(x, w)
        return acc

    acc = jax.lax.fori_loop(lo, hi, body, jnp.zeros(o_ref.shape, jnp.int32))
    o_ref[...] = acc


def bitplane_x8_partials(x8, fmt: TiledBitplane, *,
                         interpret: bool = False):
    """int8 activations ``(M, K)`` times the bitplane weights, as int32
    partial sums ``(splits, Mp, Np)`` over K-splits (sum them for the
    product). ``interpret=True`` runs Pallas' interpreter; otherwise the
    kernel is compiled through Triton and needs a GPU."""
    if not interpret and platform.backend() != "gpu":
        raise RuntimeError(
            "the Triton bitplane kernel compiles only for a GPU; pass "
            "interpret=True to run it in Pallas' interpreter")
    if not supports(fmt):
        raise ValueError(
            f"TiledBitplane(tkb={fmt.tkb}, tile_n={fmt.tile_n}) does not fit "
            f"the kernel: tkb must be a power of two >= 32 and tile_n a "
            f"multiple of {BLOCK_N}")
    M = x8.shape[0]
    tkb, tn = fmt.tkb, fmt.tile_n
    nb, gn = fmt.plane.shape[0], fmt.plane.shape[1]
    B = 8 * tkb
    BM = _block_m(M)
    Mp = round_up(M, BM)
    q = tn // BLOCK_N
    gm, gc = Mp // BM, gn * q
    splits, per_split = split_k(nb, gm * gc)
    x8 = jnp.pad(x8, ((0, Mp - M), (0, nb * B - x8.shape[1])))
    xp = _permute_activations(x8, tkb, nb)
    return pl.pallas_call(
        functools.partial(_kernel, tkb=tkb, nb=nb, per_split=per_split),
        grid=(gm, gc, splits),
        in_specs=[
            pl.BlockSpec((BM, nb * B), lambda i, c, s: (i, 0)),
            pl.BlockSpec((nb, None, 2 * tkb, BLOCK_N),
                         lambda i, c, s: (0, c // q, 0, c % q)),
        ],
        out_specs=pl.BlockSpec((None, BM, BLOCK_N), lambda i, c, s: (s, i, c)),
        out_shape=jax.ShapeDtypeStruct((splits, Mp, gn * tn), jnp.int32),
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="bitplane_x8",
    )(xp, fmt.plane)


def to_x8(X):
    """Integer-valued activations -> int8, clamped to [-127, 127]."""
    t = jnp.round(jnp.asarray(X, jnp.float32))
    return jnp.clip(t, -127.0, 127.0).astype(jnp.int8)


@register_kernel(
    "TritonTiledBitplane_x8", TiledBitplane,
    description="split-sign bitplanes (2 bits/weight) decoded in registers "
                "and fed to int8 dots, int32 accumulation, split-K with an "
                "XLA reduction (Pallas through Triton; exact for integer "
                "activations |x|<=127, clamps outside)",
    reference="readme.md:108-111 roadmap codec; BitNet W1.58-A8 regime "
              "(SURVEY.md §6)",
    gpu_only=True, x_absmax=127, x_bytes=1.0)
def triton_tiled_bitplane_x8_kernel(X, fmt: TiledBitplane, bias, alpha=None,
                                    *, interpret: bool = False):
    M = X.shape[0]
    parts = bitplane_x8_partials(to_x8(X), fmt, interpret=interpret)
    Y = parts.sum(axis=0)[:M, :fmt.N].astype(jnp.float32)
    return finish(Y, bias, alpha)
