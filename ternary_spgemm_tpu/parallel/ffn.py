"""Tensor-parallel SwiGLU FFN over ternary bitplane projections.

Megatron-style FFN tensor parallelism (SURVEY.md §2.3): the gate and up
projections are COLUMN-sharded along ``axis`` (each device owns a slice of
the hidden width), the down projection is ROW-sharded on the same boundary,
so each device runs its whole local SwiGLU — both up-projections, silu·mul,
the per-row int8 requantize, the down-projection — on its own shard, and
the partial outputs meet in one ``psum`` (or ``psum_scatter``) per block.
XLA hands the collective to NCCL.

Numerics: the per-row int8 requantize between the projections happens
per-SHARD — each device scales its own hidden slice, i.e. per-(row, shard)
scale groups. That is a finer quantization grid than the single-device
per-row scale (shard-local maxima are <= the row maximum), and the p=1 case
is the single-device block exactly.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ternary_spgemm_tpu import platform
from ternary_spgemm_tpu.formats import TiledBitplane
from ternary_spgemm_tpu.models.exported import requantize_rows
from ternary_spgemm_tpu.ops import ternary_spgemm
from ternary_spgemm_tpu.parallel.sharding import (
    column_leaf_specs,
    localize,
    row_leaf_specs,
    spec_tree,
)
from ternary_spgemm_tpu.parallel.spgemm import (
    _check_tiled_alignment,
    _shard_map,
)


def swiglu_a8(xq, sx, fmt_gate: TiledBitplane, fmt_up: TiledBitplane,
              fmt_down: TiledBitplane, *, gamma_gate: float = 1.0,
              gamma_up: float = 1.0, gamma_down: float = 1.0):
    """Ternary SwiGLU FFN over int8-quantized activations on one device.

    ``xq`` (M, K) integer-valued with ``|xq| <= 127`` (from
    :func:`~ternary_spgemm_tpu.models.exported.requantize_rows`), ``sx``
    (M, 1) its per-row scale. The three projections are biasless; the
    hidden activations are requantized per row before the down projection
    (the W1.58-A8 regime)."""
    M = xq.shape[0]
    zg = jnp.zeros((fmt_gate.N,), jnp.float32)
    zd = jnp.zeros((fmt_down.N,), jnp.float32)
    k1 = platform.bitplane_a8_kernel(fmt_gate, M)
    k2 = platform.bitplane_a8_kernel(fmt_down, M)
    g = gamma_gate * (sx * ternary_spgemm(xq, fmt_gate, zg, kernel=k1))
    u = gamma_up * (sx * ternary_spgemm(xq, fmt_up, zg, kernel=k1))
    hq, s = requantize_rows(jax.nn.silu(g) * u)
    return ternary_spgemm(hq, fmt_down, zd, kernel=k2) * (s * gamma_down)


def tensor_parallel_fused_swiglu(xq, sx, fmt_gate: TiledBitplane,
                                 fmt_up: TiledBitplane,
                                 fmt_down: TiledBitplane, *, mesh: Mesh,
                                 axis: str,
                                 batch_axis: Optional[str] = None,
                                 scatter_output: bool = False,
                                 gamma_gate: float = 1.0,
                                 gamma_up: float = 1.0,
                                 gamma_down: float = 1.0):
    """Run the SwiGLU FFN block tensor-parallel over ``mesh[axis]``.

    ``xq``/``sx``: int8-quantized activations + per-row scale (replicated
    over ``axis``; optionally sharded along ``batch_axis``). ``fmt_gate``/
    ``fmt_up`` column-sharded along ``axis``; ``fmt_down`` row-sharded on
    the same hidden boundary. Requires the hidden width to split evenly:
    whole storage tiles per device, and ``K2`` alignment per
    :func:`~ternary_spgemm_tpu.parallel.spgemm._check_tiled_alignment`.
    Returns Y replicated (default) or column-sharded (``scatter_output``).
    """
    n_dev = mesh.shape[axis]
    _check_tiled_alignment(fmt_gate, "N")
    _check_tiled_alignment(fmt_up, "N")
    _check_tiled_alignment(fmt_down, "K", n_dev)
    gn = fmt_gate.plane.shape[1]
    if gn % n_dev:
        raise ValueError(
            f"tensor_parallel_fused_swiglu needs the hidden storage tiles "
            f"({gn}) to split evenly over {n_dev} devices")
    if fmt_down.K != fmt_gate.N or fmt_down.K % n_dev:
        raise ValueError(
            f"down projection K={fmt_down.K} must equal the hidden width "
            f"{fmt_gate.N} and split evenly over {n_dev} devices")
    if (fmt_down.K // n_dev) % (8 * fmt_down.tkb):
        raise ValueError(
            f"per-device down-projection shard ({fmt_down.K // n_dev} rows) "
            f"must be a multiple of the K-block (8*tkb={8 * fmt_down.tkb}); "
            "rebuild fmt_down with a smaller tkb")

    gspec = spec_tree(fmt_gate, column_leaf_specs(TiledBitplane, axis))
    dspec = spec_tree(fmt_down, row_leaf_specs(TiledBitplane, axis))
    xspec = P(batch_axis, None)
    yspec = P(batch_axis, axis if scatter_output else None)

    N2 = fmt_down.N
    if scatter_output and N2 % n_dev:
        raise ValueError(
            f"scatter_output needs N2={N2} divisible by {n_dev} devices")

    def local(x, s, fg, fu, fd):
        y = swiglu_a8(x, s, localize(fg), localize(fu), localize(fd),
                      gamma_gate=gamma_gate, gamma_up=gamma_up,
                      gamma_down=gamma_down)
        # localize() reports the PADDED output width (gn*tile_n — it cannot
        # recover the true N from local leaves); the pad columns are exact
        # zeros, slice them before the collective
        y = y[:, :N2]
        if scatter_output:
            return jax.lax.psum_scatter(y, axis, scatter_dimension=1,
                                        tiled=True)
        return jax.lax.psum(y, axis)

    return _shard_map(local, mesh, (xspec, xspec, gspec, gspec, dspec),
                      yspec)(xq, sx, fmt_gate, fmt_up, fmt_down)
