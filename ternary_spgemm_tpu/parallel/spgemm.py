"""Sharded ternary SpMM under ``shard_map`` with XLA collectives.

The distributed layer the reference never had (SURVEY.md §2.3). Three
execution schemes over a :class:`jax.sharding.Mesh`, all wrapping the same
single-device kernel registry (``ops/``):

* :func:`column_sharded_spgemm` — weight columns, bias, alpha, and output
  columns sharded along ``axis``; X replicated (or additionally sharded along
  an optional ``batch_axis`` for 2-D data x model parallelism). No
  collectives in the hot path — per-column ternary streams are shard-local.
* :func:`row_sharded_spgemm` — weight rows and X columns sharded along
  ``axis``; partial outputs reduced with ``psum`` (replicated Y) or
  ``psum_scatter`` (column-sharded Y). Bias/PReLU applied once, after the
  reduction (the epilogue does not commute with the sum).
* :func:`overlapped_gather_spgemm` — the BASELINE.json multi-host config: X
  arrives row(M)-sharded, weights column-sharded; a ``ppermute`` ring rotates
  X chunks so each device computes its output-column block for every row
  chunk while the next chunk is in flight — the all-gather is *overlapped*
  with compute instead of materialized up front (collective-matmul pattern;
  XLA schedules the permute DMA concurrently with the per-step kernel).

All three take any kernel registered for the container's format; containers
must be one of the rectangular SHARDABLE_FORMATS (``parallel/sharding.py``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ternary_spgemm_tpu.ops import ternary_spgemm
from ternary_spgemm_tpu.parallel.sharding import (
    column_leaf_specs,
    localize,
    row_leaf_specs,
    spec_tree,
)


def _check_tiled_alignment(fmt, dim: str, nshards: int = 1):
    """Blocked/tiled containers pad N (and K) to tile multiples; sharding
    along a padded dimension only lines up with the true-N bias/X shards when
    the dimension is an exact tile multiple — otherwise shard boundaries fall
    inside tiles (or a padded last K-block decodes dense rows beyond the
    device's X column shard) and results are silently wrong."""
    from ternary_spgemm_tpu.formats import (
        BlockedEllTCSC, BlockPackedTernary, TiledBlockPacked,
        TiledBitplane, TiledDenseTernary, TiledEllDeposit, TiledEllTCSC)

    if isinstance(fmt, (TiledDenseTernary, TiledBlockPacked)):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding a tiled container requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<128-multiple divisor of N>)")
        if dim == "K":
            blk = (fmt.tile_k if isinstance(fmt, TiledDenseTernary)
                   else fmt.factor * fmt.tile_kq)
            if fmt.K % blk:
                raise ValueError(
                    f"row-sharding a tiled container requires K % {blk} == 0 "
                    f"(K={fmt.K}); rebuild with a K-tile dividing K")
    elif isinstance(fmt, BlockPackedTernary):
        # A padded last K-block makes per-shard packed rows decode dense rows
        # beyond the device's X column shard (silently wrong partial sums).
        blk = fmt.factor * fmt.tile_kq
        if dim == "K":
            if fmt.K % blk:
                raise ValueError(
                    f"row-sharding BlockPackedTernary requires K % (factor*"
                    f"tile_kq) == 0 (K={fmt.K}, factor={fmt.factor}, "
                    f"tile_kq={fmt.tile_kq}); rebuild with a block size "
                    f"dividing K")
            # The packed plane's dim-0 unit is a packed row (finer than a
            # block), so the shard boundary must also land on a block edge.
            nb = fmt.K // blk
            if nb % nshards:
                raise ValueError(
                    f"row-sharding BlockPackedTernary over {nshards} devices "
                    f"requires the device count to divide the block count "
                    f"({nb} = K/(factor*tile_kq)); a shard boundary inside a "
                    f"packed block decodes the wrong dense rows")
    elif isinstance(fmt, TiledBitplane):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding TiledBitplane requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<128-multiple divisor of N>)")
        if dim == "K" and fmt.K % (8 * fmt.tkb):
            raise ValueError(
                f"row-sharding TiledBitplane requires K % (8*tkb) == 0 "
                f"(K={fmt.K}, tkb={fmt.tkb}); rebuild with a block "
                f"dividing K")
    elif isinstance(fmt, TiledEllDeposit):
        from ternary_spgemm_tpu.formats.ell_deposit import SB_ROWS
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding TiledEllDeposit requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<128-multiple divisor of N>)")
        if dim == "K" and fmt.K % SB_ROWS:
            raise ValueError(
                f"row-sharding TiledEllDeposit requires K % {SB_ROWS} == 0 "
                f"(K={fmt.K}); a shard boundary inside a deposit superblock "
                f"maps activations to the wrong decoded rows")
    elif isinstance(fmt, TiledEllTCSC):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding TiledEllTCSC requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<divisor of N>)")
        if dim == "K" and fmt.K % fmt.block_k:
            raise ValueError(
                f"row-sharding TiledEllTCSC requires K % block_k == 0 "
                f"(K={fmt.K}, block_k={fmt.block_k}); rebuild with "
                f"from_dense(..., block_k=<divisor of K, <=127>)")
    elif isinstance(fmt, BlockedEllTCSC):
        if dim == "N" and fmt.N % fmt.tile_n:
            raise ValueError(
                f"column-sharding BlockedEllTCSC requires N % tile_n == 0 "
                f"(N={fmt.N}, tile_n={fmt.tile_n}); rebuild with "
                f"from_dense(..., tile_n=<divisor of N>)")
        if dim == "K" and fmt.K % fmt.block_k:
            raise ValueError(
                f"row-sharding BlockedEllTCSC requires K % block_k == 0 "
                f"(K={fmt.K}, block_k={fmt.block_k}); rebuild with "
                f"from_dense(..., block_k=<divisor of K>)")


def _shard_map(fn, mesh, in_specs, out_specs):
    # check_vma=False: pallas_call's out_shape carries no varying-manual-axes
    # annotation, so jax 0.9's vma typing rejects Pallas kernels inside
    # shard_map otherwise.
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def column_sharded_spgemm(X, fmt, bias, alpha=None, *, mesh: Mesh, axis: str,
                          batch_axis: Optional[str] = None,
                          kernel: Optional[str] = None):
    """Output-column-parallel SpMM: Y[:, n_local] = X @ W[:, n_local] + b_local.

    ``fmt``/``bias``/``alpha`` leaves must be (or will be re-laid-out as)
    sharded along ``axis``; X replicated over ``axis`` and optionally sharded
    along ``batch_axis``. Returns Y sharded (batch_axis, axis).
    """
    _check_tiled_alignment(fmt, "N")
    fspec = spec_tree(fmt, column_leaf_specs(type(fmt), axis))
    xspec = P(batch_axis, None)
    yspec = P(batch_axis, axis)

    if alpha is None:
        def local(x, f, b):
            return ternary_spgemm(x, localize(f), b, None, kernel=kernel)
        return _shard_map(local, mesh, (xspec, fspec, P(axis)), yspec)(X, fmt, bias)

    def local(x, f, b, a):
        return ternary_spgemm(x, localize(f), b, a, kernel=kernel)
    return _shard_map(local, mesh, (xspec, fspec, P(axis), P(axis)), yspec)(
        X, fmt, bias, alpha)


def row_sharded_spgemm(X, fmt, bias, alpha=None, *, mesh: Mesh, axis: str,
                       batch_axis: Optional[str] = None,
                       scatter_output: bool = False,
                       kernel: Optional[str] = None):
    """Contraction-parallel SpMM: partial Y from K/d rows, reduced over ``axis``.

    The kernel runs with a zero bias; bias + optional PReLU are applied after
    the reduction (the PReLU epilogue does not commute with ``psum``). With
    ``scatter_output`` the reduction is ``psum_scatter`` and Y comes back
    column-sharded along ``axis``.
    """
    _check_tiled_alignment(fmt, "K", mesh.shape[axis])
    fspec = spec_tree(fmt, row_leaf_specs(type(fmt), axis))
    xspec = P(batch_axis, axis)
    yspec = P(batch_axis, axis if scatter_output else None)
    bspec = P(axis) if scatter_output else P()

    from ternary_spgemm_tpu.ops.api import finish

    def local(x, f, b, a):
        floc = localize(f)
        zero_b = jnp.zeros((floc.N,), jnp.float32)
        y = ternary_spgemm(x, floc, zero_b, None, kernel=kernel)
        if scatter_output:
            y = jax.lax.psum_scatter(y, axis, scatter_dimension=1, tiled=True)
        else:
            y = jax.lax.psum(y, axis)
        return finish(y, b, a)

    if alpha is None:
        f2 = lambda x, f, b: local(x, f, b, None)
        return _shard_map(f2, mesh, (xspec, fspec, bspec), yspec)(X, fmt, bias)
    return _shard_map(local, mesh, (xspec, fspec, bspec, bspec), yspec)(
        X, fmt, bias, alpha)


def overlapped_gather_spgemm(X, fmt, bias, alpha=None, *, mesh: Mesh, axis: str,
                             kernel: Optional[str] = None):
    """Ring-overlapped activation gather x column-parallel SpMM.

    X arrives row(M)-sharded along ``axis`` (chunk d on device d); W/bias/
    alpha column-sharded. Step t: every device computes its output-column
    block for the chunk it currently holds — rows ``(me - t) mod d`` — while
    ``ppermute`` forwards the chunk to the next device. After d steps each
    device has its full (M, N/d) output block without ever materializing the
    gathered (M, K) activations; XLA overlaps each permute with the step's
    kernel (collective-matmul / "How to Scale Your Model" recipe).
    Returns Y sharded (None, axis).
    """
    _check_tiled_alignment(fmt, "N")
    fspec = spec_tree(fmt, column_leaf_specs(type(fmt), axis))
    has_alpha = alpha is not None

    def local(x_chunk, f, b, *maybe_a):
        a = maybe_a[0] if has_alpha else None
        d = jax.lax.axis_size(axis)
        me = jax.lax.axis_index(axis)
        floc = localize(f)
        m_chunk = x_chunk.shape[0]
        n_local = floc.N

        def step(t, carry):
            chunk, y = carry
            yt = ternary_spgemm(chunk, floc, b, a, kernel=kernel)
            owner = (me - t) % d
            y = jax.lax.dynamic_update_slice(y, yt, (owner * m_chunk, 0))
            # forward our current chunk around the ring (skipped result unused
            # on the last step but kept unconditional for a static schedule)
            chunk = jax.lax.ppermute(
                chunk, axis, [(i, (i + 1) % d) for i in range(d)])
            return chunk, y

        # mark the accumulator as varying over the mesh axis (the loop carry
        # must type-match the ppermute'd chunk even with check_vma off)
        y0 = jnp.zeros((d * m_chunk, n_local), jnp.float32)
        y0 = jax.lax.pcast(y0, axis, to="varying")
        _, y = jax.lax.fori_loop(0, d, step, (x_chunk, y0), unroll=True)
        return y

    args = (X, fmt, bias) + ((alpha,) if has_alpha else ())
    in_specs = (P(axis, None), fspec, P(axis)) + ((P(axis),) if has_alpha else ())
    return _shard_map(local, mesh, in_specs, P(None, axis))(*args)
