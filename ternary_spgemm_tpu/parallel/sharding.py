"""Device-mesh sharding of ternary containers.

Net-new capability (the reference is strictly single-thread/single-node,
SURVEY.md §2.3): partition the ternary weight across a ``jax.sharding.Mesh``
and run the SpMM under ``shard_map`` with XLA collectives over ICI/DCN.

Supported weight partitionings (BASELINE.json's multi-host config is
column-parallel at N=65536):

* **Column (output) parallel** — each device owns ``N/d`` weight columns plus
  the matching bias/alpha slice; X is replicated (or all-gathered); the local
  SpMM produces the device's Y columns; no reduction needed. Natural for
  split-sign CSC semantics: per-column streams never cross shards.
* **Row (contraction) parallel** — each device owns ``K/d`` weight rows and
  the matching X column-slice; partial products combine with ``psum`` /
  ``psum_scatter``.
* **Data parallel** — X sharded along M, weights replicated; composes with
  either of the above on a 2-D mesh (``parallel/spgemm.py``).

Only the *rectangular* physical containers shard: ``DenseTernary``,
``PackedTernary2Bit``/``53``/``BlockPackedTernary`` (byte planes shard along
N; row-parallel only for the block-local ``BlockPackedTernary`` — see
``row_leaf_specs``), and ``BlockedEllTCSC`` (planes shard along padded-N;
row-parallel along the K-block axis, since local offsets never cross
blocks). The 1-D stream
formats (TCSC/TCSR/interleaved) have data-dependent per-column nnz, so
equal-size static shards do not exist — shard their rectangular companions
instead. That asymmetry follows from SPMD compilation, which needs static
shapes; it is not a limitation.
"""

from __future__ import annotations

from typing import Type

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ternary_spgemm_tpu.formats import (
    BlockedEllTCSC,
    BlockPackedTernary,
    DenseTernary,
    PackedTernary2Bit,
    PackedTernary53,
    TiledBitplane,
    TiledBlockPacked,
    TiledDenseTernary,
    TiledEllDeposit,
    TiledEllTCSC,
)
from ternary_spgemm_tpu.formats.base import TernaryFormat

#: Formats with rectangular leaves, shardable under SPMD.
SHARDABLE_FORMATS = (DenseTernary, PackedTernary2Bit, PackedTernary53,
                     BlockPackedTernary, BlockedEllTCSC,
                     TiledDenseTernary, TiledBlockPacked, TiledEllTCSC,
                     TiledBitplane, TiledEllDeposit)


def make_mesh(shape: dict, *, devices=None) -> Mesh:
    """Create a mesh from ``{"axis": size}`` over the default (or given)
    devices, validating the device count."""
    names = tuple(shape)
    sizes = tuple(shape[n] for n in names)
    n = int(np.prod(sizes))
    devs = list(devices if devices is not None else jax.devices())
    if n > len(devs):
        raise ValueError(f"mesh {shape} needs {n} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n]).reshape(sizes), names)


def _leaf_specs(format_cls: Type[TernaryFormat], axis: str, dim_for: dict):
    """Build per-ARRAY_FIELDS PartitionSpecs, placing ``axis`` at the dim
    given by ``dim_for[field]`` (ndim known per format)."""
    specs = []
    for f in format_cls.ARRAY_FIELDS:
        nd, d = dim_for[f]
        spec = [None] * nd
        if d is not None:
            spec[d] = axis
        specs.append(P(*spec))
    return specs


def column_leaf_specs(format_cls: Type[TernaryFormat], axis: str):
    """PartitionSpecs (ARRAY_FIELDS order) sharding along output columns N."""
    if format_cls is DenseTernary:
        return _leaf_specs(format_cls, axis, {"dense": (2, 1)})
    if format_cls in (PackedTernary2Bit, PackedTernary53, BlockPackedTernary):
        return _leaf_specs(format_cls, axis, {"packed": (2, 1)})
    if format_cls in (TiledDenseTernary, TiledBlockPacked):
        return _leaf_specs(format_cls, axis, {"tiles": (4, 1)})  # shard grid_n
    if format_cls is BlockedEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "idx_pos": (3, 2), "idx_neg": (3, 2),
            "tile_cap_pos": (2, 1), "tile_cap_neg": (2, 1)})
    if format_cls is TiledEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 1), "cap_pos": (2, 1), "cap_neg": (2, 1)})
    if format_cls is TiledBitplane:
        return _leaf_specs(format_cls, axis, {"plane": (4, 1)})
    if format_cls is TiledEllDeposit:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 1), "cap_pos": (2, 1), "cap_neg": (2, 1)})
    raise TypeError(
        f"{format_cls.__name__} is not column-shardable (ragged 1-D streams); "
        "use one of " + ", ".join(c.__name__ for c in SHARDABLE_FORMATS))


def row_leaf_specs(format_cls: Type[TernaryFormat], axis: str):
    """PartitionSpecs (ARRAY_FIELDS order) sharding along contraction rows K.

    The *globally* stride-packed planes (PackedTernary2Bit/53) are NOT
    row-shardable: a contiguous chunk of packed rows encodes non-contiguous
    dense rows (field j of packed row k' = dense row j*Kq + k'), so a
    shard's bytes cannot pair with a contiguous X K-slice.
    BlockPackedTernary is — its stride is local to ``factor*tile_kq``-row
    blocks, so block-aligned shards decode contiguous dense rows (the shard
    count must divide the block count).
    """
    if format_cls is DenseTernary:
        return _leaf_specs(format_cls, axis, {"dense": (2, 0)})
    if format_cls is BlockPackedTernary:
        return _leaf_specs(format_cls, axis, {"packed": (2, 0)})
    if format_cls in (PackedTernary2Bit, PackedTernary53):
        raise TypeError(
            f"{format_cls.__name__} is not row-shardable (global stride "
            "packing interleaves dense rows across the whole plane); use "
            "BlockPackedTernary for row parallelism")
    if format_cls in (TiledDenseTernary, TiledBlockPacked):
        return _leaf_specs(format_cls, axis, {"tiles": (4, 0)})  # shard grid_k
    if format_cls is BlockedEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "idx_pos": (3, 0), "idx_neg": (3, 0),
            "tile_cap_pos": (2, 0), "tile_cap_neg": (2, 0)})
    if format_cls is TiledEllTCSC:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 0), "cap_pos": (2, 0), "cap_neg": (2, 0)})
    if format_cls is TiledBitplane:
        return _leaf_specs(format_cls, axis, {"plane": (4, 0)})
    if format_cls is TiledEllDeposit:
        return _leaf_specs(format_cls, axis, {
            "plane": (4, 0), "cap_pos": (2, 0), "cap_neg": (2, 0)})
    raise TypeError(f"{format_cls.__name__} is not row-shardable")


def spec_tree(fmt: TernaryFormat, leaf_specs):
    """A pytree with ``fmt``'s treedef (incl. static aux) whose leaves are
    PartitionSpecs — the shape ``shard_map``/``device_put`` expect."""
    treedef = jax.tree_util.tree_structure(fmt)
    return jax.tree_util.tree_unflatten(treedef, leaf_specs)


def localize(fmt: TernaryFormat) -> TernaryFormat:
    """Rebuild static (K, N) metadata from *local* leaf shapes.

    Inside ``shard_map`` the container arrives with global aux metadata but
    per-shard leaves; kernels specialize on fmt.K/fmt.N, so the local view
    must carry local numbers.
    """
    cls = type(fmt)
    if cls is DenseTernary:
        d = fmt.dense
        return DenseTernary(dense=d, K=d.shape[0], N=d.shape[1])
    if cls in (PackedTernary2Bit, PackedTernary53):
        p = fmt.packed
        return cls(packed=p, K=p.shape[0] * cls.FACTOR, N=p.shape[1])
    if cls is BlockPackedTernary:
        p = fmt.packed
        return cls(packed=p, K=min(fmt.K, p.shape[0] * fmt.factor),
                   N=p.shape[1], factor=fmt.factor, tile_kq=fmt.tile_kq)
    if cls is TiledDenseTernary:
        t = fmt.tiles
        return cls(tiles=t, K=min(fmt.K, t.shape[0] * fmt.tile_k),
                   N=t.shape[1] * fmt.tile_n, tile_k=fmt.tile_k,
                   tile_n=fmt.tile_n)
    if cls is TiledBlockPacked:
        t = fmt.tiles
        return cls(tiles=t,
                   K=min(fmt.K, t.shape[0] * fmt.factor * fmt.tile_kq),
                   N=t.shape[1] * fmt.tile_n, factor=fmt.factor,
                   tile_kq=fmt.tile_kq, tile_n=fmt.tile_n)
    if cls is BlockedEllTCSC:
        ip = fmt.idx_pos
        return BlockedEllTCSC(
            idx_pos=ip, idx_neg=fmt.idx_neg,
            tile_cap_pos=fmt.tile_cap_pos, tile_cap_neg=fmt.tile_cap_neg,
            K=min(fmt.K, ip.shape[0] * fmt.block_k), N=ip.shape[2],
            block_k=fmt.block_k, tile_n=fmt.tile_n, cap_align=fmt.cap_align)
    if cls is TiledEllTCSC:
        p = fmt.plane
        return TiledEllTCSC(
            plane=p, cap_pos=fmt.cap_pos, cap_neg=fmt.cap_neg,
            K=min(fmt.K, p.shape[0] * fmt.block_k),
            N=p.shape[1] * fmt.tile_n, block_k=fmt.block_k,
            tile_n=fmt.tile_n, cap_p_max=fmt.cap_p_max)
    if cls is TiledBitplane:
        p = fmt.plane
        return TiledBitplane(
            plane=p, K=min(fmt.K, p.shape[0] * 8 * fmt.tkb),
            N=p.shape[1] * fmt.tile_n, tkb=fmt.tkb, tile_n=fmt.tile_n)
    if cls is TiledEllDeposit:
        from ternary_spgemm_tpu.formats.ell_deposit import SB_ROWS
        p = fmt.plane
        return TiledEllDeposit(
            plane=p, cap_pos=fmt.cap_pos, cap_neg=fmt.cap_neg,
            K=min(fmt.K, p.shape[0] * SB_ROWS),
            N=p.shape[1] * fmt.tile_n, tile_n=fmt.tile_n,
            cap_p_max=fmt.cap_p_max)
    raise TypeError(cls.__name__)


def shard_container(fmt: TernaryFormat, mesh: Mesh, leaf_specs) -> TernaryFormat:
    """``device_put`` the container's leaves onto the mesh with the specs."""
    leaves, treedef = jax.tree_util.tree_flatten(fmt)
    placed = [jax.device_put(np.asarray(l), NamedSharding(mesh, s))
              for l, s in zip(leaves, leaf_specs)]
    return jax.tree_util.tree_unflatten(treedef, placed)


def container_from_local_shard(fmt_local: TernaryFormat, mesh: Mesh,
                               axis: str, *, dim: str, K: int,
                               N: int) -> TernaryFormat:
    """Assemble the GLOBAL sharded container from this process's locally
    built shard — the multi-HOST construction path, where no process ever
    holds the full weight matrix.

    ``fmt_local = cls.from_dense(W[:, my_cols])`` (``dim="N"``) or
    ``cls.from_dense(W[my_rows, :])`` (``dim="K"``); ``K``/``N`` are the
    GLOBAL dims. Each leaf becomes a cross-process global array via
    ``jax.make_array_from_process_local_data``. Requires the mesh axis to
    enumerate processes contiguously in process order (the default
    ``jax.devices()`` ordering) and every process to hold an equal shard.
    Works unchanged in single-process runs (the local shard is the whole
    matrix). Net-new vs the reference (single-node only, SURVEY.md §2.3).
    """
    import dataclasses
    cls = type(fmt_local)
    specs = (column_leaf_specs(cls, axis) if dim == "N"
             else row_leaf_specs(cls, axis))
    nproc = jax.process_count()
    glob_leaves = []
    for field, spec in zip(cls.ARRAY_FIELDS, specs):
        local = np.asarray(getattr(fmt_local, field))
        sharded_dim = next((d for d, s in enumerate(spec) if s == axis), None)
        gshape = list(local.shape)
        if sharded_dim is not None:
            gshape[sharded_dim] *= nproc
        sharding = NamedSharding(mesh, spec)
        glob_leaves.append(jax.make_array_from_process_local_data(
            sharding, local, tuple(gshape)))
    static = {f.name: getattr(fmt_local, f.name)
              for f in dataclasses.fields(cls)
              if f.name not in cls.ARRAY_FIELDS}
    static["K"], static["N"] = K, N
    return cls(**dict(zip(cls.ARRAY_FIELDS, glob_leaves)), **static)
