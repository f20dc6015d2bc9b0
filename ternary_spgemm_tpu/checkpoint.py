"""Checkpoint / resume for models and ternary containers.

Net-new vs the reference (its only persistence is benchmark JSONs,
SURVEY.md §5): save/restore of (a) training state (params + optimizer state),
(b) exported inference bundles (ternary container + scale + bias/alpha), and
(c) whole-LM serving bundles (:func:`save_lm_bundle` — one self-describing
file per ExportedTransformerLM; CLI: ``tools/export_model.py``), via
orbax-checkpoint when available with a numpy ``.npz`` fallback so the
capability never silently disappears.

Containers are pytrees whose static aux data (K, N, tile sizes) must
round-trip too; the bundle format stores the container class name + aux
alongside the leaves and reconstructs through the format registry.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import jax
import numpy as np

from ternary_spgemm_tpu.formats import all_formats
from ternary_spgemm_tpu.formats.base import TernaryFormat


def _flatten_numpy(tree) -> Tuple[dict, Any]:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}, treedef


def save_pytree(path: str, tree) -> None:
    """Save an arbitrary pytree of arrays (params, opt state) to ``path``.

    Uses orbax if importable (directory checkpoint, async-safe), else a
    ``.npz`` with the treedef serialized structurally.
    """
    try:
        import orbax.checkpoint as ocp
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(path), tree, force=True)
        ckptr.wait_until_finished()
        return
    except ModuleNotFoundError:
        pass
    arrays, _ = _flatten_numpy(tree)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def restore_pytree(path: str, like):
    """Restore a pytree saved by :func:`save_pytree`; ``like`` supplies the
    tree structure (and shardings under orbax).

    The restore path is chosen by what is *on disk* (``.npz`` file vs orbax
    directory), not by orbax importability — so an npz checkpoint written in
    a fallback environment restores fine where orbax exists, and vice versa.
    """
    p = path if path.endswith(".npz") else path + ".npz"
    if not os.path.exists(p):
        import orbax.checkpoint as ocp
        ckptr = ocp.StandardCheckpointer()
        return ckptr.restore(os.path.abspath(path), like)
    data = np.load(p)
    leaves, treedef = jax.tree_util.tree_flatten(like)
    restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    return jax.tree_util.tree_unflatten(treedef, restored)


def _index_key(idx, shape) -> str:
    """Canonical JSON key for a shard index (tuple of slices): resolved
    ``[[start, stop], ...]`` per dimension, defaults filled from ``shape``."""
    out = []
    for d, s in enumerate(idx):
        start = 0 if s.start is None else int(s.start)
        stop = int(shape[d]) if s.stop is None else int(s.stop)
        out.append([start, stop])
    return json.dumps(out)


def save_sharded_pytree(path: str, tree) -> None:
    """Multi-host checkpoint save: every process writes ONLY the shards it
    holds (``path.shard{process_index}.npz``); no process ever materializes
    a full array. Works identically in single-process runs (one file).

    The reference has no checkpointing at all (SURVEY.md §5); this is the
    DCN-boundary half of the net-new persistence layer — the per-host shard
    files plus :func:`restore_sharded_pytree` reassemble global arrays on a
    (possibly different) multi-process mesh, matching shards to devices by
    their *global index ranges*, not device ids, so the restore layout only
    needs to cover the same index set.
    """
    leaves, _ = jax.tree_util.tree_flatten(tree)
    pid = jax.process_index()
    arrays: dict = {}
    header = []
    for i, leaf in enumerate(leaves):
        leaf = jnp_asarray(leaf)
        recs = []
        seen = set()
        for sh in leaf.addressable_shards:
            key = _index_key(sh.index, leaf.shape)
            if key in seen:        # replicated shards: store once
                continue
            seen.add(key)
            arrays[f"l{i}s{len(recs)}"] = np.asarray(sh.data)
            recs.append(key)
        header.append({"shape": list(leaf.shape), "dtype": str(leaf.dtype),
                       "indices": recs})
    arrays["header"] = np.frombuffer(json.dumps(header).encode(),
                                     dtype=np.uint8)
    np.savez(f"{path}.shard{pid}.npz", **arrays)


def restore_sharded_pytree(path: str, like):
    """Restore a :func:`save_sharded_pytree` checkpoint; ``like`` supplies
    tree structure and TARGET shardings (a pytree of jax.Arrays placed the
    way the restored arrays should be). Each process reads only its own
    shard file and feeds per-device buffers to
    ``jax.make_array_from_single_device_arrays`` — the cross-process global
    array is assembled without any collective."""
    leaves_like, treedef = jax.tree_util.tree_flatten(like)
    pid = jax.process_index()
    data = np.load(f"{path}.shard{pid}.npz")
    header = json.loads(bytes(data["header"]).decode())
    out = []
    for i, ref in enumerate(leaves_like):
        ref = jnp_asarray(ref)
        shape = tuple(header[i]["shape"])
        if shape != tuple(ref.shape):
            raise ValueError(
                f"leaf {i}: checkpoint shape {shape} != target {ref.shape}")
        saved = {key: data[f"l{i}s{j}"]
                 for j, key in enumerate(header[i]["indices"])}
        sharding = ref.sharding
        idx_map = sharding.addressable_devices_indices_map(shape)
        bufs = []
        for dev, idx in idx_map.items():
            key = _index_key(idx, shape)
            if key not in saved:
                raise ValueError(
                    f"leaf {i}: no saved shard covers index {key} needed by "
                    f"device {dev} — restore layout must match the saved "
                    "shard index set per process")
            bufs.append(jax.device_put(saved[key], dev))
        out.append(jax.make_array_from_single_device_arrays(
            shape, sharding, bufs))
    return jax.tree_util.tree_unflatten(treedef, out)


def jnp_asarray(x):
    """jnp.asarray that leaves committed jax.Arrays (incl. multi-process
    global arrays, which reject host transfer) untouched."""
    if isinstance(x, jax.Array):
        return x
    import jax.numpy as jnp
    return jnp.asarray(x)


def save_container(path: str, fmt: TernaryFormat, *, gamma: float = 1.0,
                   bias=None, alpha=None) -> None:
    """Save an inference bundle: ternary container + scale + bias/alpha.

    One ``.npz`` with the container's arrays keyed *by field name* plus a
    JSON header holding the format class name and static aux data — enough
    to rebuild the exact pytree (class + K/N/tile metadata) without pickling
    code. Field-name keys make the on-disk layout independent of pytree
    flatten order, so a format whose ARRAY_FIELDS tuple is not in dataclass
    declaration order round-trips correctly.
    """
    # static metadata = the registered dataclass fields not in ARRAY_FIELDS
    import dataclasses
    cls = type(fmt)
    static = {f.name: getattr(fmt, f.name) for f in dataclasses.fields(cls)
              if f.name not in cls.ARRAY_FIELDS}
    header = {"format": cls.__name__, "static": static, "gamma": float(gamma)}
    arrays = {f"field_{name}": np.asarray(getattr(fmt, name))
              for name in cls.ARRAY_FIELDS}
    if bias is not None:
        arrays["bias"] = np.asarray(bias)
    if alpha is not None:
        arrays["alpha"] = np.asarray(alpha)
    arrays["header"] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def _fmt_record(fmt: TernaryFormat, prefix: str, arrays: dict) -> dict:
    """Serialize one container under ``prefix`` into ``arrays``; return its
    JSON header (class name + static aux), mirroring :func:`save_container`."""
    import dataclasses
    cls = type(fmt)
    for name in cls.ARRAY_FIELDS:
        arrays[f"{prefix}.{name}"] = np.asarray(getattr(fmt, name))
    static = {f.name: getattr(fmt, f.name) for f in dataclasses.fields(cls)
              if f.name not in cls.ARRAY_FIELDS}
    return {"format": cls.__name__, "static": static}


def _fmt_restore(header: dict, prefix: str, data) -> TernaryFormat:
    cls = all_formats()[header["format"]]
    kwargs = {name: data[f"{prefix}.{name}"] for name in cls.ARRAY_FIELDS}
    kwargs.update(header["static"])
    return cls(**kwargs)


def _linear_record(lin, prefix: str, arrays: dict) -> dict:
    hdr = {"fmt": _fmt_record(lin.fmt, f"{prefix}.fmt", arrays),
           "fmt_t": (None if lin.fmt_t is None else
                     _fmt_record(lin.fmt_t, f"{prefix}.fmt_t", arrays)),
           "gamma": float(lin.gamma), "kernel": lin.kernel,
           "has_alpha": lin.alpha is not None, "a8": bool(lin.a8)}
    arrays[f"{prefix}.bias"] = np.asarray(lin.bias)
    if lin.alpha is not None:
        arrays[f"{prefix}.alpha"] = np.asarray(lin.alpha)
    return hdr


def _linear_restore(hdr: dict, prefix: str, data):
    from ternary_spgemm_tpu.models.exported import ExportedBitLinear
    return ExportedBitLinear(
        _fmt_restore(hdr["fmt"], f"{prefix}.fmt", data),
        (None if hdr["fmt_t"] is None else
         _fmt_restore(hdr["fmt_t"], f"{prefix}.fmt_t", data)),
        hdr["gamma"], data[f"{prefix}.bias"],
        data[f"{prefix}.alpha"] if hdr["has_alpha"] else None,
        kernel=hdr["kernel"], a8=hdr.get("a8", False))


def save_lm_bundle(path: str, lm) -> None:
    """Save an :class:`~ternary_spgemm_tpu.models.generate.ExportedTransformerLM`
    as ONE self-describing ``.npz`` serving bundle.

    Self-describing means loadable without the training-time model object or
    params tree (unlike :func:`restore_pytree`, which needs a ``like``
    skeleton — impossible to rebuild for sparse-stream containers whose array
    shapes depend on the trained weights' nnz). The JSON header records the
    transformer config, and per linear the container class + static aux +
    gamma + kernel choice; arrays are keyed by field path.
    """
    import dataclasses
    cfg = lm.cfg
    emb = np.asarray(lm.embed)
    embed_dtype = str(emb.dtype)
    if embed_dtype not in ("float32", "float64", "float16"):
        emb = emb.view(np.uint16)   # bf16 head (ml_dtypes): store raw bits
    arrays: dict = {"embed": emb, "norm_out": np.asarray(lm.norm_out)}
    blocks_hdr = []
    for i, blk in enumerate(lm.blocks):
        bh = {"linears": {}, "kernel": blk.kernel}
        for name, lin in blk.linears.items():
            bh["linears"][name] = _linear_record(lin, f"b{i}.{name}", arrays)
        if blk.qkv is not None:
            bh["qkv"] = _fmt_record(blk.qkv["fmt"], f"b{i}.qkv.fmt", arrays)
            arrays[f"b{i}.qkv.scale"] = np.asarray(blk.qkv["scale"])
            arrays[f"b{i}.qkv.bias"] = np.asarray(blk.qkv["bias"])
        arrays[f"b{i}.norm_attn"] = np.asarray(blk.norm_attn)
        arrays[f"b{i}.norm_ffn"] = np.asarray(blk.norm_ffn)
        if blk.moe is not None:
            arrays[f"b{i}.moe.router"] = np.asarray(blk.moe.router)
            bh["moe"] = [{n: _linear_record(ex[n], f"b{i}.moe.e{e}.{n}", arrays)
                          for n in ("w_gate", "w_up", "w_down")}
                         for e, ex in enumerate(blk.moe.experts)]
        blocks_hdr.append(bh)
    header = {"version": 1, "cfg": dataclasses.asdict(cfg),
              "embed_dtype": embed_dtype, "blocks": blocks_hdr}
    arrays["header"] = np.frombuffer(json.dumps(header).encode(),
                                     dtype=np.uint8)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)


def load_lm_bundle(path: str):
    """Load a serving bundle -> ``ExportedTransformerLM`` (no training-time
    objects needed; the file is self-describing)."""
    from ternary_spgemm_tpu.models.generate import ExportedTransformerLM
    from ternary_spgemm_tpu.models.moe import BitMoEConfig, ExportedMoE
    from ternary_spgemm_tpu.models.transformer import (
        BitTransformerConfig, ExportedTransformerBlock)

    p = path if path.endswith(".npz") else path + ".npz"
    data = np.load(p)
    header = json.loads(bytes(data["header"]).decode())
    cfg = BitTransformerConfig(**header["cfg"])
    blocks = []
    for i, bh in enumerate(header["blocks"]):
        linears = {name: _linear_restore(h, f"b{i}.{name}", data)
                   for name, h in bh["linears"].items()}
        moe = None
        if "moe" in bh:
            experts = [{n: _linear_restore(eh[n], f"b{i}.moe.e{e}.{n}", data)
                        for n in ("w_gate", "w_up", "w_down")}
                       for e, eh in enumerate(bh["moe"])]
            moe = ExportedMoE(
                BitMoEConfig(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                             top_k=cfg.moe_top_k,
                             capacity_factor=cfg.moe_capacity_factor),
                data[f"b{i}.moe.router"], experts)
        qkv = None
        if bh.get("qkv") is not None:
            import jax
            import jax.numpy as jnp
            qkv = {"fmt": jax.tree_util.tree_map(
                       jnp.asarray,
                       _fmt_restore(bh["qkv"], f"b{i}.qkv.fmt", data)),
                   "scale": jnp.asarray(data[f"b{i}.qkv.scale"]),
                   "bias": jnp.asarray(data[f"b{i}.qkv.bias"])}
        blocks.append(ExportedTransformerBlock(
            cfg, linears, data[f"b{i}.norm_attn"], data[f"b{i}.norm_ffn"],
            moe, qkv=qkv,
            kernel=bh.get("kernel")))
    embed = data["embed"]
    head_dtype = None
    edt = header.get("embed_dtype", "float32")
    if edt not in ("float32", "float64", "float16"):
        import jax.numpy as jnp
        head_dtype = jnp.dtype(edt)      # ml_dtypes dtype; valid for .view
        embed = embed.view(head_dtype)
    return ExportedTransformerLM(cfg, blocks, embed, data["norm_out"],
                                 head_dtype=head_dtype)


def load_container(path: str):
    """Load an inference bundle -> (fmt, gamma, bias, alpha)."""
    p = path if path.endswith(".npz") else path + ".npz"
    data = np.load(p)
    header = json.loads(bytes(data["header"]).decode())
    cls = all_formats()[header["format"]]
    if f"field_{cls.ARRAY_FIELDS[0]}" in data:
        kwargs = {name: data[f"field_{name}"] for name in cls.ARRAY_FIELDS}
    else:  # legacy positional layout (round-1 bundles)
        kwargs = {name: data[f"leaf_{i}"]
                  for i, name in enumerate(cls.ARRAY_FIELDS)}
    kwargs.update(header["static"])
    fmt = cls(**kwargs)
    bias = data["bias"] if "bias" in data else None
    alpha = data["alpha"] if "alpha" in data else None
    return fmt, header["gamma"], bias, alpha
