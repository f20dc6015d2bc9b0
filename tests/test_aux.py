"""Auxiliary subsystems: profiling/cost analysis, checkpoint/resume."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ternary_spgemm_tpu import checkpoint, profiling
from ternary_spgemm_tpu.formats import (
    BlockPackedTernary,
    PackedTernary53,
    generate_bias,
    generate_ternary,
)
from ternary_spgemm_tpu.models import TernaryMLP, apply_exported


def test_hlo_cost_reports_flops():
    f = lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32)
    a = jnp.ones((64, 128))
    b = jnp.ones((128, 256))
    cost = profiling.hlo_cost(f, a, b)
    # 2*M*N*K FMA-convention flops
    assert cost.get("flops", 0) >= 64 * 128 * 256


def test_compiled_memory_reports_sizes():
    f = lambda a: a * 2.0
    m = profiling.compiled_memory(f, jnp.ones((128, 128)))
    if m:  # backend-dependent; must be consistent when present
        assert m.get("argument_size_in_bytes", 0) >= 128 * 128 * 4


def test_trace_writes_files(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        jax.block_until_ready(jnp.ones((64, 64)) * 3)
    files = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert files, "profiler trace produced no files"


def test_pytree_checkpoint_roundtrip(tmp_path):
    model = TernaryMLP([8, 16, 4])
    params = model.init(jax.random.key(0))
    opt_state = optax.adam(1e-3).init(params)
    state = {"params": params, "opt": opt_state, "step": jnp.int32(7)}
    path = str(tmp_path / "ckpt")
    checkpoint.save_pytree(path, state)
    restored = checkpoint.restore_pytree(path, state)
    ref_leaves = jax.tree_util.tree_leaves(state)
    got_leaves = jax.tree_util.tree_leaves(restored)
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves, got_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_container_bundle_roundtrip(tmp_path):
    W = generate_ternary(64, 128, 4, seed=5)
    for cls, kw in [(PackedTernary53, {}),
                    (BlockPackedTernary, dict(factor=4, tile_kq=128))]:
        fmt = cls.from_dense(W, **kw)
        b = generate_bias(128)
        path = str(tmp_path / f"bundle_{cls.__name__}")
        checkpoint.save_container(path, fmt, gamma=0.25, bias=b)
        fmt2, gamma, b2, alpha = checkpoint.load_container(path)
        assert type(fmt2) is cls
        assert gamma == 0.25
        np.testing.assert_array_equal(fmt2.to_dense(), W)
        np.testing.assert_array_equal(b2, b)
        assert alpha is None
        # restored bundle runs through the kernel registry
        x = jnp.ones((4, 64))
        y = apply_exported(x, fmt2, gamma, b2)
        assert y.shape == (4, 128)


def test_format_diagram_generators(tmp_path):
    """Figure generators (plots/data_example_image analogue) draw every
    diagram from the real from_dense output without error."""
    import sys
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    import format_diagram

    rc = format_diagram.main(["--outdir", str(tmp_path)])
    assert rc == 0
    made = sorted(os.listdir(tmp_path))
    assert made == ["bitplane_structure.png", "blocked_tcsc_structure.png",
                    "ell_deposit_structure.png", "tcsc_structure.png"]
    assert all((tmp_path / f).stat().st_size > 10_000 for f in made)


def test_lm_train_state_checkpoint_roundtrip(tmp_path):
    """A full MoE-transformer training state (params + adam moments)
    checkpoints and restores leaf-exactly."""
    import optax

    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)

    cfg = BitTransformerConfig(vocab=16, d_model=16, n_heads=2, d_ff=32,
                               n_layers=2, moe_experts=2)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(0))
    opt = optax.adam(1e-3)
    state = {"params": params, "opt": opt.init(params), "step": jnp.int32(7)}
    path = str(tmp_path / "lm_state")
    checkpoint.save_pytree(path, state)
    restored = checkpoint.restore_pytree(path, state)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lm_serving_bundle_roundtrip(tmp_path):
    """save_lm_bundle/load_lm_bundle: a self-describing one-file serving
    bundle reproduces the exported LM's logits and greedy decode exactly —
    dense-FFN and MoE-FFN configs, no training-time objects at load."""
    from ternary_spgemm_tpu.formats import DenseTernary
    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)
    from ternary_spgemm_tpu.models.generate import (
        ExportedTransformerLM, generate)

    for tag, kw in [("dense", {}), ("moe", {"moe_experts": 2})]:
        cfg = BitTransformerConfig(vocab=32, d_model=16, n_heads=2, d_ff=32,
                                   n_layers=2, **kw)
        model = BitTransformerLM(cfg)
        params = model.init(jax.random.key(3))
        kern = "DenseMXU" if tag == "dense" else None
        lm = ExportedTransformerLM.from_params(
            model, params, DenseTernary, kernel=kern)
        path = str(tmp_path / f"bundle_{tag}")
        checkpoint.save_lm_bundle(path, lm)
        lm2 = checkpoint.load_lm_bundle(path)

        toks = jax.random.randint(jax.random.key(4), (2, 6), 0, cfg.vocab)
        np.testing.assert_allclose(np.asarray(lm(toks)),
                                   np.asarray(lm2(toks)), rtol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(generate(lm, toks, 3)),
            np.asarray(generate(lm2, toks, 3)))
        # kernel choice survives the round-trip
        blk = lm2.blocks[0].linears["wq"]
        assert blk.kernel == kern


def test_lm_serving_bundle_fused_paths(tmp_path):
    """Bundle round-trip of the serving fast paths: the merged-QKV
    container and with_transpose=False (forward-only) layers."""
    import pytest
    from ternary_spgemm_tpu.formats import TiledBitplane
    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)
    from ternary_spgemm_tpu.models.generate import ExportedTransformerLM

    cfg = BitTransformerConfig(vocab=32, d_model=128, n_heads=2, d_ff=256,
                               n_layers=1)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(5))
    lm = ExportedTransformerLM.from_params(
        model, params, TiledBitplane, kernel="TiledBitplane",
        fused_qkv=True, with_transpose=False)
    assert lm.blocks[0].linears["wq"].fmt_t is None
    path = str(tmp_path / "bundle_fused")
    checkpoint.save_lm_bundle(path, lm)
    lm2 = checkpoint.load_lm_bundle(path)
    blk2 = lm2.blocks[0]
    assert blk2.qkv is not None
    assert blk2.linears["wq"].fmt_t is None

    toks = jax.random.randint(jax.random.key(6), (1, 4), 0, cfg.vocab)
    np.testing.assert_allclose(np.asarray(lm(toks)), np.asarray(lm2(toks)),
                               rtol=1e-6)
    # forward-only layers refuse to backpropagate, with a clear error
    x = jnp.ones((2, cfg.d_model), jnp.float32)
    with pytest.raises(ValueError, match="with_transpose=False"):
        jax.grad(lambda z: jnp.sum(lm2.blocks[0].linears["wq"](z)))(x)


def test_sharded_pytree_roundtrip(tmp_path):
    """save_sharded_pytree/restore_sharded_pytree on the 8-device mesh:
    sharded, replicated, and partially-sharded leaves round-trip exactly,
    preserving shardings (single-process path of the multi-host
    checkpoint; the cross-process path is tests/test_multiprocess.py)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ternary_spgemm_tpu.parallel import make_mesh

    mesh = make_mesh({"model": 8})
    tree = {
        "w": jax.device_put(jnp.arange(64.0).reshape(8, 8),
                            NamedSharding(mesh, P("model", None))),
        "b": jax.device_put(jnp.arange(8.0), NamedSharding(mesh, P())),
        "k": jax.device_put(jnp.arange(32, dtype=jnp.int32).reshape(4, 8),
                            NamedSharding(mesh, P(None, "model"))),
    }
    path = str(tmp_path / "sharded")
    checkpoint.save_sharded_pytree(path, tree)
    restored = checkpoint.restore_sharded_pytree(path, tree)
    for k in tree:
        np.testing.assert_array_equal(np.asarray(tree[k]),
                                      np.asarray(restored[k]))
        assert restored[k].sharding == tree[k].sharding
    # shape mismatch is a loud error, not silent corruption
    bad = dict(tree, w=jax.device_put(jnp.zeros((16, 8)),
                                      NamedSharding(mesh, P("model", None))))
    with pytest.raises(ValueError, match="checkpoint shape"):
        checkpoint.restore_sharded_pytree(path, bad)


def test_lm_serving_bundle_a8_roundtrip(tmp_path):
    """The a8 flag must survive the bundle round-trip (round-4 ADVICE high):
    an a8=True export restored with a8=False would feed raw float
    activations into the pinned restricted-domain kernel and silently round
    them — logits must match the pre-save model exactly."""
    from ternary_spgemm_tpu.formats import TiledBitplane
    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)
    from ternary_spgemm_tpu.models.generate import ExportedTransformerLM

    cfg = BitTransformerConfig(vocab=32, d_model=128, n_heads=2, d_ff=256,
                               n_layers=1)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(7))
    lm = ExportedTransformerLM.from_params(
        model, params, TiledBitplane, kernel="TiledBitplane_x8",
        a8=True, with_transpose=False)
    assert lm.blocks[0].linears["wq"].a8
    path = str(tmp_path / "bundle_a8")
    checkpoint.save_lm_bundle(path, lm)
    lm2 = checkpoint.load_lm_bundle(path)
    assert lm2.blocks[0].linears["wq"].a8, "a8 flag lost in bundle round-trip"
    assert lm2.blocks[0]._a8

    toks = jax.random.randint(jax.random.key(8), (1, 4), 0, cfg.vocab)
    np.testing.assert_allclose(np.asarray(lm(toks)), np.asarray(lm2(toks)),
                               rtol=1e-6)


def test_export_model_cli_roundtrip(tmp_path):
    """tools/export_model.py: train-state checkpoint -> bundle -> decode,
    matching the in-process generate() exactly."""
    import json

    import optax

    from ternary_spgemm_tpu.formats import DenseTernary

    from tools import export_model
    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)
    from ternary_spgemm_tpu.models.generate import (
        ExportedTransformerLM, generate)

    cfg_kw = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2)
    cfg = BitTransformerConfig(**cfg_kw)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(5))
    state = {"params": params, "opt": optax.adam(1e-3).init(params),
             "step": 0}
    ckpt = str(tmp_path / "state")
    checkpoint.save_pytree(ckpt, state)
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(json.dumps(cfg_kw))

    bundle = str(tmp_path / "bundle.npz")
    rc = export_model.main(["export", "--checkpoint", ckpt,
                            "--cfg", str(cfg_json),
                            "--format", "DenseTernary", "--out", bundle])
    assert rc == 0

    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = export_model.main(["generate", "--bundle", bundle,
                                "--prompt", "1 2 3", "--new-tokens", "4"])
    assert rc == 0
    got = [int(t) for t in buf.getvalue().strip().split()]

    lm = ExportedTransformerLM.from_params(model, params, DenseTernary)
    want = np.asarray(generate(
        lm, jnp.asarray([[1, 2, 3]], jnp.int32), 4))[0, 3:].tolist()
    assert got == want


def test_export_model_cli_serving_flags(tmp_path):
    """export_model.py serving flags: --a8 --serving-only --fused-qkv
    --head-dtype bf16 survive the bundle, and generate accepts sampling."""
    import contextlib
    import io
    import json

    import optax

    from tools import export_model
    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)

    cfg_kw = dict(vocab=32, d_model=64, n_heads=2, d_ff=128, n_layers=1)
    cfg = BitTransformerConfig(**cfg_kw)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(6))
    ckpt = str(tmp_path / "state")
    checkpoint.save_pytree(
        ckpt, {"params": params, "opt": optax.adam(1e-3).init(params),
               "step": 0})
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(json.dumps(cfg_kw))
    bundle = str(tmp_path / "bundle_srv.npz")
    rc = export_model.main([
        "export", "--checkpoint", ckpt, "--cfg", str(cfg_json),
        "--format", "TiledBitplane", "--kernel", "TiledBitplane_x8",
        "--a8", "--serving-only", "--fused-qkv", "--head-dtype", "bf16",
        "--out", bundle])
    assert rc == 0
    lm2 = checkpoint.load_lm_bundle(bundle)
    assert lm2.blocks[0].linears["wq"].a8
    assert lm2.blocks[0].linears["wq"].fmt_t is None
    assert lm2.blocks[0].qkv is not None
    assert lm2.embed.dtype == jnp.bfloat16

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = export_model.main(["generate", "--bundle", bundle,
                                "--prompt", "1 2 3", "--new-tokens", "4",
                                "--int8-kv", "--temperature", "0.8",
                                "--top-k", "5", "--seed", "3"])
    assert rc == 0
    got = [int(t) for t in buf.getvalue().strip().split()]
    assert len(got) == 4 and all(0 <= t < cfg.vocab for t in got)
