"""Autotuner tests: candidate filtering by activation domain, measured
winner validity, memoization, disk cache, kernel="auto" dispatch."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from ternary_spgemm_tpu.formats import (
    TiledBitplane, generate_bias, generate_ternary, generate_x)
from ternary_spgemm_tpu.ops import autotune, ternary_spgemm
from ternary_spgemm_tpu.ops.autotune import _CACHE, candidates_for
from ternary_spgemm_tpu import reference


def _setup():
    W = generate_ternary(64, 128, 4, seed=0)
    fmt = TiledBitplane.from_dense(W)
    X = np.asarray(generate_x(8, 64, seed=1))  # integer-valued, |x|<=512
    b = np.asarray(generate_bias(128))
    return W, fmt, X, b


def test_candidates_respect_domain():
    _, fmt, X, _ = _setup()
    names_int = {s.name for s in candidates_for(fmt, 127.0, True)}
    names_f32 = {s.name for s in candidates_for(fmt, 127.0, False)}
    # the int8 domain admits the _x8 kernels; a float domain must not
    assert "TiledBitplane_x8" in names_int
    assert not any("_x8" in n for n in names_f32)
    # |x|>127 excludes them even for integers
    assert not any("_x8" in n for n in
                   {s.name for s in candidates_for(fmt, 512.0, True)})
    # the GPU-only Triton kernel is no candidate on the CPU
    assert "TritonTiledBitplane_x8" not in names_int


def test_autotune_returns_valid_kernel_and_memoizes(tmp_path):
    W, fmt, X, b = _setup()
    cache = str(tmp_path / "tune.json")
    _CACHE.clear()
    name = autotune(X, fmt, b, min_seconds=0.005, cache_path=cache)
    cands = {s.name for s in candidates_for(fmt, 512.0, True)}
    assert name in cands
    disk = json.load(open(cache))
    assert list(disk.values()) == [name]
    # memoized: a second call must not re-measure (poison the registry path
    # by asserting the in-process cache is hit)
    assert autotune(X, fmt, b, min_seconds=0.005, cache_path=cache) == name

    # and the result actually computes correctly through dispatch
    want = np.asarray(reference.dense_gemm(jnp.asarray(X, jnp.float32), W, b))
    got = np.asarray(ternary_spgemm(jnp.asarray(X, jnp.float32), fmt, b,
                                    kernel=name))
    assert reference.compare_results(got, want)


def test_kernel_auto_dispatch():
    _, fmt, X, b = _setup()
    _CACHE.clear()
    y = ternary_spgemm(jnp.asarray(X, jnp.float32), fmt, b, kernel="auto")
    assert y.shape == (8, 128)
    assert len(_CACHE) == 1


def test_autotune_rejects_tracer():
    import jax

    _, fmt, X, b = _setup()
    with pytest.raises(ValueError, match="concrete"):
        jax.jit(lambda x: ternary_spgemm(x, fmt, b, kernel="auto"))(
            jnp.asarray(X, jnp.float32))


def test_exported_layer_kernel_auto(tmp_path):
    """Serving path (VERDICT round-3 next #8): an exported layer built with
    kernel='auto' resolves to the measured winner on first call — eagerly
    on concrete activations, conservatively (exact-f32 domain) under a
    trace — and autotune_exported resolves a whole frozen model."""
    import jax

    from ternary_spgemm_tpu.models import (ExportedBitLinear, ExportedMLP,
                                           autotune_exported)

    W, _, X, b = _setup()
    _CACHE.clear()
    layer = ExportedBitLinear.from_dense(W, TiledBitplane, bias=b,
                                         kernel="auto")
    want = np.asarray(reference.dense_gemm(jnp.asarray(X, jnp.float32), W, b))
    got = np.asarray(layer(jnp.asarray(X, jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert layer.kernel not in (None, "auto")

    # traced first call: cannot probe during a trace — must warn, fall back
    # to the safe default dispatch for that compile, and stay 'auto'
    layer2 = ExportedBitLinear.from_dense(W, TiledBitplane, bias=b,
                                          kernel="auto")
    with pytest.warns(UserWarning, match="cannot measure during a trace"):
        got2 = np.asarray(jax.jit(lambda l, x: l(x))(
            layer2, jnp.asarray(X, jnp.float32)))
    np.testing.assert_allclose(got2, want, atol=1e-5)
    assert layer2.kernel == "auto"
    # explicit pre-jit resolution bakes the measured winner in
    name = layer2.resolve_kernel(8, absmax=127)
    assert name not in (None, "auto")
    got3 = np.asarray(jax.jit(lambda l, x: l(x))(
        layer2, jnp.asarray(np.clip(X, -127, 127), jnp.float32)))
    assert got3.shape == want.shape

    # whole-model resolution with the JSON cache
    mlp = ExportedMLP([ExportedBitLinear.from_dense(W, TiledBitplane, bias=b,
                                                    kernel="auto")])
    picks = autotune_exported(mlp, 8, absmax=127,
                              cache_path=str(tmp_path / "serve.json"))
    assert picks and all(v not in (None, "auto") for v in picks.values())
    assert (tmp_path / "serve.json").exists()


@pytest.mark.parametrize("kv_heads,window", [(0, 0), (1, 3)],
                         ids=["mha", "gqa-window"])
def test_autotune_serving_flags(tmp_path, kv_heads, window):
    """autotune_serving_flags: measures separate vs merged q/k/v on a
    decode-shaped probe with the layer's kernel, returns a bool, memoizes
    in the shared JSON cache; from_params(auto=True) applies the measured
    pick. The GQA case needs the head tuple and the window (a plain
    n_heads crashed the probe under GQA)."""
    import jax

    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)
    from ternary_spgemm_tpu.models.generate import (
        ExportedTransformerLM, autotune_serving_flags)

    cfg = BitTransformerConfig(vocab=32, d_model=128, n_heads=2, d_ff=256,
                               n_layers=1, n_kv_heads=kv_heads,
                               window=window)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(0))
    cache = str(tmp_path / "serve.json")
    picks = autotune_serving_flags(cfg, params["blocks"][0], TiledBitplane,
                                   kernel="TiledBitplane_x8",
                                   cache_path=cache, verbose=True)
    assert set(picks) == {"fused_qkv"}
    assert all(isinstance(v, bool) for v in picks.values())
    assert (tmp_path / "serve.json").exists()
    # memo hit: second call returns identically without re-probing
    assert autotune_serving_flags(cfg, params["blocks"][0], TiledBitplane,
                                  kernel="TiledBitplane_x8",
                                  cache_path=cache) == picks

    # from_params forwards its kernel to the probe: same memo key, so the
    # probe is not re-run and the pick matches
    lm = ExportedTransformerLM.from_params(
        model, params, TiledBitplane, kernel="TiledBitplane_x8",
        a8=True, with_transpose=False, auto=True, cache_path=cache)
    blk = lm.blocks[0]
    assert blk.kernel == "TiledBitplane_x8"
    assert (blk.qkv is not None) == picks["fused_qkv"]
    toks = jax.random.randint(jax.random.key(1), (1, 4), 0, cfg.vocab)
    assert np.all(np.isfinite(np.asarray(lm(toks))))
