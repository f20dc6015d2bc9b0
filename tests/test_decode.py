"""KV-cached decoding tests: incremental == full causal forward, QAT ==
exported-container backend, scan-jitted greedy generation."""

import jax
import jax.numpy as jnp
import numpy as np

from ternary_spgemm_tpu.formats import DenseTernary
from ternary_spgemm_tpu.models import BitTransformerConfig, BitTransformerLM
from ternary_spgemm_tpu.models.generate import (
    ExportedTransformerLM,
    generate,
    init_cache,
    lm_decode_step,
)

CFG = BitTransformerConfig(vocab=48, d_model=32, n_heads=2, d_ff=64,
                           n_layers=2)


def _setup(seed=0):
    model = BitTransformerLM(CFG)
    params = model.init(jax.random.key(seed))
    toks = jax.random.randint(jax.random.key(seed + 1), (2, 10), 0, CFG.vocab)
    return model, params, toks


def test_decode_matches_full_forward():
    """Feeding tokens one-by-one through the cache reproduces the full
    causal forward's logits at every position."""
    model, params, toks = _setup()
    want = model.apply(params, toks)          # (B, T, vocab)
    caches = init_cache(CFG, toks.shape[0], toks.shape[1])
    for t in range(toks.shape[1]):
        logits, caches = lm_decode_step(model, params, toks[:, t], caches,
                                        jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(want[:, t]),
                                   rtol=2e-4, atol=2e-4)


def test_exported_decode_matches_qat_decode():
    """The exported-container backend's decode step tracks the QAT one."""
    model, params, toks = _setup(seed=2)
    exported = ExportedTransformerLM.from_params(model, params, DenseTernary)
    want = model.apply(params, toks)
    caches = init_cache(CFG, toks.shape[0], toks.shape[1])
    for t in range(toks.shape[1]):
        logits, caches = exported.decode_step(toks[:, t], caches,
                                              jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(want[:, t]),
                                   rtol=2e-4, atol=2e-4)


def test_exported_full_forward_matches_qat():
    model, params, toks = _setup(seed=3)
    exported = ExportedTransformerLM.from_params(model, params, DenseTernary)
    got = jax.jit(lambda lm, t: lm(t))(exported, toks)   # pytree THROUGH jit
    np.testing.assert_allclose(np.asarray(got), np.asarray(model.apply(params, toks)),
                               rtol=2e-4, atol=2e-4)


def test_generate_greedy_consistency():
    """generate() continues the prompt with exactly the tokens greedy
    re-scoring of the grown sequence would pick (teacher-forcing check)."""
    model, params, toks = _setup(seed=4)
    prompt = toks[:, :4]
    out = generate(model, prompt, n_new=4, params=params)
    assert out.shape == (2, 8)
    np.testing.assert_array_equal(np.asarray(out[:, :4]), np.asarray(prompt))
    # re-score: each generated token must be the argmax of the full forward
    # at its position given everything before it
    full = model.apply(params, out)
    for t in range(4, 8):
        expect = jnp.argmax(full[:, t - 1], axis=-1)
        np.testing.assert_array_equal(np.asarray(out[:, t]), np.asarray(expect))


def test_generate_exported_matches_qat():
    model, params, toks = _setup(seed=5)
    exported = ExportedTransformerLM.from_params(model, params, DenseTernary)
    prompt = toks[:, :3]
    a = generate(model, prompt, n_new=5, params=params)
    b = generate(exported, prompt, n_new=5)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_moe_decode_matches_full_forward():
    """MoE-FFN blocks decode through the cache too. Capacity must not bind
    (decode routes S=B tokens/step vs S=B*T in the full forward, so a
    binding capacity would drop different tokens; capacity_factor is set
    high enough that nothing drops in either regime)."""
    cfg = BitTransformerConfig(vocab=48, d_model=32, n_heads=2, d_ff=64,
                               n_layers=2, moe_experts=4,
                               moe_capacity_factor=8.0)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(7))
    toks = jax.random.randint(jax.random.key(8), (2, 8), 0, cfg.vocab)
    want = model.apply(params, toks)
    caches = init_cache(cfg, 2, 8)
    for t in range(8):
        logits, caches = lm_decode_step(model, params, toks[:, t], caches,
                                        jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(want[:, t]),
                                   rtol=2e-4, atol=2e-4)


def test_moe_exported_decode_matches_qat():
    cfg = BitTransformerConfig(vocab=48, d_model=32, n_heads=2, d_ff=64,
                               n_layers=2, moe_experts=2,
                               moe_capacity_factor=8.0)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(9))
    exported = ExportedTransformerLM.from_params(model, params, DenseTernary)
    toks = jax.random.randint(jax.random.key(10), (2, 6), 0, cfg.vocab)
    c_q = init_cache(cfg, 2, 6)
    c_e = init_cache(cfg, 2, 6)
    for t in range(6):
        lq, c_q = lm_decode_step(model, params, toks[:, t], c_q,
                                 jnp.asarray(t))
        le, c_e = exported.decode_step(toks[:, t], c_e, jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(le), np.asarray(lq),
                                   rtol=2e-4, atol=2e-4)


def test_prefill_matches_stepwise_decode():
    """One batched prefill fills the caches identically to T0 sequential
    decode steps (logits at every prompt position match too)."""
    from ternary_spgemm_tpu.models.generate import lm_prefill

    model, params, toks = _setup(seed=4)
    B, T0 = toks.shape
    c_step = init_cache(CFG, B, T0)
    step_logits = []
    for t in range(T0):
        lg, c_step = lm_decode_step(model, params, toks[:, t], c_step,
                                    jnp.asarray(t))
        step_logits.append(np.asarray(lg))
    pre_logits, c_pre = lm_prefill(model, params, toks,
                                   init_cache(CFG, B, T0))
    for t in range(T0):
        np.testing.assert_allclose(np.asarray(pre_logits[:, t]),
                                   step_logits[t], rtol=2e-4, atol=2e-4)
    for a, b in zip(jax.tree_util.tree_leaves(c_pre),
                    jax.tree_util.tree_leaves(c_step)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_generate_prefill_matches_stepwise_generate():
    """generate(prefill=True) == generate(prefill=False), QAT and exported."""
    model, params, toks = _setup(seed=5)
    want = generate(model, toks, 6, params=params, prefill=False)
    got = generate(model, toks, 6, params=params, prefill=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    exported = ExportedTransformerLM.from_params(model, params, DenseTernary)
    want_e = generate(exported, toks, 6, prefill=False)
    got_e = generate(exported, toks, 6, prefill=True)
    np.testing.assert_array_equal(np.asarray(got_e), np.asarray(want_e))


def test_int8_cache_decode_tracks_f32():
    """int8 KV cache: logits track the f32 cache within activation-
    quantization tolerance, prefill == stepwise exactly (both read the
    dequantized rows), and the cache arrays really are int8."""
    from ternary_spgemm_tpu.models.generate import lm_prefill

    model, params, toks = _setup(seed=6)
    B, T0 = toks.shape
    want = model.apply(params, toks)

    c8 = init_cache(CFG, B, T0, dtype=jnp.int8)
    assert c8[0]["k"].dtype == jnp.int8 and "k_scale" in c8[0]
    step_logits = []
    for t in range(T0):
        lg, c8 = lm_decode_step(model, params, toks[:, t], c8, jnp.asarray(t))
        step_logits.append(np.asarray(lg))
        np.testing.assert_allclose(np.asarray(lg), np.asarray(want[:, t]),
                                   rtol=0.05, atol=0.05)

    pre_logits, _ = lm_prefill(model, params, toks,
                               init_cache(CFG, B, T0, dtype=jnp.int8))
    for t in range(T0):
        np.testing.assert_allclose(np.asarray(pre_logits[:, t]),
                                   step_logits[t], rtol=2e-4, atol=2e-4)


def test_generate_int8_cache_runs_both_backends():
    model, params, toks = _setup(seed=7)
    out = generate(model, toks, 4, params=params, cache_dtype=jnp.int8)
    assert out.shape == (toks.shape[0], toks.shape[1] + 4)
    exported = ExportedTransformerLM.from_params(model, params, DenseTernary)
    out_e = generate(exported, toks, 4, cache_dtype=jnp.int8)
    assert out_e.shape == out.shape


def test_fused_paths_decode_matches_full_forward():
    """ExportedTransformerLM with the merged-QKV serving path in the
    W1.58-A8 regime (TiledBitplane): the KV-cached stepwise decode and the
    batched prefill must reproduce the full forward's logits at every
    position — the per-row requantize makes the A8 numerics identical at
    every row count, so the three paths agree."""
    from ternary_spgemm_tpu.formats import TiledBitplane

    model, params, toks = _setup(seed=8)
    exported = ExportedTransformerLM.from_params(
        model, params, TiledBitplane, fused_qkv=True, a8=True)
    assert all(b.qkv is not None and b._a8 for b in exported.blocks)

    want = jax.jit(lambda lm, t: lm(t))(exported, toks)   # full forward
    B, T0 = toks.shape

    caches = init_cache(CFG, B, T0)
    for t in range(T0):
        logits, caches = exported.decode_step(toks[:, t], caches,
                                              jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(want[:, t]),
                                   rtol=2e-4, atol=2e-4)

    pre_logits, _ = exported.prefill(toks, init_cache(CFG, B, T0))
    np.testing.assert_allclose(np.asarray(pre_logits), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_bf16_head():
    """head_dtype=bfloat16 stores the tied embedding at half width (the
    logits head streams the whole (vocab, d) matrix per decode step —
    measured 697 us of the 7B step at f32). Logits must match the f32-head
    model within bf16 operand rounding, and generate() must still work."""
    model, params, toks = _setup(3)
    lm32 = ExportedTransformerLM.from_params(model, params, DenseTernary)
    lm16 = ExportedTransformerLM.from_params(model, params, DenseTernary,
                                             head_dtype=jnp.bfloat16)
    assert lm16.embed.dtype == jnp.bfloat16
    want = np.asarray(lm32(toks))
    got = np.asarray(lm16(toks))
    assert got.dtype == np.float32          # f32 accumulation / output
    # bf16 operands: ~2^-8 relative per factor, summed over d_model terms
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    out = np.asarray(generate(lm16, toks[:, :4], 3))
    assert out.shape == (2, 7)

    # bundle round-trip preserves the bf16 head exactly (raw-bits storage)
    import tempfile

    from ternary_spgemm_tpu import checkpoint
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_lm_bundle(f"{d}/b16", lm16)
        lm16b = checkpoint.load_lm_bundle(f"{d}/b16")
    assert lm16b.embed.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(lm16.embed).view(np.uint16),
        np.asarray(lm16b.embed).view(np.uint16))
    np.testing.assert_allclose(np.asarray(lm16b(toks)), got, rtol=1e-6)


def test_gqa_decode_matches_full_forward():
    """Grouped-query attention (n_kv_heads < n_heads): full causal forward
    == prefill == stepwise decode, on both backends, with the KV cache
    shrunk to the kv-head count. The grouped einsum must equal naive
    repeat-kv attention exactly."""
    cfg = BitTransformerConfig(vocab=48, d_model=64, n_heads=8,
                               n_kv_heads=2, d_ff=64, n_layers=2)
    assert cfg.kv_width == 16 and cfg.head_tuple == (8, 2)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(2))
    assert params["blocks"][0]["wk"]["w"].shape == (64, 16)
    toks = jax.random.randint(jax.random.key(3), (2, 9), 0, cfg.vocab)

    want = model.apply(params, toks)
    # stepwise decode
    caches = init_cache(cfg, 2, 9)
    assert caches[0]["k"].shape == (2, 2, 9, 8)     # H = kv_heads
    for t in range(9):
        logits, caches = lm_decode_step(model, params, toks[:, t], caches,
                                        jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(want[:, t]),
                                   rtol=2e-4, atol=2e-4)
    # prefill
    from ternary_spgemm_tpu.models.generate import lm_prefill
    pre, _ = lm_prefill(model, params, toks, init_cache(cfg, 2, 9))
    np.testing.assert_allclose(np.asarray(pre), np.asarray(want),
                               rtol=2e-4, atol=2e-4)

    # exported backend with merged QKV + int8 cache + generate()
    from ternary_spgemm_tpu.formats import TiledBitplane
    lm = ExportedTransformerLM.from_params(
        model, params, TiledBitplane, kernel="TiledBitplane_x8",
        a8=True, fused_qkv=True, with_transpose=False)
    assert lm.blocks[0].qkv["fmt"].N == 64 + 2 * 16
    we = np.asarray(jax.jit(lambda m, t: m(t))(lm, toks))
    # f32 cache: prefill must match the uncached forward tightly
    pe, _ = jax.jit(lambda m, t, c: m.prefill(t, c))(
        lm, toks, init_cache(cfg, 2, 12))
    np.testing.assert_allclose(np.asarray(pe), we, rtol=2e-3, atol=2e-3)
    # int8 cache: prefill == stepwise decode (same rounding both paths)
    pi, ci = jax.jit(lambda m, t, c: m.prefill(t, c))(
        lm, toks, init_cache(cfg, 2, 12, dtype=jnp.int8))
    li, _ = jax.jit(lambda m, t, c: m.decode_step(t, c, jnp.int32(9)))(
        lm, toks[:, 0], ci)
    assert np.all(np.isfinite(np.asarray(pi)))
    assert np.all(np.isfinite(np.asarray(li)))
    out = np.asarray(generate(lm, toks[:, :4], 3, cache_dtype=jnp.int8))
    assert out.shape == (2, 7)


def test_gqa_grouped_equals_repeated_kv():
    """The grouped attention einsum == naive repeat-kv MHA attention."""
    from ternary_spgemm_tpu.models.transformer import causal_attend

    B, T, d, nq, nkv = 2, 6, 32, 8, 2
    hd = d // nq
    key = jax.random.key(0)
    q = jax.random.normal(key, (B, T, d))
    k = jax.random.normal(jax.random.key(1), (B, T, nkv * hd))
    v = jax.random.normal(jax.random.key(2), (B, T, nkv * hd))
    got = causal_attend((nq, nkv), q, k, v)
    # naive: repeat each kv head G times and run MHA
    G = nq // nkv
    rep = lambda z: jnp.repeat(z.reshape(B, T, nkv, hd), G, axis=2
                               ).reshape(B, T, d)
    want = causal_attend(nq, q, rep(k), rep(v))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_chunked_prefill_matches_full():
    """chunked_prefill == unchunked prefill exactly (same caches, same
    last-chunk logits), on both backends, with GQA + int8 cache, and with
    a remainder chunk. One compiled program serves all full chunks (the
    start is traced)."""
    from ternary_spgemm_tpu.models.generate import (
        chunked_prefill, lm_prefill)

    cfg = BitTransformerConfig(vocab=48, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=64, n_layers=2)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(4))
    toks = jax.random.randint(jax.random.key(5), (2, 10), 0, cfg.vocab)

    # QAT backend
    full_logits, full_caches = lm_prefill(model, params, toks,
                                          init_cache(cfg, 2, 12))
    ch_logits, ch_caches = chunked_prefill(model, toks,
                                           init_cache(cfg, 2, 12), 4,
                                           params=params)
    # last (remainder) chunk covers positions 8..9
    np.testing.assert_allclose(np.asarray(ch_logits),
                               np.asarray(full_logits[:, 8:]),
                               rtol=2e-4, atol=2e-4)
    for fc, cc in zip(full_caches, ch_caches):
        for k in fc:
            np.testing.assert_allclose(np.asarray(fc[k])[:, :, :10],
                                       np.asarray(cc[k])[:, :, :10],
                                       rtol=2e-4, atol=2e-4)

    # exported backend + int8 cache: chunked caches must let decode
    # continue identically to full-prefill caches
    from ternary_spgemm_tpu.formats import DenseTernary
    lm = ExportedTransformerLM.from_params(model, params, DenseTernary)
    fl, fcs = jax.jit(lambda m, t, c: m.prefill(t, c))(
        lm, toks, init_cache(cfg, 2, 12, dtype=jnp.int8))
    cl, ccs = chunked_prefill(lm, toks,
                              init_cache(cfg, 2, 12, dtype=jnp.int8), 5)
    np.testing.assert_allclose(np.asarray(cl), np.asarray(fl[:, 5:]),
                               rtol=2e-4, atol=2e-4)
    nxt = jnp.zeros((2,), toks.dtype)
    lf, _ = lm.decode_step(nxt, fcs, jnp.int32(10))
    lc, _ = lm.decode_step(nxt, ccs, jnp.int32(10))
    np.testing.assert_allclose(np.asarray(lc), np.asarray(lf),
                               rtol=2e-4, atol=2e-4)


def test_sliding_window_attention():
    """window>0 (Mistral local attention): full forward == prefill ==
    chunked prefill == stepwise decode; window >= T equals full causal;
    changing a token OUTSIDE the window does not change the logits at a
    position, while full attention does notice it."""
    from ternary_spgemm_tpu.models.generate import (
        chunked_prefill, lm_prefill)

    cfg = BitTransformerConfig(vocab=48, d_model=32, n_heads=2,
                               d_ff=64, n_layers=2, window=3)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(11))
    toks = jax.random.randint(jax.random.key(12), (2, 9), 0, cfg.vocab)

    want = model.apply(params, toks)
    caches = init_cache(cfg, 2, 9)
    for t in range(9):
        logits, caches = lm_decode_step(model, params, toks[:, t], caches,
                                        jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(want[:, t]),
                                   rtol=2e-4, atol=2e-4)
    pre, _ = lm_prefill(model, params, toks, init_cache(cfg, 2, 9))
    np.testing.assert_allclose(np.asarray(pre), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    ch, _ = chunked_prefill(model, toks, init_cache(cfg, 2, 9), 4,
                            params=params)
    np.testing.assert_allclose(np.asarray(ch), np.asarray(want[:, 8:]),
                               rtol=2e-4, atol=2e-4)

    # locality: position 8 sees only positions 6..8 at window=3 — editing
    # token 2 must not change logits[8]; the full-attention model notices
    toks2 = toks.at[:, 2].set((toks[:, 2] + 1) % cfg.vocab)
    want2 = model.apply(params, toks2)
    np.testing.assert_allclose(np.asarray(want2[:, 8]),
                               np.asarray(want[:, 8]), rtol=1e-5, atol=1e-5)
    cfg_full = BitTransformerConfig(vocab=48, d_model=32, n_heads=2,
                                    d_ff=64, n_layers=2)
    full = BitTransformerLM(cfg_full)
    f1 = full.apply(params, toks)
    f2 = full.apply(params, toks2)
    assert np.abs(np.asarray(f1[:, 8]) - np.asarray(f2[:, 8])).max() > 1e-6

    # window >= T: identical to full causal attention
    cfg_big = BitTransformerConfig(vocab=48, d_model=32, n_heads=2,
                                   d_ff=64, n_layers=2, window=64)
    big = BitTransformerLM(cfg_big)
    np.testing.assert_allclose(np.asarray(big.apply(params, toks)),
                               np.asarray(f1), rtol=1e-5, atol=1e-5)


def test_ring_cache_matches_full_cache():
    """Ring-buffer KV cache (O(window) slots): generation equals the
    full-cache run token-for-token, far beyond the window; per-step decode
    logits match exactly once positions wrap; prompt-too-long with
    prefill raises; prefill=False accepts any prompt length."""
    import pytest

    from ternary_spgemm_tpu.models.generate import init_cache as ic

    cfg = BitTransformerConfig(vocab=48, d_model=32, n_heads=2,
                               n_kv_heads=1, d_ff=64, n_layers=2, window=4)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(13))
    prompt = jax.random.randint(jax.random.key(14), (2, 3), 0, cfg.vocab)

    full = generate(model, prompt, 10, params=params)
    ringo = generate(model, prompt, 10, params=params, ring=True)
    np.testing.assert_array_equal(np.asarray(ringo), np.asarray(full))

    # the ring really is window-sized
    rc = ic(cfg, 2, 64, ring=True)
    assert rc[0]["k"].shape[2] == 4 and rc[0]["pos_tab"].shape == (4,)
    # stepwise logits: ring == full cache at every position incl. wraps
    toks = jax.random.randint(jax.random.key(15), (2, 9), 0, cfg.vocab)
    c_full = ic(cfg, 2, 9)
    c_ring = ic(cfg, 2, 9, ring=True)
    for t in range(9):
        lf, c_full = lm_decode_step(model, params, toks[:, t], c_full,
                                    jnp.asarray(t))
        lr, c_ring = lm_decode_step(model, params, toks[:, t], c_ring,
                                    jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(lr), np.asarray(lf),
                                   rtol=2e-4, atol=2e-4)

    long_prompt = jax.random.randint(jax.random.key(16), (1, 7), 0,
                                     cfg.vocab)
    with pytest.raises(ValueError, match="exceeds the window"):
        generate(model, long_prompt, 2, params=params, ring=True)
    out = generate(model, long_prompt, 2, params=params, ring=True,
                   prefill=False)
    np.testing.assert_array_equal(
        np.asarray(out),
        np.asarray(generate(model, long_prompt, 2, params=params,
                            prefill=False)))
    with pytest.raises(ValueError, match="requires cfg.window"):
        ic(BitTransformerConfig(vocab=8, d_model=16, n_heads=2, d_ff=16),
           1, 8, ring=True)
