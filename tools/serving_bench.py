#!/usr/bin/env python
"""End-to-end serving benchmark: whole-model tokens/sec for BitNet configs.

Times the real serving loop — ``models/generate.py``'s prefill and KV-cached
scan decode with every serving path on (merged QKV, W1.58-A8 activations,
int8 KV cache) — on one GPU, and prints one JSON record with the device it
ran on. It is a measurement path: without a GPU it stops.

Model construction bypasses the QAT param tree: weights come straight from
the native ternary generator into ``ExportedBitLinear.from_dense(...,
a8=True, with_transpose=False)`` containers (the serving export). Ternary
density s=2 (about half nonzero — the BitNet b1.58 regime).

Timing uses the calibrated device-loop slope protocol (bench/timing.py).
Integer token inputs cannot ride as the perturbed while-carry, so each
timed fn takes an f32 dummy carry whose (runtime-zero) minimum is added to
the first token — a real data dependency, a no-op value.

Run: python tools/serving_bench.py --preset bitnet3b --batch 4
Reference counterpart: none (net-new serving obligation).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PRESETS = {
    "test": dict(d_model=64, n_heads=4, d_ff=128, n_layers=2, vocab=64,
                 T0=8, n_new=4),
    "bitnet3b": dict(d_model=3200, n_heads=32, d_ff=8640, n_layers=26,
                     vocab=32000, T0=512, n_new=64),
    "bitnet7b": dict(d_model=4096, n_heads=32, d_ff=11008, n_layers=32,
                     vocab=32000, T0=512, n_new=64),
}


def weight_generator():
    """``(gen(K, N, s, seed) -> int8 (K, N), name)``: the native ternary
    generator when ``native/`` is built, else the numpy one."""
    from ternary_spgemm_tpu import native
    from ternary_spgemm_tpu.formats import generate_ternary

    if native.native_available():
        return native.gen_ternary, "native"
    return (lambda K, N, s, seed: generate_ternary(K, N, s, seed=seed)), "numpy"


def build_serving_lm(cfg, *, s: int = 2, seed: int = 0, head_dtype=None,
                     fused_qkv: bool = True, keep_dense: bool = False,
                     verbose=print):
    """A serving-export LM, weights straight from the ternary generator (no
    QAT param tree, no transposes): every projection a W1.58-A8
    ``TiledBitplane`` layer, q/k/v merged when ``fused_qkv``.

    ``keep_dense=True`` returns ``(lm, layers)`` where ``layers`` holds the
    dense int8 matrices, scales and norm weights of each block in the form
    :func:`ternary_spgemm_tpu.reference.ternary_lm_logits` takes."""
    import jax
    import jax.numpy as jnp

    from ternary_spgemm_tpu.formats import TiledBitplane
    from ternary_spgemm_tpu.models.exported import ExportedBitLinear
    from ternary_spgemm_tpu.models.generate import ExportedTransformerLM
    from ternary_spgemm_tpu.models.transformer import ExportedTransformerBlock

    gen, _ = weight_generator()
    d, ff, kvw = cfg.d_model, cfg.d_ff, cfg.kv_width
    gamma = 0.03  # serving-realistic absmean scale

    def lin(W, n_out):
        return ExportedBitLinear.from_dense(
            W, TiledBitplane, gamma=gamma, bias=np.zeros(n_out, np.float32),
            with_transpose=False, a8=True)

    blocks, dense = [], []
    t0 = time.time()
    for li in range(cfg.n_layers):
        sd = seed + 100 * li
        Ws = {"wq": gen(d, d, s, seed=sd + 1), "wk": gen(d, kvw, s, seed=sd + 2),
              "wv": gen(d, kvw, s, seed=sd + 3), "wo": gen(d, d, s, seed=sd + 4),
              "w_gate": gen(d, ff, s, seed=sd + 5),
              "w_up": gen(d, ff, s, seed=sd + 6),
              "w_down": gen(ff, d, s, seed=sd + 7)}
        linears = {n: lin(W, W.shape[1]) for n, W in Ws.items()}
        qkv = None
        if fused_qkv:
            w3 = d + 2 * kvw
            qkv = {"fmt": jax.tree_util.tree_map(
                       jnp.asarray, TiledBitplane.from_dense(
                           np.hstack([Ws["wq"], Ws["wk"], Ws["wv"]]))),
                   "scale": jnp.full((w3,), gamma, jnp.float32),
                   "bias": jnp.zeros((w3,), jnp.float32)}
        blocks.append(ExportedTransformerBlock(
            cfg, linears, np.ones(d, np.float32), np.ones(d, np.float32),
            qkv=qkv))
        if keep_dense:
            dense.append({**Ws, **{f"g_{n}": np.float32(gamma) for n in Ws},
                          "norm_attn": np.ones(d, np.float32),
                          "norm_ffn": np.ones(d, np.float32)})
        if li == 0 or (li + 1) % 8 == 0:
            verbose(f"built block {li + 1}/{cfg.n_layers} "
                    f"({time.time() - t0:.0f}s)")
    embed = 0.02 * jax.random.normal(jax.random.key(seed + 9),
                                     (cfg.vocab, d), jnp.float32)
    lm = ExportedTransformerLM(cfg, blocks, embed, np.ones(d, np.float32),
                               head_dtype=head_dtype)
    return (lm, dense) if keep_dense else lm


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", choices=sorted(PRESETS), default="bitnet3b")
    p.add_argument("--s", type=int, default=2)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--cache-dtype", default="int8", choices=["int8", "f32"])
    p.add_argument("--head-dtype", default="f32", choices=["f32", "bf16"],
                   help="logits-head embedding storage: bf16 halves the "
                        "per-step head bytes (the head streams the whole "
                        "(vocab, d) matrix every decode step)")
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention: number of shared KV heads "
                        "(0 = n_heads, MHA)")
    p.add_argument("--batch", type=int, default=1, help="decode batch B")
    p.add_argument("--trace", default=None,
                   help="directory for a profiler trace of a few decode "
                        "steps, taken after the timing")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ternary_spgemm_tpu import platform
    from ternary_spgemm_tpu.bench.timing import time_device_loop
    from ternary_spgemm_tpu.models import BitTransformerConfig
    from ternary_spgemm_tpu.models.generate import generate, init_cache

    platform.configure_compile_cache()
    dev = platform.require_gpu()
    shape = PRESETS[args.preset]
    cfg = BitTransformerConfig(
        vocab=shape["vocab"], d_model=shape["d_model"],
        n_heads=shape["n_heads"], d_ff=shape["d_ff"],
        n_layers=shape["n_layers"], n_kv_heads=args.kv_heads)
    T0, n_new = shape["T0"], shape["n_new"]
    B, max_t = args.batch, T0 + n_new
    cache_dtype = jnp.int8 if args.cache_dtype == "int8" else jnp.float32

    t0 = time.time()
    head_dtype = jnp.bfloat16 if args.head_dtype == "bf16" else None
    lm = build_serving_lm(cfg, s=args.s, head_dtype=head_dtype)
    build_s = time.time() - t0
    print(f"build: {build_s:.0f}s", flush=True)

    prompt = jax.random.randint(jax.random.key(42), (B, T0), 0, cfg.vocab)
    caches0 = init_cache(cfg, B, max_t, dtype=cache_dtype)

    # the real generate() loop produces tokens in range
    toks = np.asarray(generate(lm, prompt[:, :8], 4, max_t=max_t,
                               cache_dtype=cache_dtype))
    assert toks.shape == (B, 12) and (0 <= toks).all() and \
        (toks < cfg.vocab).all()

    dummy = jnp.zeros((8,), jnp.float32)

    def dep(tokens, dz):
        # runtime-zero, trace-opaque data dependency on the timed carry
        return tokens + jnp.minimum(dz[0], 0.0).astype(tokens.dtype)

    # The model rides through every timed fn as an AUX ARGUMENT, never a
    # closure capture: captured container leaves inline as HLO literal
    # constants that ship with every compile (docs/perf.md).
    def fill_fn(dz, m, pr, cs):
        logits, _ = m.prefill(dep(pr, dz), cs)
        return logits[:, -1]

    r_fill = time_device_loop(fill_fn, dummy, aux=(lm, prompt, caches0),
                              repeats=args.repeats, min_seconds=0.5)
    print(f"prefill: {r_fill.seconds * 1e3:.3f} ms", flush=True)

    _, caches_f = jax.jit(lambda m, pr, cs: m.prefill(pr, cs))(
        lm, prompt, caches0)
    first = jnp.zeros((B,), prompt.dtype)

    def decode_fn(dz, m, fr, cs):
        def scan_fn(carry, t):
            caches, cur = carry
            logits, caches = m.decode_step(cur, caches, t)
            nxt = jnp.argmax(logits, axis=-1).astype(fr.dtype)
            return (caches, nxt), cur
        (_, last), _ = jax.lax.scan(
            scan_fn, (cs, dep(fr, dz)), jnp.arange(T0, T0 + n_new))
        return last.astype(jnp.float32)

    r_dec = time_device_loop(decode_fn, dummy, aux=(lm, first, caches_f),
                             repeats=args.repeats, min_seconds=0.5)
    step_s = r_dec.seconds / n_new
    print(f"decode: {step_s * 1e6:.1f} us/step", flush=True)

    out = {
        "preset": args.preset, "config": shape, "s": args.s,
        "kv_heads": cfg.kv_heads, "batch": B,
        "cache_dtype": args.cache_dtype, "head_dtype": args.head_dtype,
        "build_seconds": build_s,
        "prefill": {"seconds": r_fill.seconds,
                    "spread": r_fill.seconds_spread,
                    "tokens_per_s": B * T0 / r_fill.seconds},
        "decode": {"seconds_per_step": step_s,
                   "spread": r_dec.seconds_spread,
                   "tokens_per_s": B / step_s, "scan_length": n_new},
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if args.trace:
        dec = jax.jit(decode_fn)
        jax.block_until_ready(dec(dummy, lm, first, caches_f))
        jax.profiler.start_trace(args.trace, create_perfetto_trace=True)
        for _ in range(3):
            jax.block_until_ready(dec(dummy, lm, first, caches_f))
        jax.profiler.stop_trace()
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
