#!/usr/bin/env python
"""Numerics probes of the served ternary LM on one GPU, at BitNet-3B widths.

    python tools/serve_probe.py [--out FILE.json]

1. **Attention precision.** The 3B (random ternary weights from a seed)
   serves 4 prompts of 128 tokens with 16 new tokens and an f32 KV cache,
   with the attention products over the cache
   (``generate.ATTENTION_PRECISION``) at HIGHEST and at XLA's default (TF32
   on the card), at one layer and at all 26. Each run's logits are compared
   with the plain float32 reference as ``chip_smoke.py`` compares them.
2. **Depth.** On the 26-layer reference over the served tokens: each
   block's share of the final residual, and how far the logits move when
   one block's output is scaled by 1.01 or removed, beside how far the
   wrong references of ``chip_smoke.CONTROLS`` move them, at 26 layers and
   at one. Also the rows the served model misses by more than
   ``chip_smoke.ROW_TOL``.
3. **Decode-attention time.** One decode step's attention (logits, softmax,
   value combine) over a long cache, f32 and int8, at each precision,
   timed with the device-loop protocol (``bench/timing.py``).

Prints one line per reading; ``--out`` also writes them as JSON.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

#: Blocks whose output is perturbed in the depth probe (1-based).
PROBE_BLOCKS = (1, 2, 7, 13, 20, 26)
#: Cache lengths of the decode-attention timing.
ATTN_CACHE_LENGTHS = (4096, 32768)


def _stats(e) -> dict:
    import chip_smoke

    return {"median": float(np.median(e)), "p90": float(np.percentile(e, 90)),
            "max": float(e.max()),
            "share_within_row_tol": float(np.mean(e <= chip_smoke.ROW_TOL))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write the readings as JSON")
    args = p.parse_args(argv)

    import chip_smoke

    card = chip_smoke.card_name_and_power()
    print(f"card: {card}", flush=True)

    import jax
    import jax.numpy as jnp

    from ternary_spgemm_tpu import platform, reference
    from ternary_spgemm_tpu.bench.timing import time_device_loop
    from ternary_spgemm_tpu.models import BitTransformerConfig
    from ternary_spgemm_tpu.models.generate import ExportedTransformerLM
    from tools.serving_bench import build_serving_lm

    # the module, not the function the models package exports by its name
    gen_mod = importlib.import_module("ternary_spgemm_tpu.models.generate")
    platform.configure_compile_cache()
    dev = platform.require_gpu()
    out = {"card": card, "device_kind": dev.device_kind}

    def say(key, value):
        print(f"{key}: {json.dumps(value)}", flush=True)

    cfg = BitTransformerConfig(**chip_smoke.BITNET3B)
    cfg1 = BitTransformerConfig(**{**chip_smoke.BITNET3B, "n_layers": 1})
    N = cfg.n_layers
    t0 = time.time()
    lm, layers = build_serving_lm(cfg, seed=args.seed, keep_dense=True,
                                  verbose=lambda m: None)
    print(f"built the 3B in {time.time() - t0:.1f}s", flush=True)
    lm1 = ExportedTransformerLM(cfg1, lm.blocks[:1], lm.embed, lm.norm_out)
    layers = [jax.tree_util.tree_map(jnp.asarray, L) for L in layers]
    B, T0, n_new = 4, 128, 16
    max_t = T0 + n_new
    prompt = jax.random.randint(jax.random.key(args.seed + 42), (B, T0), 0,
                                cfg.vocab)
    ref_kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads)

    # 1. attention precision
    precisions = {"highest": jax.lax.Precision.HIGHEST,
                  "default": jax.lax.Precision.DEFAULT}
    out["attention_precision"] = {}
    for pname, prec in precisions.items():
        gen_mod.ATTENTION_PRECISION = prec
        for n, model in ((1, lm1), (N, lm)):
            toks, pre, steps = gen_mod.generate(
                model, prompt, n_new, max_t=max_t, cache_dtype=jnp.float32,
                return_logits=True)
            toks = jax.block_until_ready(toks)[:, :max_t]
            served = np.concatenate([np.asarray(pre), np.asarray(steps)], 1)
            want = reference.ternary_lm_logits(toks, lm.embed, layers[:n],
                                               lm.norm_out, **ref_kw)
            e = chip_smoke.row_errors(served, want)
            key = f"{pname} attention, {n} layer(s)"
            out["attention_precision"][key] = _stats(e)
            say(f"served vs reference, {key}", out["attention_precision"][key])
            if pname == "highest" and n == N:
                toksN, eN = toks, e.reshape(B, max_t)
    gen_mod.ATTENTION_PRECISION = jax.lax.Precision.HIGHEST

    # 2. depth, on the reference over the tokens served at full depth
    blk = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.kv_heads)
    with jax.default_matmul_precision("highest"):
        xs = [jnp.asarray(lm.embed)[toksN]]
        for L in layers:
            xs.append(reference.ternary_block(xs[-1], L, **blk))
        head = lambda x: reference.ternary_lm_head(x, lm.embed, lm.norm_out)
        base, base1 = head(xs[-1]), head(xs[1])
        xN = xs[-1]
        norm2 = jnp.sum(xN * xN, -1)

        def share(o):
            # per-row projection of o on the final residual, median over rows
            return float(jnp.median(jnp.sum(o * xN, -1) / norm2))

        def rms_ratio(o):
            return float(jnp.median(jnp.sqrt(jnp.sum(o * o, -1) / norm2)))

        outs = [xs[0]] + [xs[i] - xs[i - 1] for i in range(1, N + 1)]
        depth = {"share_of_final_residual":
                 {("embedding" if i == 0 else f"block {i}"): share(o)
                  for i, o in enumerate(outs)},
                 "rms_over_final_residual":
                 {("embedding" if i == 0 else f"block {i}"): rms_ratio(o)
                  for i, o in enumerate(outs)},
                 "final_residual_row_rms_median": float(jnp.median(
                     jnp.sqrt(norm2 / xN.shape[-1])))}
        say("share of the final residual",
            depth["share_of_final_residual"])
        say("rms over the final residual", depth["rms_over_final_residual"])

        def tail(x, start):
            for L in layers[start:]:
                x = reference.ternary_block(x, L, **blk)
            return head(x)

        moved = {}
        for i in (i for i in PROBE_BLOCKS if i <= N):
            for label, scale in (("x1.01", 1.01), ("removed", 0.0)):
                lg = tail(xs[i - 1] + scale * outs[i], i)
                moved[f"block {i} {label}, {N} layers"] = _stats(
                    chip_smoke.row_errors(lg, base))
        for label, scale in (("x1.01", 1.01), ("removed", 0.0)):
            moved[f"block 1 {label}, 1 layer"] = _stats(chip_smoke.row_errors(
                head(xs[0] + scale * outs[1]), base1))
    for n, want in ((N, base), (1, base1)):
        for label in chip_smoke.CONTROLS:
            kw = chip_smoke.CONTROLS[label]("float32")
            lg = reference.ternary_lm_logits(toksN, lm.embed, layers[:n],
                                             lm.norm_out, **ref_kw, **kw)
            moved[f"{label} reference, {n} layer(s)"] = _stats(
                chip_smoke.row_errors(lg, want))
    depth["logits_moved_vs_reference"] = moved
    for k, v in moved.items():
        say(f"logits moved: {k}", v)

    # rows the full-depth served model misses by more than ROW_TOL
    row_rms = np.asarray(jnp.sqrt(norm2 / xN.shape[-1]))
    bad = np.argwhere(eN > chip_smoke.ROW_TOL)
    depth["served_rows_beyond_row_tol"] = [
        {"batch": int(b), "position": int(t), "error": float(eN[b, t]),
         "final_residual_rms_over_median": float(
             row_rms[b, t] / np.median(row_rms))}
        for b, t in bad]
    say(f"served rows beyond ROW_TOL ({N} layers)",
        depth["served_rows_beyond_row_tol"])
    out["depth"] = depth

    # 3. decode-attention time over a long cache
    hd, H = cfg.d_model // cfg.n_heads, cfg.kv_heads
    out["decode_attention"] = {}
    for T in ATTN_CACHE_LENGTHS:
        kk = jax.random.normal(jax.random.key(1), (B, H, T, hd), jnp.float32)
        vv = jax.random.normal(jax.random.key(2), (B, H, T, hd), jnp.float32)
        caches = {"float32": {"k": kk, "v": vv}}
        kq, ks = gen_mod._quant_rows(kk)
        vq, vs = gen_mod._quant_rows(vv)
        caches["int8"] = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        del kk, vv
        q = jax.random.normal(jax.random.key(3), (B, H, 1, hd), jnp.float32)
        for cd, cache in caches.items():
            nbytes = sum(int(a.size) * a.dtype.itemsize
                         for a in cache.values())
            for pname, prec in precisions.items():
                gen_mod.ATTENTION_PRECISION = prec

                def attend(q, c):
                    logits, combine = gen_mod._cache_attn(
                        q, c, hd_scale=hd ** -0.5)
                    return combine(jax.nn.softmax(logits, axis=-1))

                r = time_device_loop(attend, q, aux=(cache,), repeats=3)
                key = f"{cd} cache, T={T}, {pname}"
                out["decode_attention"][key] = {
                    "seconds": r.seconds, "spread": r.seconds_spread,
                    "cache_bytes": nbytes,
                    "cache_bytes_per_s": nbytes / r.seconds}
                say(f"decode attention {key}", out["decode_attention"][key])
        del caches
    gen_mod.ATTENTION_PRECISION = jax.lax.Precision.HIGHEST

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
