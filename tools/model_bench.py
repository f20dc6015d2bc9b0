#!/usr/bin/env python
"""Model-level serving/training benchmark: a full ternary transformer block
at BitNet shapes, across exported-container kernels.

The SpMM sweeps (tools/sweep.py) measure the isolated op the way the
reference's driver does (``cpp_impl/main.cpp:251-296``); this tool measures
what a framework user actually deploys — one transformer block (attention +
FFN, seven ternary projections) — in three regimes:

* ``qat``      — training forward+backward step time (STE quantization live)
* ``exported`` — frozen-container inference through the kernel registry
* ``a8``       — BitNet W1.58-A8 serving (per-token int8 activations onto
                 the ``_x8`` kernels)

Output: one JSON artifact, {regime/kernel: seconds per block call}.
Presets: ``bitnet3b`` d=3200 ff=8640 (b1.58 3B), ``bitnet7b`` d=4096
ff=11008, ``test`` (tiny, CPU-runnable — used by the test suite).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

PRESETS = {
    "test": dict(d_model=64, n_heads=4, d_ff=128, B=2, T=16),
    "bitnet3b": dict(d_model=3200, n_heads=32, d_ff=8640, B=1, T=512),
    "bitnet7b": dict(d_model=4096, n_heads=32, d_ff=11008, B=1, T=512),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", choices=sorted(PRESETS), default="bitnet7b")
    p.add_argument("--format", dest="fmt", default="TiledBitplane")
    p.add_argument("--kernels", default=None,
                   help="comma-separated exported-path kernels (default: "
                        "the registered kernels for --format)")
    p.add_argument("--regimes", default="qat,exported,a8")
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the host; otherwise a GPU is required")
    p.add_argument("--min-seconds", type=float, default=0.1)
    p.add_argument("--output", default="model_bench.json")
    args = p.parse_args(argv)

    if args.platform:
        import jax
        jax.config.update("jax_platforms", args.platform)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from ternary_spgemm_tpu import platform
    from ternary_spgemm_tpu.bench.timing import time_device_loop
    from ternary_spgemm_tpu.formats import all_formats
    from ternary_spgemm_tpu.models import BitTransformerConfig
    from ternary_spgemm_tpu.models.transformer import (
        BitTransformerBlock, ExportedTransformerBlock)
    from ternary_spgemm_tpu.ops.api import all_kernels

    platform.configure_compile_cache()
    platform.measurement_device(args.platform)
    shape = PRESETS[args.preset]
    cfg = BitTransformerConfig(vocab=64, d_model=shape["d_model"],
                               n_heads=shape["n_heads"], d_ff=shape["d_ff"],
                               n_layers=1)
    block = BitTransformerBlock(cfg)
    params = block.init(jax.random.key(0))
    B, T = shape["B"], shape["T"]
    x = jax.random.normal(jax.random.key(1), (B, T, cfg.d_model), jnp.float32)

    fmt_cls = all_formats()[args.fmt]
    regimes = args.regimes.split(",")
    results = {"preset": args.preset, "shape": shape, "format": args.fmt,
               "results": {}}

    def record(name, seconds, ntok=None):
        ntok = B * T if ntok is None else ntok
        proj_flops = 2 * ntok * (4 * cfg.d_model ** 2
                                 + 3 * cfg.d_model * cfg.d_ff)
        rec = {"seconds": seconds,
               "proj_tflops_effective": proj_flops / seconds / 1e12}
        results["results"][name] = rec
        print(json.dumps({name: rec}), flush=True)

    if "qat" in regimes:
        opt = optax.sgd(1e-3)

        def train_step(z, p, s):
            def loss(q):
                return jnp.mean(block.apply(q, z) ** 2)
            l, g = jax.value_and_grad(loss)(p)
            up, s = opt.update(g, s)
            return optax.apply_updates(p, up), s, l

        state = opt.init(params)

        def step_probe(z, p, s):
            # consume EVERY output leaf: returning only the loss lets XLA
            # dead-code the whole optimizer update (and the backward pass
            # feeding it) — the bench/timing.py output-elision trap, at the
            # pytree level. The 1e-30-scaled full-sum forces materialization
            # at ~one extra read pass over params+moments.
            p2, s2, l = train_step(z, p, s)
            total = sum(jnp.sum(a.astype(jnp.float32))
                        for a in jax.tree_util.tree_leaves((p2, s2)))
            return l + 1e-30 * total

        t = time_device_loop(step_probe, x, aux=(params, state),
                             min_seconds=args.min_seconds)
        record("qat_train_step", t.seconds)

        t = time_device_loop(lambda z, p: block.apply(p, z), x, aux=(params,),
                             min_seconds=args.min_seconds)
        record("qat_forward", t.seconds)

    if "exported" in regimes:
        if args.kernels:
            kernels = args.kernels.split(",")
        else:
            kernels = [s.name for s in all_kernels().values()
                       if s.format_cls is fmt_cls and not s.gpu_only
                       and s.x_absmax != 127]
        for kname in kernels:
            try:
                exported = ExportedTransformerBlock.from_params(
                    cfg, params, fmt_cls, kernel=kname)
                t = time_device_loop(lambda z, blk: blk(z), x,
                                     aux=(exported,),
                                     min_seconds=args.min_seconds)
                record(f"exported/{kname}", t.seconds)
            except Exception as e:  # capture per-kernel failures, keep going
                results["results"][f"exported/{kname}"] = {
                    "error": f"{type(e).__name__}: {e}"}
                print(f"exported/{kname} FAILED: {e}", flush=True)

        # Measured dispatch (VERDICT round-3 next #8): every projection picks
        # its own autotuned winner for its (M, K, N) instead of one fixed
        # kernel for the whole block — the reference's dispatch policy is a
        # hard-coded registration order (main.cpp:76-190); here it is a
        # measurement. Two regimes: prefill-shaped (M=B*T) and decode-shaped
        # (M=B, the token-by-token serving shape).
        from ternary_spgemm_tpu.models import autotune_exported

        for tag, M_resolve, z in [("prefill", B * T, x), ("decode", B,
                                                          x[:, :1, :])]:
            ntok = z.shape[0] * z.shape[1]
            try:
                exported = ExportedTransformerBlock.from_params(
                    cfg, params, fmt_cls, kernel="auto")
                picks = autotune_exported(
                    exported, M_resolve, absmax=512,
                    cache_path=os.path.join(os.path.dirname(args.output),
                                            "autotune_cache.json"))
                t = time_device_loop(lambda q, blk: blk(q), z,
                                     aux=(exported,),
                                     min_seconds=args.min_seconds)
                record(f"exported/auto_{tag}", t.seconds, ntok=ntok)
                results["results"][f"exported/auto_{tag}"]["picks"] = {
                    f"{k[0]}x{k[1]}": v for k, v in picks.items()}
            except Exception as e:
                results["results"][f"exported/auto_{tag}"] = {
                    "error": f"{type(e).__name__}: {e}"}
                print(f"exported/auto_{tag} FAILED: {e}", flush=True)

        # fixed-kernel decode-shaped baseline for the auto comparison
        fixed_name = ("TiledBitplane" if "TiledBitplane" in kernels
                      else (kernels[0] if kernels else None))
        if fixed_name:
            try:
                exported_f = ExportedTransformerBlock.from_params(
                    cfg, params, fmt_cls, kernel=fixed_name)
                t = time_device_loop(lambda q, blk: blk(q), x[:, :1, :],
                                     aux=(exported_f,),
                                     min_seconds=args.min_seconds)
                record(f"exported/{fixed_name}_decode", t.seconds, ntok=B)
            except Exception as e:
                results["results"][f"exported/{fixed_name}_decode"] = {
                    "error": f"{type(e).__name__}: {e}"}

        # decode-shaped block with the merged-QKV container (one SpMM over
        # hstack(Wq,Wk,Wv)) — the serving fast path
        if fixed_name:
            try:
                exported_q = ExportedTransformerBlock.from_params(
                    cfg, params, fmt_cls, kernel=fixed_name, fused_qkv=True)
                t = time_device_loop(lambda q, blk: blk(q), x[:, :1, :],
                                     aux=(exported_q,),
                                     min_seconds=args.min_seconds)
                record("exported/fused_qkv_decode", t.seconds, ntok=B)
            except Exception as e:
                results["results"]["exported/fused_qkv_decode"] = {
                    "error": f"{type(e).__name__}: {e}"}
                print(f"exported/fused_qkv_decode FAILED: {e}", flush=True)

    if "a8" in regimes:
        # serving path: every projection through apply_exported_a8
        from ternary_spgemm_tpu.models import apply_exported_a8, export_layer
        from ternary_spgemm_tpu.models.transformer import (
            causal_attend, rms_norm)

        a8_ok = any(s.format_cls is fmt_cls and s.x_absmax == 127
                    for s in all_kernels().values())
        if not a8_ok:
            results["results"]["a8_block"] = {
                "error": f"no _x8 kernel registered for {args.fmt}"}
        else:
            import jax.numpy as _jnp

            # device-resident containers (the serving condition): host-numpy
            # leaves in the timed args would re-transfer on every call
            frozen = {n: jax.tree_util.tree_map(
                          lambda a: _jnp.asarray(a)
                          if hasattr(a, "shape") else a,
                          export_layer(params[n], fmt_cls))
                      for n in BitTransformerBlock.LINEARS}

            def a8_block(z, fro, na, nf):
                Bz, Tz, d = z.shape
                def lin(n, h):
                    fmt, gamma, b, alpha = fro[n]
                    y = apply_exported_a8(h.reshape(Bz * Tz, -1), fmt,
                                          gamma, b, alpha)
                    return y.reshape(Bz, Tz, -1)
                h = rms_norm(z, na)
                attn = lin("wo", causal_attend(cfg.n_heads, lin("wq", h),
                                               lin("wk", h), lin("wv", h)))
                z = z + attn
                h = rms_norm(z, nf)
                return z + lin("w_down",
                               jax.nn.silu(lin("w_gate", h)) * lin("w_up", h))

            t = time_device_loop(
                a8_block, x,
                aux=(frozen, params["norm_attn"], params["norm_ffn"]),
                min_seconds=args.min_seconds)
            record("a8_block", t.seconds)

    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
