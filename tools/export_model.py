#!/usr/bin/env python
"""Checkpoint -> serving bundle -> generation: the deployment CLI.

Completes the production story end-to-end (net-new vs the reference, which
stops at benchmark JSONs — SURVEY.md §5 "checkpoint/resume: none"):

  # freeze a trained checkpoint into a one-file ternary serving bundle
  python tools/export_model.py export --checkpoint ckpt --cfg cfg.json \
      --format TiledBitplane --out model_bundle.npz

  # decode from the bundle (no training-time objects needed)
  python tools/export_model.py generate --bundle model_bundle.npz \
      --prompt "3 1 4 1 5" --new-tokens 16

``cfg.json`` holds BitTransformerConfig fields (e.g. ``{"vocab": 256,
"d_model": 128, "n_heads": 4, "d_ff": 256, "n_layers": 2}``). The
checkpoint is a ``checkpoint.save_pytree`` file of either the params tree
itself or a training state whose ``--state-key`` (default ``params``) holds
it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cmd_export(args) -> int:
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ternary_spgemm_tpu import checkpoint
    from ternary_spgemm_tpu.formats import all_formats
    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)
    from ternary_spgemm_tpu.models.generate import ExportedTransformerLM

    cfg = BitTransformerConfig(**json.load(open(args.cfg)))
    model = BitTransformerLM(cfg)
    like = model.init(jax.random.key(0))
    if args.state_key:
        # leaf layout of the saved training state: restore against a state
        # skeleton holding the params under the given key
        import optax
        state_like = {"params": like,
                      "opt": optax.adam(1e-3).init(like),
                      "step": 0}
        try:
            params = checkpoint.restore_pytree(args.checkpoint,
                                               state_like)[args.state_key]
        except (KeyError, IndexError):
            params = checkpoint.restore_pytree(args.checkpoint, like)
    else:
        params = checkpoint.restore_pytree(args.checkpoint, like)
    fmt_cls = all_formats()[args.format]
    import jax.numpy as jnp
    lm = ExportedTransformerLM.from_params(
        model, params, fmt_cls, kernel=args.kernel, a8=args.a8,
        with_transpose=not args.serving_only,
        fused_qkv=args.fused_qkv, auto=args.auto,
        head_dtype=jnp.bfloat16 if args.head_dtype == "bf16" else None)
    checkpoint.save_lm_bundle(args.out, lm)
    size = os.path.getsize(args.out if args.out.endswith(".npz")
                           else args.out + ".npz")
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(f"wrote {args.out}: {size / 1e6:.2f} MB for {n_params / 1e6:.2f}M "
          f"params ({args.format})")
    return 0


def cmd_generate(args) -> int:
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from ternary_spgemm_tpu import checkpoint
    from ternary_spgemm_tpu.models.generate import generate

    lm = checkpoint.load_lm_bundle(args.bundle)
    prompt = np.array([[int(t) for t in args.prompt.split()]], np.int32)
    if prompt.max() >= lm.cfg.vocab:
        raise SystemExit(f"prompt token {prompt.max()} >= vocab {lm.cfg.vocab}")
    out = generate(lm, jnp.asarray(prompt), args.new_tokens,
                   cache_dtype=jnp.int8 if args.int8_kv else jnp.float32,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, key=jax.random.key(args.seed))
    toks = np.asarray(out)[0, prompt.shape[1]:].tolist()
    print(" ".join(map(str, toks)))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("export", help="checkpoint -> serving bundle")
    pe.add_argument("--checkpoint", required=True)
    pe.add_argument("--cfg", required=True, help="BitTransformerConfig JSON")
    pe.add_argument("--format", default="TiledBitplane",
                    help="container class name (formats.all_formats())")
    pe.add_argument("--kernel", default=None,
                    help="pin a registry kernel (default: safe dispatch)")
    pe.add_argument("--state-key", default="params",
                    help="key of the params tree inside a saved training "
                         "state ('' if the checkpoint IS the params tree)")
    pe.add_argument("--a8", action="store_true",
                    help="W1.58-A8 serving mode: per-row int8 activation "
                         "requantize on every projection")
    pe.add_argument("--serving-only", action="store_true",
                    help="skip the transposed containers (forward-only "
                         "export; halves bundle size + export time)")
    pe.add_argument("--fused-qkv", action="store_true")
    pe.add_argument("--auto", action="store_true",
                    help="pick fused_qkv by MEASUREMENT at the decode shape "
                         "(autotune_serving_flags)")
    pe.add_argument("--head-dtype", default="f32", choices=["f32", "bf16"],
                    help="logits-head embedding storage (bf16 halves the "
                         "per-step head bytes)")
    pe.add_argument("--out", required=True)
    pe.add_argument("--platform", default=None)
    pe.set_defaults(fn=cmd_export)

    pg = sub.add_parser("generate", help="greedy decode from a bundle")
    pg.add_argument("--bundle", required=True)
    pg.add_argument("--prompt", required=True,
                    help="space-separated token ids")
    pg.add_argument("--new-tokens", type=int, default=16)
    pg.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (default); >0 samples the softmax")
    pg.add_argument("--top-k", type=int, default=0)
    pg.add_argument("--top-p", type=float, default=1.0)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--int8-kv", action="store_true",
                    help="serve with the int8 KV cache (4x smaller)")
    pg.add_argument("--platform", default=None)
    pg.set_defaults(fn=cmd_generate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
