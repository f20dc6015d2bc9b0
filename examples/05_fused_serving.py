#!/usr/bin/env python
"""Serving fast paths: the merged-QKV container on an exported transformer
block, the per-row int8 activation regime, and how to let measurement pick.

* ``fused_qkv=True`` — q/k/v projections merged into one ternary container
  over ``hstack(Wq, Wk, Wv)``: one SpMM instead of three, sharing the
  activation read (and, with ``a8=True``, one per-row requantize).
* ``a8=True`` — W1.58-A8: activations requantized per row to int8 before
  every projection, which then runs on an int8 kernel (on a GPU at decode
  row counts, the fused Triton bitplane kernel).

Whether the merged container wins depends on the shape, so the deployment
API can measure instead of guessing: ``ExportedTransformerLM.from_params(...,
auto=True)`` times both at the decode shape and applies the faster
(``models/generate.py::autotune_serving_flags``, JSON-cacheable).

Run:  python examples/05_fused_serving.py [--platform gpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default="cpu")
args = parser.parse_args()

import jax  # noqa: E402

if args.platform == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ternary_spgemm_tpu.formats import TiledBitplane  # noqa: E402
from ternary_spgemm_tpu.models import (  # noqa: E402
    BitTransformerBlock,
    BitTransformerConfig,
    ExportedTransformerBlock,
)

cfg = BitTransformerConfig(vocab=256, d_model=128, n_heads=4, d_ff=256,
                           n_layers=1)
params = BitTransformerBlock(cfg).init(jax.random.key(0))

# Export the same trained block two ways: separate and merged q/k/v. The
# merged container is serving-only (it bypasses the custom-VJP layers).
plain = ExportedTransformerBlock.from_params(
    cfg, params, TiledBitplane, a8=True)
fast = ExportedTransformerBlock.from_params(
    cfg, params, TiledBitplane, a8=True, fused_qkv=True)

x = jax.random.normal(jax.random.key(1), (1, 8, cfg.d_model), jnp.float32)

# blocks are pytrees: pass them THROUGH jit so weights stay literal-free
run = jax.jit(lambda blk, z: blk(z))
y_plain, y_fast = np.asarray(run(plain, x)), np.asarray(run(fast, x))

print(f"block forward: {y_fast.shape}")
print(f"merged-vs-separate max |delta| = {np.abs(y_fast - y_plain).max():.2e} "
      "(the merged path shares one per-row requantize; per-tensor scales "
      "become per-segment output scales)")
assert np.all(np.isfinite(y_fast))

# --- measured flag selection on a whole LM export ---------------------
from ternary_spgemm_tpu.models import BitTransformerLM  # noqa: E402
from ternary_spgemm_tpu.models.generate import (  # noqa: E402
    ExportedTransformerLM)

lm_model = BitTransformerLM(cfg)
lm_params = lm_model.init(jax.random.key(2))
lm = ExportedTransformerLM.from_params(
    lm_model, lm_params, TiledBitplane, a8=True, with_transpose=False,
    auto=True)   # <- merged QKV or not, by measurement
print(f"auto-measured: fused_qkv={lm.blocks[0].qkv is not None}")
toks = jax.random.randint(jax.random.key(3), (1, 4), 0, cfg.vocab)
assert np.all(np.isfinite(np.asarray(lm(toks))))
print("OK")
