#!/usr/bin/env python
"""KV-cached autoregressive generation from an exported ternary LM.

Serving path: a QAT-trained ``BitTransformerLM`` is frozen into ternary
containers (``ExportedTransformerLM.from_params``) and decoded with a KV
cache — batched prompt prefill, then one token per step. Options shown:

  * ``prefill=True``   — one (B, T0) forward fills the caches (vs stepwise)
  * ``kv_dtype=int8``  — 4x smaller KV cache, per-row absmax quantized
  * exported containers — inference runs through the SpMM kernel registry

Run:  python examples/04_generate.py [--platform gpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default="cpu")
parser.add_argument("--new-tokens", type=int, default=12)
args = parser.parse_args()

import jax  # noqa: E402

if args.platform == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ternary_spgemm_tpu.formats import DenseTernary  # noqa: E402
from ternary_spgemm_tpu.models import (  # noqa: E402
    BitTransformerConfig, BitTransformerLM)
from ternary_spgemm_tpu.models.generate import (  # noqa: E402
    ExportedTransformerLM, generate)

cfg = BitTransformerConfig(vocab=256, d_model=128, n_heads=4, d_ff=256,
                           n_layers=2)
model = BitTransformerLM(cfg)
params = model.init(jax.random.key(0))   # untrained toy; swap in a checkpoint

prompt = jax.random.randint(jax.random.key(1), (2, 8), 0, cfg.vocab)

# Greedy decode from the QAT model (latent weights) ...
y_qat = generate(model, prompt, args.new_tokens, params=params, prefill=True)

# ... and from the exported frozen-container model — same tokens, but the
# forward runs through the ternary SpMM kernels (2-8 bits/weight in HBM).
exported = ExportedTransformerLM.from_params(model, params, DenseTernary)
y_exp = generate(exported, prompt, args.new_tokens, prefill=True)

# int8 KV cache: 4x smaller cache, negligible drift at these scales
y_kv8 = generate(exported, prompt, args.new_tokens, prefill=True,
                 cache_dtype=jnp.int8)

print("prompt:         ", np.asarray(prompt)[0].tolist())
print("QAT decode:     ", np.asarray(y_qat)[0, prompt.shape[1]:].tolist())
print("exported decode:", np.asarray(y_exp)[0, prompt.shape[1]:].tolist())
print("int8-KV decode: ", np.asarray(y_kv8)[0, prompt.shape[1]:].tolist())
assert np.array_equal(np.asarray(y_qat), np.asarray(y_exp))
