#!/usr/bin/env python
"""Train a ternary MLP (BitNet-style QAT), export, and serve via a kernel.

Pipeline (all net-new relative to the reference, which has no model layer):

  1. QAT-train a ``TernaryMLP`` — latent f32 weights, ternary forward with a
     straight-through estimator (BitNet b1.58 absmean quantization).
  2. Export each layer's quantized weights into a registered sparse
     container.
  3. Serve: the forward pass runs through the kernel registry exactly like
     the benchmark kernels — same code path the sweeps measure. Two modes:
     f32 activations over ``DenseTernary`` (bit-exact vs the QAT forward),
     and the BitNet W1.58-A8 production path — per-token int8 activation
     quantization over ``TiledBitplane`` (2 bits/weight of HBM traffic).

Run:  python examples/02_train_export_serve.py [--platform gpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default="cpu")
parser.add_argument("--steps", type=int, default=200)
args = parser.parse_args()

import jax  # noqa: E402

if args.platform == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from ternary_spgemm_tpu.formats import DenseTernary, TiledBitplane  # noqa: E402
from ternary_spgemm_tpu.models import (  # noqa: E402
    TernaryMLP, apply_exported, apply_exported_a8, export_layer,
    make_train_step, mse_loss)

# 1. QAT training on a toy regression task -------------------------------
model = TernaryMLP([64, 256, 8])
params = model.init(jax.random.key(0))
opt = optax.adam(3e-3)
opt_state = opt.init(params)
step = jax.jit(make_train_step(model, opt))

kx, kw = jax.random.split(jax.random.key(1))
x = jax.random.normal(kx, (512, 64))
w_true = jax.random.normal(kw, (64, 8)) / 8.0
y = jnp.tanh(x @ w_true)

print(f"initial loss: {float(mse_loss(model, params, x, y)):.4f}")
for i in range(args.steps):
    params, opt_state, loss = step(params, opt_state, x, y)
print(f"final loss:   {float(loss):.4f} after {args.steps} steps")

# 2. Export each layer into ternary containers ----------------------------
exact = [export_layer(p, DenseTernary) for p in params]
bitp = [export_layer(p, TiledBitplane) for p in params]
print(f"exported {len(exact)} layers: DenseTernary "
      f"{sum(f.size_bytes() for f, _, _, _ in exact) / 1e3:.1f} kB, "
      f"TiledBitplane "
      f"{sum(f.size_bytes() for f, _, _, _ in bitp) / 1e3:.1f} kB "
      f"(2 bits/weight)")

# 3. Serve through the kernel registry ------------------------------------
def serve(x, layers, apply_fn):
    h = x
    for fmt, gamma, bias, alpha in layers:
        # alpha is the layer's PReLU slope — fused into the kernel epilogue
        h = apply_fn(h, fmt, gamma, bias, alpha)
    return h

y_qat = model.apply(params, x)        # QAT forward (latent weights, STE path)

# (a) f32 activations, fully exact kernels: bit-parity with training
y_f32 = serve(x, exact, apply_exported)
err = float(jnp.max(jnp.abs(y_qat - y_f32)))
print(f"f32 serving (DenseTernary):      max |err| vs QAT = {err:.2e}")
assert err < 1e-4

# (b) BitNet W1.58-A8: int8 activations over 2-bit weights — the production
# regime; the only approximation is the per-token activation rounding
y_a8 = serve(x, bitp, apply_exported_a8)
rel = float(jnp.max(jnp.abs(y_qat - y_a8)) / (jnp.max(jnp.abs(y_qat)) + 1e-9))
print(f"a8 serving  (TiledBitplane):     max rel err vs QAT = {rel:.2e}")
assert rel < 0.05
