#!/usr/bin/env python
"""SPMD training of a ternary transformer LM over a device mesh.

Runs a data x model (dp x tp) mesh — on GPUs if you have them, or
on an 8-device *virtual CPU mesh* anywhere (the default here), which is how
the repo's multi-chip tests run (tests/conftest.py). The same code compiles
for a real slice: GSPMD inserts the collectives from the shardings.

Knobs demonstrated (all from models/train.py):
  * Megatron tensor parallelism (alternating column/row sharded BitLinears)
  * sequence parallelism  — activations T-sharded over the TP axis
  * ZeRO-1               — optimizer moments sharded over the dp axis
  * per-block remat      — recompute activations in backward

Run:  python examples/03_sharded_training.py [--devices 8]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--devices", type=int, default=8,
                    help="virtual CPU device count (ignored on a real slice)")
parser.add_argument("--steps", type=int, default=5)
args = parser.parse_args()

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={args.devices}"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")   # drop to run on GPUs

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ternary_spgemm_tpu.models import (  # noqa: E402
    BitTransformerConfig, BitTransformerLM, make_sharded_lm_train_step)
from ternary_spgemm_tpu.parallel import make_mesh  # noqa: E402

n = len(jax.devices())
mesh = make_mesh({"data": n // 4, "model": 4})
print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
      f"on {jax.devices()[0].platform}")

cfg = BitTransformerConfig(vocab=256, d_model=128, n_heads=4, d_ff=256,
                           n_layers=2, remat=True)
model = BitTransformerLM(cfg)
params = model.init(jax.random.key(0))
opt = optax.adamw(3e-4)
opt_state = opt.init(params)

step, place = make_sharded_lm_train_step(
    model, opt, mesh, sequence_parallel=True, zero1=True)

tokens = jax.random.randint(jax.random.key(1), (16, 64), 0, cfg.vocab)
params, opt_state, tokens = place(params, opt_state, tokens)

for i in range(args.steps):
    params, opt_state, loss = step(params, opt_state, tokens)
    print(f"step {i}: loss {float(loss):.4f}")

# show where a TP-sharded weight actually lives
wq = params["blocks"][0]["wq"]["w"]
print(f"wq sharding: {wq.sharding.spec}, "
      f"per-device shard {wq.addressable_shards[0].data.shape} "
      f"of global {wq.shape}")
