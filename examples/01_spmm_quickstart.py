#!/usr/bin/env python
"""Quickstart: build a ternary container, run a SpMM kernel, verify.

The 60-second tour of the core operation the framework computes
(reference ``cpp_impl/comp.h:37-68``):

    Y[M, N] = X[M, K] @ W[K, N] + b[N],   W in {-1, 0, +1}

Run:  python examples/01_spmm_quickstart.py [--platform gpu]
(defaults to CPU so it runs anywhere).
"""

import argparse
import os
import sys

# location-independent: the examples run against the in-repo package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default="cpu",
                    help="'cpu' (default, runs anywhere) or 'gpu'")
args = parser.parse_args()

import jax  # noqa: E402

if args.platform == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from ternary_spgemm_tpu import reference  # noqa: E402
from ternary_spgemm_tpu.formats import TCSC, TiledBitplane, generate  # noqa: E402
from ternary_spgemm_tpu.ops import ternary_spgemm  # noqa: E402

M, K, N, s = 32, 1024, 4096, 4          # the reference's north-star config

# 1. A random ternary weight matrix at density 1/s (reference generator
#    semantics, sparseUtils.h:26-90 — seeded by default here).
W = generate.generate_ternary(K, N, s, seed=0)
X = generate.generate_x(M, K, seed=1)   # integer-valued floats in [-512, 512]
b = generate.generate_bias(N)

# 2. Pick a container. TCSC is the reference's central format (TCSC.h:5-50);
#    TiledBitplane is the serving format (2 bits/weight, shift-and-mask
#    decode).
tcsc = TCSC.from_dense(W)
bitp = TiledBitplane.from_dense(W)
print(f"dense W:        {W.nbytes / 1e6:.2f} MB")
print(f"TCSC:           {tcsc.size_bytes() / 1e6:.2f} MB")
print(f"TiledBitplane:  {bitp.size_bytes() / 1e6:.2f} MB")

# 3. Multiply. Dispatch picks a safe exact kernel for the container;
#    kernel= selects explicitly, kernel="auto" measures and memoizes.
y_tcsc = ternary_spgemm(X, tcsc, b)
y_bitp = ternary_spgemm(X, bitp, b, kernel="TiledBitplane")

# 4. Verify against the dense reference (tolerance 1e-5, sparseUtils.h:147).
want = reference.dense_gemm(X, W.astype(np.float32), b)
for name, got in [("TCSC", y_tcsc), ("TiledBitplane", y_bitp)]:
    res = reference.compare_results(got, want)
    print(f"{name:14s} correct={res.ok} max_abs_err={res.max_abs_err:.2e}")
    assert res.ok
