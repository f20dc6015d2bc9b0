"""The fused Triton bitplane kernel in Pallas' interpreter, and the custom
VJP through the bitplane kernels.

The kernel compiles only for a GPU (its chip check is ``chip_smoke.py``);
here it runs interpreted at row counts around its row block (16..64) and
at (K, N) that miss its K-block (256 rows) and column block (128), the
BitNet-3B width 3200 among them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ternary_spgemm_tpu import reference
from ternary_spgemm_tpu.formats import (
    TiledBitplane,
    generate_alpha,
    generate_bias,
    generate_ternary,
    generate_x,
)
from ternary_spgemm_tpu.ops.triton_bitplane import (
    triton_tiled_bitplane_x8_kernel,
)

KN = [pytest.param((3200, 136), id="K3200"),
      pytest.param((200, 3200), id="N3200"),
      pytest.param((257, 131), id="prime"),
      pytest.param((600, 390), id="multi-block")]


@pytest.mark.parametrize("epilogue", ["bias", "prelu"])
@pytest.mark.parametrize("kn", KN)
@pytest.mark.parametrize("M", [1, 7, 16, 33, 130])
def test_triton_bitplane_interpret(M, kn, epilogue):
    K, N = kn
    W = generate_ternary(K, N, 2, seed=K + N)
    X = generate_x(M, K, seed=M, value_range=127)
    b = generate_bias(N)
    alpha = generate_alpha(N) if epilogue == "prelu" else None
    fmt = TiledBitplane.from_dense(W)
    got = np.asarray(triton_tiled_bitplane_x8_kernel(X, fmt, b, alpha,
                                                     interpret=True))
    want = np.asarray(reference.dense_gemm_prelu(X, W, b, alpha)
                      if alpha is not None else reference.dense_gemm(X, W, b))
    res = reference.compare_results(got, want)
    assert res, res


@pytest.mark.parametrize("kernel", ["TiledBitplane", "TiledBitplane_x8"])
def test_custom_vjp_through_bitplane_kernels(kernel):
    """Gradients of an exported bitplane layer w.r.t. its input and bias
    run on the kernels (transposed container in the backward) and match
    the dense layer's. The _x8 kernel's backward requantizes the cotangent
    per row, so it matches to int8 rounding."""
    from ternary_spgemm_tpu.models import ExportedBitLinear

    K, N, M = 96, 160, 5
    W = generate_ternary(K, N, 2, seed=3)
    b = generate_bias(N)
    gamma = 0.5
    layer = ExportedBitLinear.from_dense(W, TiledBitplane, gamma=gamma,
                                         bias=b, kernel=kernel)
    X = jnp.asarray(generate_x(M, K, seed=4, value_range=127))
    G = jnp.asarray(generate_x(M, N, seed=5, value_range=127)) / 127.0

    want_gx = gamma * (G @ jnp.asarray(W, jnp.float32).T)
    gx = jax.grad(lambda x: jnp.sum(layer(x) * G))(X)
    gl = jax.grad(lambda l: jnp.sum(l(X) * G), allow_int=True)(layer)
    np.testing.assert_allclose(np.asarray(gl.bias), np.asarray(G.sum(0)),
                               atol=1e-5)
    tol = 1e-5 if kernel == "TiledBitplane" else 2e-2
    np.testing.assert_allclose(np.asarray(gx), np.asarray(want_gx),
                               rtol=tol, atol=tol * float(jnp.abs(want_gx).max()))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 16, 64])
def test_triton_bitplane_compiled_on_gpu(gpu, M):
    """On the card: the kernel compiled through Triton at the BitNet-3B
    gate/up shape, exact against the dense reference."""
    K, N = 3200, 8640
    W = generate_ternary(K, N, 2, seed=1)
    X = generate_x(M, K, seed=2, value_range=127)
    b = generate_bias(N)
    got = np.asarray(jax.jit(triton_tiled_bitplane_x8_kernel)(
        X, TiledBitplane.from_dense(W), b))
    res = reference.compare_results(got, np.asarray(
        reference.dense_gemm(X, W, b)))
    assert res, res
