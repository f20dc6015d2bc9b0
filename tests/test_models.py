"""Model-layer tests: quantization, QAT training, export-to-kernel parity."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ternary_spgemm_tpu import reference
from ternary_spgemm_tpu.formats import DenseTernary, PackedTernary53
from ternary_spgemm_tpu.models import (
    BitLinear,
    TernaryMLP,
    apply_exported,
    export_layer,
    make_sharded_train_step,
    make_train_step,
    mse_loss,
    ternary_quantize,
)
from ternary_spgemm_tpu.parallel import make_mesh


def test_quantize_values_and_scale():
    key = jax.random.key(0)
    W = jax.random.normal(key, (64, 32))
    Wq, gamma = ternary_quantize(W)
    assert set(np.unique(np.asarray(Wq))) <= {-1.0, 0.0, 1.0}
    np.testing.assert_allclose(float(gamma), float(jnp.mean(jnp.abs(W))), rtol=1e-4)


def test_ste_gradient_is_identity_shaped():
    layer = BitLinear(16, 8)
    params = layer.init(jax.random.key(1))
    x = jnp.ones((4, 16))

    g = jax.grad(lambda p: jnp.sum(layer.apply(p, x)))(params)
    # STE: latent weights receive a dense, finite gradient
    assert g["w"].shape == (16, 8)
    assert bool(jnp.all(jnp.isfinite(g["w"])))
    assert float(jnp.abs(g["w"]).sum()) > 0


def test_training_reduces_loss():
    model = TernaryMLP([8, 32, 4])
    params = model.init(jax.random.key(2))
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    step = jax.jit(make_train_step(model, opt))
    k1, k2 = jax.random.split(jax.random.key(3))
    x = jax.random.normal(k1, (64, 8))
    y = jax.random.normal(k2, (64, 4))
    first = float(mse_loss(model, params, x, y))
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, x, y)
    assert float(loss) < first * 0.9


@pytest.mark.parametrize("fmt_cls", [DenseTernary, PackedTernary53])
def test_export_matches_training_forward(fmt_cls):
    """Exported container + registry kernel == QAT forward, exactly."""
    layer = BitLinear(64, 128, prelu=True)
    params = layer.init(jax.random.key(4))
    x = jax.random.normal(jax.random.key(5), (8, 64))
    want = np.asarray(layer.apply(params, x))
    fmt, gamma, b, alpha = export_layer(params, fmt_cls)
    got = np.asarray(apply_exported(x, fmt, gamma, b, alpha))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flax_module_matches_functional():
    """FlaxBitLinear == BitLinear for identical parameters, and exports."""
    from ternary_spgemm_tpu.models import FlaxBitLinear

    mod = FlaxBitLinear(features=32, prelu=True)
    x = jax.random.normal(jax.random.key(7), (4, 16))
    variables = mod.init(jax.random.key(8), x)
    p = variables["params"]
    func = BitLinear(16, 32, prelu=True)
    want = func.apply({"w": p["w"], "b": p["b"], "alpha": p["alpha"]}, x)
    got = mod.apply(variables, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)
    fmt, gamma, b, alpha = export_layer(
        {"w": p["w"], "b": p["b"], "alpha": p["alpha"]}, DenseTernary)
    y = apply_exported(x, fmt, gamma, b, alpha)
    np.testing.assert_allclose(np.asarray(y), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flax_mlp_trains():
    import optax
    from ternary_spgemm_tpu.models import FlaxTernaryMLP

    mod = FlaxTernaryMLP(features=[32, 4])
    x = jax.random.normal(jax.random.key(9), (64, 8))
    y = jax.random.normal(jax.random.key(10), (64, 4))
    variables = mod.init(jax.random.key(11), x)
    opt = optax.adam(1e-2)
    state = opt.init(variables["params"])

    @jax.jit
    def step(params, state):
        loss, g = jax.value_and_grad(
            lambda p: jnp.mean((mod.apply({"params": p}, x) - y) ** 2))(params)
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state, loss

    params = variables["params"]
    first = None
    for _ in range(20):
        params, state, loss = step(params, state)
        first = first if first is not None else float(loss)
    assert float(loss) < first


def test_exported_layer_custom_vjp():
    """ExportedBitLinear: forward matches dense math; gradients match the
    autodiff of the equivalent dense computation (both directions run on
    registry kernels)."""
    from ternary_spgemm_tpu.models import ExportedBitLinear

    layer = BitLinear(48, 96, prelu=True)
    params = layer.init(jax.random.key(12))
    exp = ExportedBitLinear.from_params(params, DenseTernary)
    x = jax.random.normal(jax.random.key(13), (8, 48))

    # forward parity with the QAT forward
    want = np.asarray(layer.apply(params, x))
    got = np.asarray(exp(x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # gradient parity vs dense autodiff
    from ternary_spgemm_tpu.models.bitlinear import ternary_quantize
    Wq, gamma = ternary_quantize(params["w"])
    Wg = jnp.asarray(Wq) * gamma

    def dense_loss(x, b, alpha):
        y = x @ Wg + b
        return jnp.sum(jnp.where(y > 0, y, alpha[None, :] * y) ** 2)

    def exp_loss(x, b, alpha):
        e = ExportedBitLinear(exp.fmt, exp.fmt_t, exp.gamma, b, alpha)
        return jnp.sum(e(x) ** 2)

    b, alpha = params["b"], params["alpha"]
    for argnum in (0, 1, 2):
        gw = jax.grad(dense_loss, argnums=argnum)(x, b, alpha)
        gg = jax.grad(exp_loss, argnums=argnum)(x, b, alpha)
        np.testing.assert_allclose(np.asarray(gg), np.asarray(gw),
                                   rtol=1e-4, atol=1e-3)


def test_exported_layer_no_alpha_grads():
    from ternary_spgemm_tpu.models import ExportedBitLinear

    W = np.asarray(jax.random.randint(jax.random.key(1), (32, 64), -1, 2),
                   np.int8)
    exp = ExportedBitLinear.from_dense(W, DenseTernary, gamma=0.5,
                                       bias=np.ones(64, np.float32))
    x = jax.random.normal(jax.random.key(2), (4, 32))
    g = jax.grad(lambda x: jnp.sum(exp(x)))(x)
    want = jnp.ones((4, 64)) @ (jnp.asarray(W, jnp.float32).T * 0.5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_exported_layer_is_pytree_and_literal_free():
    """The layer rides THROUGH jit as an argument (registered pytree):
    the lowered HLO must contain no large weight literals — closure-captured
    container leaves inline as constants, which ships the weight bytes with
    every compile and keys the compile cache on weight values
    (docs/perf.md)."""
    import re
    from ternary_spgemm_tpu.formats import TCSC
    from ternary_spgemm_tpu.models import ExportedBitLinear

    W = np.asarray(jax.random.randint(jax.random.key(5), (96, 160), -1, 2),
                   np.int8)
    exp = ExportedBitLinear.from_dense(W, TCSC, gamma=0.5,
                                       bias=np.ones(160, np.float32))
    x = jax.random.normal(jax.random.key(6), (8, 96))

    apply = jax.jit(lambda l, xx: l(xx))
    got = np.asarray(apply(exp, x))
    want = (np.asarray(x) @ np.asarray(W, np.float32)) * 0.5 + 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    # grads flow through the pytree-arg path too (containers get symbolic
    # zero cotangents; x-grad matches dense autodiff)
    g = jax.jit(jax.grad(lambda xx, l: jnp.sum(l(xx) ** 2)))(x, exp)
    g_ref = jax.grad(
        lambda xx: jnp.sum(((xx @ jnp.asarray(W, jnp.float32)) * 0.5 + 1.0) ** 2))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-3)

    hlo = apply.lower(exp, x).as_text()
    assert not re.findall(r"dense<[^>]{200,}", hlo), \
        "container leaves leaked into the compile as HLO literals"


def test_exported_mlp_matches_training_forward():
    from ternary_spgemm_tpu.models import ExportedMLP

    model = TernaryMLP([16, 32, 8])
    params = model.init(jax.random.key(20))
    x = jax.random.normal(jax.random.key(21), (4, 16))
    want = np.asarray(model.apply(params, x))
    exp = ExportedMLP.from_params(model, params, DenseTernary)
    got = np.asarray(exp(x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # differentiable end to end
    g = jax.grad(lambda x: jnp.sum(exp(x) ** 2))(x)
    assert np.isfinite(np.asarray(g)).all()


def test_sharded_train_step_runs():
    mesh = make_mesh({"data": 2, "model": 4})
    model = TernaryMLP([16, 32, 16])
    params = model.init(jax.random.key(6))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    step, place = make_sharded_train_step(model, opt, mesh)
    x = jnp.ones((8, 16))
    y = jnp.zeros((8, 16))
    params, opt_state, x, y = place(params, opt_state, x, y)
    params2, _, loss = step(params, opt_state, x, y)
    assert np.isfinite(float(loss))
    # params keep their shardings through the step
    spec0 = params2[0]["w"].sharding.spec
    assert spec0 == params[0]["w"].sharding.spec


def test_apply_exported_a8_error_bounded():
    """W1.58-A8 path: the only approximation is per-token activation
    rounding, so |y - y_exact| <= gamma * (s_row/2) * max_col_nnz."""
    from ternary_spgemm_tpu.formats import generate_ternary
    from ternary_spgemm_tpu.models import apply_exported, apply_exported_a8

    rng = np.random.default_rng(0)
    K, N, M = 128, 64, 8
    W = generate_ternary(K, N, 4, seed=1)
    fmt = DenseTernary.from_dense(W)
    gamma = 0.37
    bias = rng.normal(size=N).astype(np.float32)
    alpha = np.full(N, 0.1, np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32) * 3.0

    exact = apply_exported(x, fmt, gamma, bias, alpha)
    a8 = apply_exported_a8(x, fmt, gamma, bias, alpha)

    s_row = np.abs(x).max(axis=1, keepdims=True) / 127.0
    col_nnz = (np.asarray(W) != 0).sum(axis=0).max()
    bound = gamma * (s_row / 2) * col_nnz + 1e-4
    err = np.abs(np.asarray(a8) - np.asarray(exact))
    assert (err <= bound).all(), (err.max(), bound.max())
    # and it is genuinely quantized (not silently exact-pathed)
    assert err.max() > 0


def test_apply_exported_a8_rejects_wide_domain_kernel():
    from ternary_spgemm_tpu.models import apply_exported_a8

    W = np.zeros((16, 8), np.int8)
    fmt = DenseTernary.from_dense(W)
    with pytest.raises(ValueError, match="int8-native"):
        apply_exported_a8(np.ones((2, 16), np.float32), fmt, 1.0,
                          np.zeros(8, np.float32), kernel="DenseMXU")


def test_exported_layer_a8_mode():
    """ExportedBitLinear(a8=True): per-row int8 requantize + scale-outside
    — the layer-integrated W1.58-A8 regime. Must equal the hand-computed
    round(clip(127 x/absmax)) @ (gamma Wq) * s + b, PReLU after bias; the
    backward pass is the straight-through estimator gamma * g @ Wq^T."""
    from ternary_spgemm_tpu.formats import generate_ternary
    from ternary_spgemm_tpu.models import ExportedBitLinear

    rng = np.random.default_rng(2)
    K, N, M = 64, 32, 5
    W = np.asarray(generate_ternary(K, N, 4, seed=3), np.float32)
    gamma = 0.21
    params = {"w": jnp.asarray(W * gamma), "b": jnp.asarray(
        rng.normal(size=N).astype(np.float32)),
        "alpha": jnp.full((N,), 0.1, jnp.float32)}
    layer = ExportedBitLinear.from_params(params, DenseTernary, a8=True)
    assert layer.a8
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32) * 2.5)

    got = np.asarray(jax.jit(lambda l, z: l(z))(layer, x))   # pytree-thru-jit
    s = np.abs(np.asarray(x)).max(axis=1, keepdims=True) / 127.0 + 1e-12
    xq = np.clip(np.round(np.asarray(x) / s), -127, 127)
    y = (xq @ W) * s * layer.gamma + np.asarray(layer.bias)
    want = np.where(y > 0, y, np.asarray(layer.alpha) * y)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # STE gradient: d/dx sum(prelu(y)) == (where(y>0, 1, alpha) * gamma) @ Wq^T
    # — computed through the layer's restricted-domain kernel, so the
    # backward requantizes the cotangent rows per-row (same A8 treatment)
    g = jax.grad(lambda z: jnp.sum(layer(z)))(x)
    gy = np.where(y > 0, 1.0, np.asarray(layer.alpha)[None, :])
    sg = np.abs(gy).max(axis=1, keepdims=True) / 127.0 + 1e-12
    gyq = np.clip(np.round(gy / sg), -127, 127)
    np.testing.assert_allclose(np.asarray(g), (gyq @ W.T) * sg * layer.gamma,
                               rtol=1e-5, atol=1e-5)
    # and the requantized backward tracks the exact one closely
    np.testing.assert_allclose(np.asarray(g), (gy * layer.gamma) @ W.T,
                               rtol=0.05, atol=0.05 * layer.gamma)


def test_exported_lm_a8_consistency():
    """a8=True exported LM on TiledBitplane: full forward == prefill ==
    stepwise decode (per-row requantize keeps every row independent), and
    the merged-QKV a8 path matches three separate a8 projections."""
    from ternary_spgemm_tpu.formats import TiledBitplane
    from ternary_spgemm_tpu.models import (
        BitTransformerConfig, BitTransformerLM)
    from ternary_spgemm_tpu.models.generate import (
        ExportedTransformerLM, init_cache)

    cfg = BitTransformerConfig(vocab=48, d_model=128, n_heads=2, d_ff=256,
                               n_layers=2)
    model = BitTransformerLM(cfg)
    params = model.init(jax.random.key(5))
    toks = jax.random.randint(jax.random.key(6), (2, 6), 0, cfg.vocab)
    lm = ExportedTransformerLM.from_params(model, params, TiledBitplane,
                                           a8=True)
    lm_q = ExportedTransformerLM.from_params(model, params, TiledBitplane,
                                             a8=True, fused_qkv=True)
    want = jax.jit(lambda m, t: m(t))(lm, toks)
    got_q = jax.jit(lambda m, t: m(t))(lm_q, toks)
    np.testing.assert_allclose(np.asarray(got_q), np.asarray(want),
                               rtol=2e-4, atol=2e-4)

    B, T0 = toks.shape
    caches = init_cache(cfg, B, T0)
    for t in range(T0):
        logits, caches = lm.decode_step(toks[:, t], caches, jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(logits),
                                   np.asarray(want[:, t]),
                                   rtol=2e-4, atol=2e-4)
    pre, _ = lm.prefill(toks, init_cache(cfg, B, T0))
    np.testing.assert_allclose(np.asarray(pre), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
