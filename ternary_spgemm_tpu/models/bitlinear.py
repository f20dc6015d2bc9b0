"""BitNet-style ternary layers: QAT training + ternary-container inference.

The reference is a kernel library for "the BitNet-style ternary-LLM linear
layer" (SURVEY.md §0; flop model ``readme.md:84-85``) but ships no model
layer — weights come from a random generator (``sparseUtils.h:26-90``). A
production framework needs the other half: how ternary weights come to exist
and how a trained layer reaches the inference kernels. This module provides

* :func:`ternary_quantize` — BitNet-b1.58 absmean quantization: per-tensor
  scale ``gamma = mean|W|``, ``Wq = clip(round(W / gamma), -1, +1)``;
* :func:`ternary_quantize_ste` — the same with a straight-through estimator,
  so latent float weights train under ``jax.grad`` while the forward pass
  sees true ternary values;
* :class:`BitLinear` — ``y = (x @ Wq) * gamma + b`` with optional fused PReLU
  (the reference epilogue, ``comp_prelu.h``), functional init/apply over a
  plain params pytree (optax-compatible);
* :class:`TernaryMLP` — the flagship model: a stack of BitLinear layers with
  PReLU between them;
* :func:`export_layer` — freeze a trained BitLinear into any registered
  ternary container + scale, wiring training output into the SpMM kernel
  registry (``ops/``) for deployment.

All matmuls run on the matrix units in bf16-safe form; quantization math is
elementwise and fuses into surrounding ops under jit.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Type

import jax
import jax.numpy as jnp

from ternary_spgemm_tpu.formats.base import TernaryFormat
from ternary_spgemm_tpu.ops import ternary_spgemm


def ternary_quantize(W: jax.Array, eps: float = 1e-6):
    """BitNet-b1.58 absmean ternarization -> (Wq in {-1,0,+1} f32, gamma)."""
    gamma = jnp.mean(jnp.abs(W)) + eps
    Wq = jnp.clip(jnp.round(W / gamma), -1.0, 1.0)
    return Wq, gamma


def ternary_quantize_ste(W: jax.Array):
    """Quantize with a straight-through estimator: forward = ternary * gamma,
    gradient = identity to the latent weights."""
    Wq, gamma = ternary_quantize(W)
    Wq_scaled = Wq * gamma
    return W + jax.lax.stop_gradient(Wq_scaled - W)


class BitLinear:
    """Functional BitNet linear layer. Params: {"w": (K, N) latent f32,
    "b": (N,) f32, ["alpha": (N,) f32 if prelu]}."""

    def __init__(self, in_features: int, out_features: int, *, prelu: bool = False):
        self.in_features = in_features
        self.out_features = out_features
        self.prelu = prelu

    def init(self, key) -> dict:
        kw, _ = jax.random.split(key)
        std = (2.0 / self.in_features) ** 0.5
        params = {
            "w": jax.random.normal(kw, (self.in_features, self.out_features),
                                   jnp.float32) * std,
            "b": jnp.zeros((self.out_features,), jnp.float32),
        }
        if self.prelu:
            params["alpha"] = jnp.full((self.out_features,), 0.1, jnp.float32)
        return params

    def apply(self, params: dict, x: jax.Array) -> jax.Array:
        # quantize at MASTER precision (f32 round(W/gamma) — casting the
        # latents first flips ternary decisions at the 0.5 boundary), then
        # cast the quantized weights to the compute dtype; accumulate in
        # f32 and return at x's dtype
        wq = ternary_quantize_ste(params["w"]).astype(x.dtype)
        y = jnp.dot(x, wq, preferred_element_type=jnp.float32) + params["b"]
        if self.prelu:
            y = jnp.where(y > 0, y, params["alpha"] * y)
        return y.astype(x.dtype)


class TernaryMLP:
    """Flagship model: BitLinear stack with PReLU activations between layers
    (the reference's fused epilogue, ``comp_prelu.h:12-70``, as the model's
    nonlinearity)."""

    def __init__(self, features: Sequence[int]):
        if len(features) < 2:
            raise ValueError("need at least input and output feature sizes")
        self.features = tuple(features)
        self.layers = [
            BitLinear(features[i], features[i + 1], prelu=i < len(features) - 2)
            for i in range(len(features) - 1)
        ]

    def init(self, key) -> list:
        keys = jax.random.split(key, len(self.layers))
        return [l.init(k) for l, k in zip(self.layers, keys)]

    def apply(self, params: list, x: jax.Array) -> jax.Array:
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x


def export_layer(params: dict, format_cls: Type[TernaryFormat], **fmt_kwargs):
    """Freeze a trained BitLinear into (container, gamma, bias, alpha).

    Inference then runs ``ternary_spgemm(x, fmt, b/gamma, alpha) * gamma``
    — see :func:`apply_exported`. The scale folds into bias pre-division so
    the kernel's integer-exact accumulation is preserved.
    """
    import numpy as np

    Wq, gamma = ternary_quantize(params["w"])
    fmt = format_cls.from_dense(np.asarray(Wq, np.int8), **fmt_kwargs)
    return fmt, float(gamma), params["b"], params.get("alpha")


def apply_exported(x, fmt: TernaryFormat, gamma: float, bias, alpha=None, *,
                   kernel: Optional[str] = None):
    """Run an exported BitLinear through the SpMM kernel registry.

    ``y = (x @ Wq + b/gamma) * gamma`` equals ``x @ (gamma Wq) + b``; for the
    PReLU case the positive-homogeneity of PReLU (``prelu(c*y) = c*prelu(y)``
    for c > 0) makes the same folding exact.
    """
    b_scaled = jnp.asarray(bias, jnp.float32) / gamma
    y = ternary_spgemm(x, fmt, b_scaled, alpha, kernel=kernel)
    return y * gamma


def apply_exported_a8(x, fmt: TernaryFormat, gamma: float, bias, alpha=None, *,
                      kernel: Optional[str] = None):
    """BitNet W1.58-A8 serving path: per-token absmax int8 activation
    quantization over an exported container.

    ``xq = round(127 x / absmax(x))`` per row (the int8-native kernels round
    and clamp internally; the row scale rides outside), then
    ``y = (xq @ Wq) * (absmax/127) * gamma + b``. The ONLY approximation is
    the activation rounding — the deployment regime of BitNet b1.58
    (SURVEY.md §6; docs/perf.md). The epilogue
    (bias + optional PReLU) runs outside the kernel because the per-row
    scale cannot fold into a per-column bias; XLA fuses it anyway.

    ``kernel`` defaults to the backend-preferred registered kernel with the
    int8-native activation domain (``x_absmax == 127``) for ``type(fmt)``.
    """
    from ternary_spgemm_tpu.ops.api import get_kernel

    if kernel is not None:
        spec = get_kernel(kernel)
        if spec.x_absmax != 127:
            raise ValueError(
                f"apply_exported_a8 needs an int8-native (_x8) kernel; "
                f"{kernel!r} has x_absmax={spec.x_absmax}")
    else:
        from ternary_spgemm_tpu.models.exported import _default_a8_kernel

        name = _default_a8_kernel(fmt, jnp.shape(x)[0])
        spec = None if name is None else get_kernel(name)
        if spec is None or spec.x_absmax != 127:
            raise TypeError(
                f"no int8-native (_x8) kernel registered for "
                f"{type(fmt).__name__}; export into TiledBitplane or "
                f"DenseTernary")

    x = jnp.asarray(x, jnp.float32)
    s = jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0 + 1e-12
    zeros = jnp.zeros((fmt.N,), jnp.float32)
    y = spec(x / s, fmt, zeros) * (s * gamma) + jnp.asarray(bias, jnp.float32)
    if alpha is not None:
        y = jnp.where(y > 0, y, jnp.asarray(alpha, jnp.float32)[None, :] * y)
    return y
