"""Dense reference operators and the correctness comparator.

The analogue of the reference's correctness layer
(``cpp_impl/sparseUtils.h:93-156`` in alessiomelone/Ternary-spGEMM):

* :func:`dense_gemm`      — ``Y = X @ W + b``            (``GEMM``, ``sparseUtils.h:93-108``)
* :func:`dense_gemm_prelu``— ... with PReLU epilogue      (``GEMM_PreLU``, ``sparseUtils.h:111-137``)
* :func:`prelu`           — ``y > 0 ? y : alpha[n] * y``  (per-output-column alpha)
* :func:`compare_results` — elementwise absolute-tolerance comparator
  (``compare_results``, ``sparseUtils.h:140-156``; tolerance ``10e-6`` = 1e-5).

Everything here is plain jnp so it runs on the CPU or a GPU; the matmul is
forced to ``precision=HIGHEST`` so float32 accumulation over the
integer-valued test data (X integer in [-512, 512], W in {-1,0,+1}) is
*exact* — which is what makes the reference's absolute tolerance of 1e-5
meaningful (a GPU would otherwise run float32 products in TF32).

:func:`ternary_lm_logits` is the plain reference of the served ternary
transformer: a full forward over dense ternary matrices, with none of the
serving machinery (no containers, kernels or KV cache).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

#: Absolute tolerance of the reference comparator (``sparseUtils.h:147``,
#: written there as ``10e-6``).
TOLERANCE = 1e-5


def prelu(y: jax.Array, alpha: jax.Array) -> jax.Array:
    """PReLU with per-output-column slope: ``y if y > 0 else alpha[n] * y``.

    Matches the epilogue in ``GEMM_PreLU`` (``sparseUtils.h:128-133``) and the
    fused kernels in ``cpp_impl/comp_prelu.h``.
    """
    return jnp.where(y > 0, y, alpha * y)


def dense_gemm(X: jax.Array, W: jax.Array, b: jax.Array) -> jax.Array:
    """``Y[M,N] = X[M,K] @ W[K,N] + b[N]`` in float32, exact accumulation.

    The dense correctness reference (``GEMM``, ``sparseUtils.h:93-108``).
    """
    X = jnp.asarray(X, jnp.float32)
    W = jnp.asarray(W, jnp.float32)
    Y = jnp.dot(X, W, precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)
    return Y + jnp.asarray(b, jnp.float32)[None, :]


def dense_gemm_prelu(X: jax.Array, W: jax.Array, b: jax.Array,
                     alpha: jax.Array) -> jax.Array:
    """Dense reference with fused PReLU (``GEMM_PreLU``, ``sparseUtils.h:111-137``)."""
    return prelu(dense_gemm(X, W, b), jnp.asarray(alpha, jnp.float32)[None, :])


@dataclasses.dataclass(frozen=True)
class CompareResult:
    """Outcome of a correctness comparison (mirrors the reference's failure
    print of the first offending cell, ``main.cpp:216-247``)."""

    ok: bool
    max_abs_err: float
    num_bad: int
    first_bad: Optional[tuple] = None   # (m, n, got, want)

    def __bool__(self) -> bool:  # allow `assert compare_results(...)`
        return self.ok


def compare_results(got, want, tol: float = TOLERANCE) -> CompareResult:
    """Elementwise absolute-tolerance comparison (``sparseUtils.h:140-156``).

    Returns a :class:`CompareResult`; truthy iff every element satisfies
    ``|got - want| <= tol``.
    """
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return CompareResult(ok=False, max_abs_err=float("inf"),
                             num_bad=-1, first_bad=None)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = err > tol
    num_bad = int(bad.sum())
    first = None
    if num_bad:
        idx = tuple(int(i) for i in np.argwhere(bad)[0])
        first = (*idx, float(got[idx]), float(want[idx]))
    return CompareResult(ok=num_bad == 0, max_abs_err=float(err.max()) if err.size else 0.0,
                         num_bad=num_bad, first_bad=first)


def _rq_rows(h):
    """Per-row symmetric int8 quantization -> (integer-valued f32, scale)."""
    scale = (jnp.max(jnp.abs(h), axis=-1, keepdims=True) + 1e-12) / 127.0
    return jnp.clip(jnp.round(h / scale), -127.0, 127.0), scale


def int8_kv_codes(z):
    """The int8 KV cache's rounding of each (token, head) row (last axis):
    ``(codes, step)`` with integer-valued float ``codes`` in steps of
    ``max|row| / 127``."""
    step = jnp.max(jnp.abs(z), axis=-1, keepdims=True) / 127.0 + 1e-12
    return jnp.round(z / step), step


def _rms_norm(x, w, eps=1e-6):
    return x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True) + eps) * w


def _rotary(x):
    """RoPE with the half-split pairing over ``(B, H, T, hd)``."""
    T, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    freqs = 10000.0 ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = jnp.arange(T, dtype=jnp.float32)[:, None] * freqs[None, :]
    cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def ternary_lm_logits(tokens, embed, layers, norm_out, *, n_heads: int,
                      n_kv_heads: int = 0, window: int = 0,
                      quantize_activations: bool = True,
                      kv_int8: bool = False, precision: str = "highest"):
    """Logits ``(B, T, vocab)`` of the ternary transformer over ``tokens``.

    ``layers``: one dict per block with the dense ternary int8 matrices
    ``wq wk wv wo w_gate w_up w_down`` (each ``(in, out)``), their scalar
    scales ``g_<name>``, and the RMSNorm weights ``norm_attn``/``norm_ffn``.
    Each projection is ``(q(h) @ W) * s * g`` where ``q`` is the per-row
    int8 activation quantization (``h = q(h) * s``) of the W1.58-A8 regime.
    The blocks are LLaMA-style: RMSNorm, rotary causal attention (grouped
    when ``n_kv_heads``; sliding when ``window``), RMSNorm, SwiGLU, tied
    embedding head. Computed block by block (:func:`ternary_block`), with
    every product at ``precision`` (``jax.default_matmul_precision``).
    ``kv_int8=True`` rounds each rotated key row and each value row of each
    head to int8 steps of its own absmax, as an int8 KV cache stores them.

    ``quantize_activations=False`` and ``precision="default"`` (TF32
    products on a GPU) exist only as negative controls: a comparison that
    accepts them is too loose.
    """
    kw = dict(n_heads=n_heads, n_kv_heads=n_kv_heads or n_heads,
              window=window, quantize=quantize_activations, kv_int8=kv_int8)
    with jax.default_matmul_precision(precision):
        x = jnp.asarray(embed, jnp.float32)[jnp.asarray(tokens)]
        for L in layers:
            x = ternary_block(x, jax.tree_util.tree_map(jnp.asarray, L), **kw)
        return ternary_lm_head(x, embed, norm_out)


def _lin(h, W, g, quantize):
    if quantize:
        hq, s = _rq_rows(h)
        return jnp.dot(hq, W.astype(jnp.float32)) * (s * g)
    return jnp.dot(h, W.astype(jnp.float32)) * g


def ternary_qkv(x, L, *, n_heads: int, n_kv_heads: int,
                quantize: bool = True, kv_int8: bool = False):
    """The attention inputs of one block of :func:`ternary_lm_logits`:
    rotated ``q (B, n_heads, T, hd)``, rotated ``k`` and ``v (B, n_kv_heads,
    T, hd)``, with ``k``/``v`` rounded as an int8 KV cache stores them when
    ``kv_int8``."""
    B, T, d = x.shape
    hd = d // n_heads

    def heads(z, n):
        return z.reshape(B, T, n, hd).transpose(0, 2, 1, 3)

    h = _rms_norm(x, L["norm_attn"])
    q = _rotary(heads(_lin(h, L["wq"], L["g_wq"], quantize), n_heads))
    k = _rotary(heads(_lin(h, L["wk"], L["g_wk"], quantize), n_kv_heads))
    v = heads(_lin(h, L["wv"], L["g_wv"], quantize), n_kv_heads)
    if kv_int8:
        k, v = (jnp.multiply(*int8_kv_codes(z)) for z in (k, v))
    return q, k, v


@functools.partial(jax.jit, static_argnames=(
    "n_heads", "n_kv_heads", "window", "quantize", "kv_int8"))
def ternary_block(x, L, *, n_heads: int, n_kv_heads: int, window: int = 0,
                  quantize: bool = True, kv_int8: bool = False):
    """One block of :func:`ternary_lm_logits`: residual ``(B, T, d)`` in,
    residual out."""
    B, T, d = x.shape
    hd, G = d // n_heads, n_heads // n_kv_heads
    qi = jnp.arange(T)[:, None]
    ki = jnp.arange(T)[None, :]
    mask = ki <= qi
    if window:
        mask = mask & (qi - ki < window)
    q, k, v = ternary_qkv(x, L, n_heads=n_heads, n_kv_heads=n_kv_heads,
                          quantize=quantize, kv_int8=kv_int8)
    k = jnp.repeat(k, G, axis=1)
    v = jnp.repeat(v, G, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * hd ** -0.5
    p = jax.nn.softmax(jnp.where(mask, logits, -jnp.inf), axis=-1)
    a = jnp.einsum("bhqk,bhkd->bhqd", p, v).transpose(0, 2, 1, 3)
    x = x + _lin(a.reshape(B, T, d), L["wo"], L["g_wo"], quantize)
    h = _rms_norm(x, L["norm_ffn"])
    u = jax.nn.silu(_lin(h, L["w_gate"], L["g_w_gate"], quantize)) \
        * _lin(h, L["w_up"], L["g_w_up"], quantize)
    return x + _lin(u, L["w_down"], L["g_w_down"], quantize)


def ternary_lm_head(x, embed, norm_out):
    """Final RMSNorm and the tied embedding head: ``(B, T, d) -> (B, T,
    vocab)``."""
    x = _rms_norm(x, jnp.asarray(norm_out, jnp.float32))
    return jnp.einsum("btd,vd->btv", x, jnp.asarray(embed, jnp.float32))
