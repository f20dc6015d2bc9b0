"""Differentiable exported ternary layers — custom VJP over SpMM kernels.

An exported container runs through the registry's kernels, some of which
(the fused Triton kernel) have no automatic derivative. But the backward pass of a ternary linear layer is *itself* a
ternary SpMM against the transposed weights:

    y = gamma * (x @ Wq) + b            dx = gamma * (dy' @ Wq^T)
    out = prelu(y, alpha)               dy' = where(y > 0, dy, alpha * dy)
                                        db = sum_m dy',  dalpha = sum_m dy * min(y, 0)...

so :class:`ExportedBitLinear` stores both the container and its transpose
(built once at export) and wires a ``jax.custom_vjp`` whose forward *and*
backward passes run on the registered kernels. This makes frozen-ternary-
backbone fine-tuning (gradients w.r.t. activations and downstream params)
run at inference-kernel speed in both directions — a capability with no
reference analogue (the reference has no training or autodiff at all).
"""

from __future__ import annotations

from typing import Optional, Type

import jax
import jax.numpy as jnp
import numpy as np

from ternary_spgemm_tpu.formats.base import TernaryFormat
from ternary_spgemm_tpu.models.bitlinear import ternary_quantize
from ternary_spgemm_tpu.ops import ternary_spgemm


class ExportedBitLinear:
    """Frozen ternary linear layer, differentiable w.r.t. (x, bias, alpha).

    Build from trained BitLinear params with :meth:`from_params`, or directly
    from a ternary matrix with :meth:`from_dense`. Calling the layer inside
    ``jax.grad`` works; both directions use registry kernels.
    """

    def __init__(self, fmt: TernaryFormat, fmt_t: TernaryFormat, gamma: float,
                 bias, alpha=None, *, kernel: Optional[str] = None,
                 a8: bool = False):
        # Containers live as DEVICE pytrees and flow through the custom-VJP
        # fn as ARGUMENTS, never as closure captures: captured leaves inline
        # as HLO literal constants under a user's jit — their bytes ship
        # with every compile and key the compile cache on the weight
        # values (docs/perf.md). The layer is itself a registered pytree:
        # pass it THROUGH jit (``jax.jit(lambda l, x: l(x))(layer, x)``) and
        # the compile is literal-free; closing over it inlines the weights.
        self.fmt = jax.tree_util.tree_map(jnp.asarray, fmt)
        self.fmt_t = jax.tree_util.tree_map(jnp.asarray, fmt_t)
        self.gamma = float(gamma)
        self.bias = jnp.asarray(bias, jnp.float32)
        self.alpha = None if alpha is None else jnp.asarray(alpha, jnp.float32)
        self.kernel = kernel
        #: W1.58-A8 serving regime: per-row absmax int8 activation
        #: requantization before the kernel, row scale applied outside
        #: (:func:`bitlinear.apply_exported_a8` math, layer-integrated).
        #: The EXPLICIT round makes the numerics kernel-independent, and
        #: the custom-VJP backward doubles as the straight-through
        #: estimator of the rounding. The right mode for integer-only-
        #: exact containers (TiledBitplane & friends) on non-integer
        #: activations — without it their kernels round UNSCALED X.
        self.a8 = bool(a8)
        self._f = None  # custom-VJP fn, built lazily (pytree unflatten path)

    @classmethod
    def from_params(cls, params: dict, format_cls: Type[TernaryFormat], *,
                    kernel: Optional[str] = None, with_transpose: bool = True,
                    a8: bool = False, **fmt_kwargs):
        """``with_transpose=False`` skips building the transposed container
        (halves export time + memory) — the layer becomes FORWARD-ONLY
        (``jax.grad`` through it raises); the right choice for pure
        serving."""
        Wq, gamma = ternary_quantize(params["w"])
        Wq = np.asarray(Wq, np.int8)
        fmt_t = (format_cls.from_dense(np.ascontiguousarray(Wq.T),
                                       **fmt_kwargs)
                 if with_transpose else None)
        return cls(format_cls.from_dense(Wq, **fmt_kwargs), fmt_t,
                   float(gamma), params["b"], params.get("alpha"),
                   kernel=kernel, a8=a8)

    @classmethod
    def from_dense(cls, W: np.ndarray, format_cls: Type[TernaryFormat], *,
                   gamma: float = 1.0, bias=None, alpha=None,
                   kernel: Optional[str] = None, with_transpose: bool = True,
                   a8: bool = False, **fmt_kwargs):
        W = np.asarray(W, np.int8)
        if bias is None:
            bias = np.zeros(W.shape[1], np.float32)
        fmt_t = (format_cls.from_dense(np.ascontiguousarray(W.T), **fmt_kwargs)
                 if with_transpose else None)
        return cls(format_cls.from_dense(W, **fmt_kwargs), fmt_t,
                   gamma, bias, alpha, kernel=kernel, a8=a8)

    def resolve_kernel(self, M: int, *, absmax: int = 127,
                       integer: bool = True, cache_path: Optional[str] = None,
                       verbose: bool = False) -> str:
        """Replace ``kernel='auto'``/``None`` with the MEASURED winner for an
        ``(M, K)`` activation batch in the given domain (``ops/autotune.py``;
        memoized per shape+domain, optionally JSON-persisted so serving
        processes skip the probe). The reference's dispatch policy is its
        hard-coded registration order (``main.cpp:76-190``); here the winner
        genuinely shifts with shape, so deployment measures once instead."""
        from ternary_spgemm_tpu.formats.generate import generate_x
        from ternary_spgemm_tpu.ops.autotune import autotune

        X = generate_x(M, self.fmt.shape[0], seed=0, value_range=absmax)
        if not integer:
            X = X + 0.5   # forces the fully-exact-kernel domain
        self.kernel = autotune(jnp.asarray(X), self.fmt, self.bias, self.alpha,
                               cache_path=cache_path, verbose=verbose)
        self._f = None
        return self.kernel

    def __call__(self, x):
        kernel = self.kernel
        if kernel == "auto":
            if isinstance(x, jax.core.Tracer):
                # A timing probe cannot run DURING a trace (every op would
                # just emit more tracers). Fall back to the safe default
                # dispatch for this compile; the layer stays 'auto' so a
                # later concrete call (or resolve_kernel before jit) still
                # gets the measured winner.
                import warnings
                warnings.warn(
                    "ExportedBitLinear(kernel='auto') first called under "
                    "jit: cannot measure during a trace — using default "
                    "exact dispatch for this compile. Call resolve_kernel()/"
                    "autotune_exported() before jit to bake the measured "
                    "winner in.", stacklevel=2)
                kernel = None
            else:
                from ternary_spgemm_tpu.ops.autotune import autotune
                self.kernel = kernel = autotune(x, self.fmt, self.bias,
                                                self.alpha)
        if kernel is None and self.a8:
            # requantized X is integer |x|<=127 by construction: pick the
            # int8-native kernel for this platform and row count
            kernel = _default_a8_kernel(self.fmt, x.shape[0])
        if self._f is None or self._f[0] != kernel:
            self._f = (kernel,
                       _make_vjp_fn(self.fmt.shape[0], self.gamma, kernel,
                                    has_alpha=self.alpha is not None,
                                    a8_n=self.fmt.shape[1] if self.a8
                                    else None))
        f = self._f[1]
        if self.alpha is None:
            return f(x, self.bias, self.fmt, self.fmt_t)
        return f(x, self.bias, self.alpha, self.fmt, self.fmt_t)


def _flatten_bitlinear(l: "ExportedBitLinear"):
    return (l.bias, l.alpha, l.fmt, l.fmt_t), (l.gamma, l.kernel, l.a8)


def _unflatten_bitlinear(aux, children) -> "ExportedBitLinear":
    # Bypass __init__: unflatten must tolerate tracer/sentinel children
    # (jax calls it during tracing and structure-only transforms).
    obj = object.__new__(ExportedBitLinear)
    obj.bias, obj.alpha, obj.fmt, obj.fmt_t = children
    obj.gamma, obj.kernel, obj.a8 = aux
    obj._f = None
    return obj


jax.tree_util.register_pytree_node(
    ExportedBitLinear, _flatten_bitlinear, _unflatten_bitlinear)


class ExportedMLP:
    """A trained TernaryMLP frozen into containers, layer by layer.

    Differentiable w.r.t. the input (chain of custom-VJP layers), so a
    frozen ternary backbone composes with trainable heads/adapters.
    """

    def __init__(self, layers):
        self.layers = list(layers)

    @classmethod
    def from_params(cls, model, params: list, format_cls: Type[TernaryFormat],
                    *, kernel: Optional[str] = None, **fmt_kwargs):
        return cls(ExportedBitLinear.from_params(p, format_cls, kernel=kernel,
                                                 **fmt_kwargs)
                   for p in params)

    def __call__(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


jax.tree_util.register_pytree_node(
    ExportedMLP,
    lambda m: (tuple(m.layers), None),
    lambda _, layers: ExportedMLP(layers))


def autotune_exported(model, M: int, *, absmax: int = 127,
                      integer: bool = True,
                      cache_path: Optional[str] = None,
                      verbose: bool = False) -> dict:
    """Resolve every :class:`ExportedBitLinear` in ``model`` (any registered
    pytree: ExportedMLP, ExportedTransformerLM, ...) to its MEASURED fastest
    kernel for batch ``M`` in the given activation domain. Layers sharing a
    (shape, domain) reuse one probe (the autotune memo); ``cache_path``
    persists winners across serving processes. Returns {(K, N): kernel}."""
    picks = {}
    layers = [l for l in jax.tree_util.tree_leaves(
        model, is_leaf=lambda o: isinstance(o, ExportedBitLinear))
        if isinstance(l, ExportedBitLinear)]
    for layer in layers:
        name = layer.resolve_kernel(M, absmax=absmax, integer=integer,
                                    cache_path=cache_path, verbose=verbose)
        picks[layer.fmt.shape] = name
    return picks


def _zero_cotangent(tree):
    """Symbolic-zero cotangents for a non-differentiable container pytree
    (integer/index leaves take float0 zeros, float leaves ordinary zeros)."""
    def z(a):
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating):
            return jnp.zeros(jnp.shape(a), jnp.asarray(a).dtype)
        return np.zeros(jnp.shape(a), jax.dtypes.float0)
    return jax.tree_util.tree_map(z, tree)


def requantize_rows(h, absmax: float = 127.0, eps: float = 1e-12):
    """Per-row symmetric int8 requantization -> (hq f32-int-valued, scale).

    ``hq = round(h / scale)`` with ``scale = (rowmax + eps) / absmax``, so
    that ``hq * scale ~= h``. The one formula every W1.58-A8 path uses
    (linear layers, merged QKV, the SwiGLU hidden activations, the plain
    reference), so they agree at .5 rounding boundaries too."""
    rowmax = jnp.max(jnp.abs(h), axis=-1, keepdims=True) + eps
    scale = rowmax / absmax
    return jnp.round(h / scale), scale


def _requantize_a8(x):
    """:func:`requantize_rows` with the clip that guards the all-zero-row
    corner (where eps dominates); ``|round(127*x/(rowmax+eps))| <= 127``
    holds otherwise."""
    xq, s = requantize_rows(x)
    return jnp.clip(xq, -127.0, 127.0), s


def _default_a8_kernel(fmt, M: int) -> Optional[str]:
    """Kernel for A8-requantized (integer, |x|<=127) activations over
    ``fmt`` with ``M`` rows: for bitplanes the platform's choice
    (:func:`ternary_spgemm_tpu.platform.bitplane_a8_kernel`), else the
    int8-native (_x8) domain first, then any other restricted-integer
    kernel. None -> the format has only fully-exact f32 kernels and
    default dispatch is already right."""
    from ternary_spgemm_tpu import platform
    from ternary_spgemm_tpu.formats import TiledBitplane
    from ternary_spgemm_tpu.ops.api import all_kernels

    if isinstance(fmt, TiledBitplane):
        return platform.bitplane_a8_kernel(fmt, M)
    cands = [s for s in all_kernels().values()
             if isinstance(fmt, s.format_cls) and not s.approximate
             and s.x_absmax is not None and not s.gpu_only]
    if not cands:
        return None
    return min(cands, key=lambda s: s.x_absmax != 127).name


def _make_vjp_fn(K: int, gamma: float, kernel, *, has_alpha: bool,
                 a8_n: Optional[int] = None):
    zero_b_t = jnp.zeros((K,), jnp.float32)

    if a8_n is not None:
        zero_b = jnp.zeros((a8_n,), jnp.float32)

        def linear(x, b, fmt):
            # A8: integer kernel dot, per-row scale and bias OUTSIDE (the
            # scale is per-row so it cannot fold into a per-column bias).
            # PReLU also stays outside (`f` below applies it after bias).
            xq, s = _requantize_a8(x)
            y = ternary_spgemm(xq, fmt, zero_b, None, kernel=kernel)
            return y * (s * gamma) + b
    else:
        def linear(x, b, fmt):
            # gamma * (x @ Wq) + b  ==  gamma * (x @ Wq + b/gamma)
            return ternary_spgemm(x, fmt, b / gamma, None, kernel=kernel) * gamma

    # A restricted-domain kernel (x_absmax: _i8 rounds, _x8 rounds+clamps)
    # would SILENTLY round the float cotangents in the backward pass —
    # g entries are small floats, so rounding zeroes the gradient. When the
    # layer's kernel is restricted, the backward requantizes g per-row the
    # same way the a8 forward treats activations (error ~1/254 relative,
    # far inside STE noise); exact kernels keep the exact backward.
    restricted = False
    if kernel is not None:
        from ternary_spgemm_tpu.ops.api import get_kernel
        restricted = get_kernel(kernel).x_absmax is not None

    def linear_t(g, fmt_t):
        if fmt_t is None:
            raise ValueError(
                "this ExportedBitLinear was built with with_transpose=False "
                "(forward-only, serving export); rebuild with "
                "with_transpose=True to backpropagate through it")
        # gamma * (g @ Wq^T) through the transposed container
        if restricted:
            gq, sg = _requantize_a8(g)
            return ternary_spgemm(gq, fmt_t, zero_b_t, None,
                                  kernel=kernel) * (sg * gamma)
        return ternary_spgemm(g, fmt_t, zero_b_t, None, kernel=kernel) * gamma

    if not has_alpha:
        @jax.custom_vjp
        def f(x, b, fmt, fmt_t):
            return linear(x, b, fmt)

        def fwd(x, b, fmt, fmt_t):
            return linear(x, b, fmt), (fmt, fmt_t)

        def bwd(res, g):
            fmt, fmt_t = res
            return (linear_t(g, fmt_t), jnp.sum(g, axis=0),
                    _zero_cotangent(fmt), _zero_cotangent(fmt_t))

        f.defvjp(fwd, bwd)
        return f

    @jax.custom_vjp
    def f(x, b, alpha, fmt, fmt_t):
        y = linear(x, b, fmt)
        return jnp.where(y > 0, y, alpha[None, :] * y)

    def fwd(x, b, alpha, fmt, fmt_t):
        y = linear(x, b, fmt)
        return jnp.where(y > 0, y, alpha[None, :] * y), (y, alpha, fmt, fmt_t)

    def bwd(res, g):
        y, alpha, fmt, fmt_t = res
        g_lin = jnp.where(y > 0, g, alpha[None, :] * g)
        dalpha = jnp.sum(jnp.where(y > 0, 0.0, y * g), axis=0)
        return (linear_t(g_lin, fmt_t), jnp.sum(g_lin, axis=0), dalpha,
                _zero_cotangent(fmt), _zero_cotangent(fmt_t))

    f.defvjp(fwd, bwd)
    return f
