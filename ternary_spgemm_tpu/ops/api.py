"""Kernel registry and dispatch — the ``add_function`` analogue.

The reference keeps two ``std::vector<std::function>`` registries populated by
``add_function(f, name)`` (``cpp_impl/main.cpp:21-33``, ``common.h:12-16``)
and benchmarks/correctness-gates every entry. Here each kernel is registered
once with its name, the container format it consumes, and metadata; the same
registry drives the correctness gate, the benchmark harness, and the sweep
CLI. Fused PReLU is not a separate registry (the reference's
``comp_func_prelu``) but a capability flag: every kernel takes an optional
``alpha`` and fuses the epilogue.

Kernel signature::

    kernel(X: f32[M, K], fmt: TernaryFormat-pytree, bias: f32[N],
           alpha: Optional[f32[N]]) -> f32[M, N]

Kernels are plain jittable functions; format instances are pytrees, so
``jax.jit(kernel)`` specializes on the static shape metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Type

import jax.numpy as jnp

from ternary_spgemm_tpu.formats.base import TernaryFormat

_KERNEL_REGISTRY: Dict[str, "KernelSpec"] = {}

#: The speedup denominator, like BENCHMARK_FUNCTION_NAME = "BaseTCSC"
#: (``main.cpp:10``).
BASELINE_KERNEL_NAME = "BaseTCSC"


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    fn: Callable                      # (X, fmt, bias, alpha=None) -> Y
    format_cls: Type[TernaryFormat]
    description: str = ""
    #: reference kernel(s) this is the analogue of (file:line)
    reference: str = ""
    #: True for kernels compiled only for a GPU (Pallas through Triton);
    #: they run elsewhere only in Pallas' interpreter, on request
    gpu_only: bool = False
    #: True if results are inexact vs the f32 reference (e.g. bf16 path)
    approximate: bool = False
    #: Largest |x| for which the kernel is exact on integer-valued
    #: activations. The reference's test domain is +-512 (perf.cpp:301);
    #: int8-native-activation (_x8) kernels are exact only for |x| <= 127
    #: (the BitNet a8 regime) and CLAMP outside it. None = any float.
    x_absmax: Optional[int] = None
    #: Activation bytes per X element the kernel's compute stage streams
    #: from HBM (the *own-bytes* roofline input): 4 for f32 kernels, 2 for
    #: bf16 operands and for the stacked int8-split (a8 + r8), 1 for
    #: int8-native (_x8). Round-2 modeled 4 B for everyone, flattering the
    #: sub-4-byte kernels' roofline fractions (VERDICT.md round-2 weak #4).
    x_bytes: float = 4.0

    def __call__(self, X, fmt, bias, alpha=None):
        return self.fn(X, fmt, bias, alpha)


def register_kernel(name: str, format_cls: Type[TernaryFormat], *,
                    description: str = "", reference: str = "",
                    gpu_only: bool = False, approximate: bool = False,
                    x_absmax: Optional[int] = None, x_bytes: float = 4.0):
    """Decorator: register a kernel under ``name`` (``add_function`` analogue)."""

    def deco(fn):
        if name in _KERNEL_REGISTRY:
            raise ValueError(f"kernel {name!r} already registered")
        _KERNEL_REGISTRY[name] = KernelSpec(
            name=name, fn=fn, format_cls=format_cls, description=description,
            reference=reference, gpu_only=gpu_only, approximate=approximate,
            x_absmax=x_absmax, x_bytes=x_bytes)
        return fn

    return deco


def all_kernels() -> Dict[str, KernelSpec]:
    return dict(_KERNEL_REGISTRY)


def get_kernel(name: str) -> KernelSpec:
    try:
        return _KERNEL_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; registered: {sorted(_KERNEL_REGISTRY)}") from None


def kernels_for_format(format_cls: Type[TernaryFormat]) -> Dict[str, KernelSpec]:
    return {n: s for n, s in _KERNEL_REGISTRY.items() if s.format_cls is format_cls}


def finish(Y, bias, alpha=None):
    """Shared epilogue: bias add + optional fused PReLU.

    The PReLU uses a per-output-column slope, matching
    ``cpp_impl/comp_prelu.h:12-70`` / ``sparseUtils.h:128-133``.
    """
    Y = Y + jnp.asarray(bias, Y.dtype)[None, :]
    if alpha is not None:
        Y = jnp.where(Y > 0, Y, jnp.asarray(alpha, Y.dtype)[None, :] * Y)
    return Y


def ternary_spgemm(X, fmt: TernaryFormat, bias, alpha=None, *,
                   kernel: Optional[str] = None):
    """Compute ``Y = X @ W + b`` (optionally PReLU'd) from a ternary container.

    If ``kernel`` is None, picks the first registered exact float32 kernel
    whose format class matches ``type(fmt)``. ``kernel="auto"`` measures the candidates
    once for this (shape, format, activation domain) and memoizes the
    winner (``ops/autotune.py``; X must be concrete on the first call).
    """
    if kernel == "auto":
        from ternary_spgemm_tpu.ops.autotune import autotune
        kernel = autotune(X, fmt, bias, alpha)
    if kernel is not None:
        spec = get_kernel(kernel)
        if not isinstance(fmt, spec.format_cls):
            raise TypeError(
                f"kernel {kernel!r} expects {spec.format_cls.__name__}, "
                f"got {type(fmt).__name__}")
        return spec.fn(X, fmt, bias, alpha)
    candidates = [s for s in _KERNEL_REGISTRY.values()
                  if isinstance(fmt, s.format_cls) and not s.approximate
                  and s.x_absmax is None and not s.gpu_only]
    # Default dispatch must be safe for ANY float input, so kernels with a
    # restricted activation domain (_x8: integer |x|<=127, clamping
    # otherwise) and the GPU-only fused kernels are opt-in via kernel=.
    if not candidates:
        raise TypeError(
            f"no exact float32 kernel for format {type(fmt).__name__}")
    return candidates[0].fn(X, fmt, bias, alpha)
