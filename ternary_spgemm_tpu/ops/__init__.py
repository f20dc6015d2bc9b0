"""Compute kernels: plain-XLA formulations and one Pallas kernel for Hopper.

The analogue of the reference's kernel layer (``cpp_impl/comp.h`` /
``cpp_impl/comp_prelu.h``). Kernels are registered in
:mod:`ternary_spgemm_tpu.ops.api` (the ``add_function`` analogue,
``main.cpp:21-33``) and dispatched via :func:`ternary_spgemm`.
"""

from ternary_spgemm_tpu.ops.autotune import autotune
from ternary_spgemm_tpu.ops.api import (
    KernelSpec,
    all_kernels,
    get_kernel,
    kernels_for_format,
    register_kernel,
    ternary_spgemm,
)
from ternary_spgemm_tpu.ops import xla_kernels  # noqa: F401  (registers kernels)
from ternary_spgemm_tpu.ops import triton_bitplane  # noqa: F401  (registers)
from ternary_spgemm_tpu.ops import tiled_kernels  # noqa: F401  (registers)

__all__ = [
    "KernelSpec", "all_kernels", "get_kernel", "kernels_for_format",
    "register_kernel", "ternary_spgemm", "autotune",
]
