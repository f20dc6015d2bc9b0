"""ternary_spgemm_tpu — ternary sparse linear algebra on NVIDIA GPUs, in JAX.

Built with the capabilities of the CPU reference project
alessiomelone/Ternary-spGEMM (see SURVEY.md): ternary sparse containers,
multiplication-free dense x ternary SpMM kernels with a fused PReLU
epilogue, a calibrated benchmarking/instrumentation harness, and — new
relative to the reference — BitNet-style models, KV-cached serving, and
sharded execution over a JAX device mesh.
"""

__version__ = "0.1.0"

from ternary_spgemm_tpu import reference  # noqa: E402,F401


def __getattr__(name):
    # Lazy subpackage access (`ternary_spgemm_tpu.ops` etc.) without forcing
    # jax-heavy imports at package import time.
    import importlib
    if name in ("formats", "ops", "parallel", "models", "bench", "native",
                "profiling", "checkpoint", "utils"):
        return importlib.import_module(f"ternary_spgemm_tpu.{name}")
    raise AttributeError(f"module 'ternary_spgemm_tpu' has no attribute {name!r}")
