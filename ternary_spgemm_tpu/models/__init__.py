"""Model layer: BitNet-style ternary layers and the flagship TernaryMLP.

Net-new relative to the reference (which generates random ternary weights,
``cpp_impl/sparseUtils.h:26-90``, and has no model/training layer): QAT
training of ternary layers and export into the inference kernel registry.
"""

from ternary_spgemm_tpu.models.bitlinear import (
    BitLinear,
    TernaryMLP,
    apply_exported,
    apply_exported_a8,
    export_layer,
    ternary_quantize,
    ternary_quantize_ste,
)
from ternary_spgemm_tpu.models.exported import (
    ExportedBitLinear,
    ExportedMLP,
    autotune_exported,
)
from ternary_spgemm_tpu.models.train import (
    make_sharded_lm_train_step,
    make_sharded_train_step,
    make_train_step,
    mse_loss,
    param_shardings,
)
from ternary_spgemm_tpu.models.moe import (
    BitMoE,
    BitMoEConfig,
    ExportedMoE,
    moe_param_shardings,
    moe_route,
)
from ternary_spgemm_tpu.models.generate import (
    ExportedTransformerLM,
    generate,
    init_cache,
    lm_decode_step,
    lm_prefill,
)
from ternary_spgemm_tpu.models.transformer import (
    BitTransformerBlock,
    BitTransformerConfig,
    BitTransformerLM,
    ExportedTransformerBlock,
    lm_loss,
    lm_param_shardings,
    make_lm_train_step,
)

__all__ = [
    "BitLinear", "TernaryMLP", "apply_exported", "apply_exported_a8", "export_layer",
    "ternary_quantize", "ternary_quantize_ste",
    "make_train_step", "make_sharded_train_step", "make_sharded_lm_train_step",
    "mse_loss", "param_shardings",
    "FlaxBitLinear", "FlaxTernaryMLP", "ExportedBitLinear", "ExportedMLP",
    "autotune_exported",
    "BitTransformerBlock", "BitTransformerConfig", "BitTransformerLM",
    "ExportedTransformerBlock", "lm_loss", "lm_param_shardings",
    "make_lm_train_step",
    "ExportedTransformerLM", "generate", "init_cache", "lm_decode_step",
    "lm_prefill",
    "BitMoE", "BitMoEConfig", "ExportedMoE", "moe_param_shardings",
    "moe_route",
]


def __getattr__(name):
    # flax is optional: its wrappers import on first use, so the serving
    # and training paths need nothing beyond jax, numpy and optax
    if name in ("FlaxBitLinear", "FlaxTernaryMLP"):
        from ternary_spgemm_tpu.models import flax_module
        return getattr(flax_module, name)
    raise AttributeError(
        f"module 'ternary_spgemm_tpu.models' has no attribute {name!r}")
