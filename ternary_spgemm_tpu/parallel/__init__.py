"""Multi-chip execution: mesh construction, container sharding, sharded SpMM.

Net-new vs the single-node reference (SURVEY.md §2.3): ``jax.sharding`` +
``shard_map`` SPMD with XLA collectives (NCCL between GPUs), with the
activation all-gather overlapped against kernel compute in the ring scheme.
"""

from ternary_spgemm_tpu.parallel.sharding import (
    SHARDABLE_FORMATS,
    column_leaf_specs,
    container_from_local_shard,
    localize,
    make_mesh,
    row_leaf_specs,
    shard_container,
    spec_tree,
)
from ternary_spgemm_tpu.parallel.pipeline import (
    pipeline_apply,
    pipeline_lm_apply,
    stack_stages,
)
from ternary_spgemm_tpu.parallel.spgemm import (
    column_sharded_spgemm,
    overlapped_gather_spgemm,
    row_sharded_spgemm,
)
from ternary_spgemm_tpu.parallel.ffn import tensor_parallel_fused_swiglu

__all__ = [
    "SHARDABLE_FORMATS", "make_mesh", "shard_container", "spec_tree",
    "column_leaf_specs", "row_leaf_specs", "localize",
    "container_from_local_shard",
    "column_sharded_spgemm", "row_sharded_spgemm", "overlapped_gather_spgemm",
    "tensor_parallel_fused_swiglu",
    "pipeline_apply", "pipeline_lm_apply", "stack_stages",
]
