"""Multi-rank execution on torch.distributed (counterpart of
seed_tpu/parallel/): the (data, fsdp, pipe, tensor) mesh, rule-based
partition specs and DTensor layouts, GPipe pipelining and ring attention.
"""
from .mesh import (
    AXIS_NAMES,
    DATA_AXIS,
    FSDP_AXIS,
    PIPE_AXIS,
    TENSOR_AXIS,
    auto_mesh,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from .partition import (
    LLAMA_TP_RULES,
    VIT_TP_RULES,
    make_param_specs,
    make_shardings,
    shard_params,
)
from .pipeline import (pipeline_forward, pipeline_llama_loss,
                       pipeline_fsdp_llama_loss)
from .sequence import (ring_attention, sequence_parallel_attention,
                       llama_loss_sp)

__all__ = [
    "AXIS_NAMES", "DATA_AXIS", "FSDP_AXIS", "PIPE_AXIS", "TENSOR_AXIS",
    "auto_mesh", "batch_sharding", "make_mesh", "replicated", "shard_batch",
    "LLAMA_TP_RULES", "VIT_TP_RULES",
    "make_param_specs", "make_shardings", "shard_params",
    "pipeline_forward", "pipeline_llama_loss", "pipeline_fsdp_llama_loss",
    "ring_attention", "sequence_parallel_attention", "llama_loss_sp",
]
