"""Parallel: data-, tensor- and sequence-parallel training, eval and
serving over `torch.distributed`, one process per device.

  * distributed: joining the process group (TF_CONFIG or the standard
    MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE variables), each data index's
    share of the shards and of the global batch, the stream sync (one
    reader per model group), the master's broadcasts and the eval-row
    gather;
  * mesh: the ("data", "model") layout of the ranks and the column rule
    of tensor parallelism (the steps' collectives are `ops.collectives`);
  * sharded_step: the data- and tensor-parallel train and eval steps;
  * sequence_parallel: the hierarchical state with the chunk axis split
    over the data axis.

The names of the JAX package's `parallel` that the port has are exported
here.
"""

from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
    gather_state,
    make_params_specs,
    shard_state,
    shard_state_specs,
)
from efficientvideoclassification_youtube8m_torch.parallel.sequence_parallel import (
    build_sequence_parallel_state_fn,
)
from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
    build_shardmap_distill_step,
    build_shardmap_finetune_step,
    build_sharded_distill_step,
    build_sharded_eval_step,
    build_sharded_finetune_step,
    build_sharded_quantized_eval_step,
    build_sharded_validate_step,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "create_mesh",
    "distributed",
    "gather_state",
    "make_params_specs",
    "shard_state",
    "shard_state_specs",
    "build_sequence_parallel_state_fn",
    "build_shardmap_distill_step",
    "build_shardmap_finetune_step",
    "build_sharded_distill_step",
    "build_sharded_eval_step",
    "build_sharded_finetune_step",
    "build_sharded_quantized_eval_step",
    "build_sharded_validate_step",
]
