"""Parallel: data-parallel and multi-host training and eval over
`torch.distributed`, one process per device.

  * distributed: joining the process group (TF_CONFIG or the standard
    MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE variables), each rank's share
    of the shards and of the global batch, the stream sync, the master's
    broadcasts and the eval-row gather;
  * mesh: the rank's group and device, and the collectives of the steps;
  * sharded_step: the data-parallel train and eval steps.

Tensor parallelism (the column-sharded MoE head), sequence-parallel
serving and orbax checkpoints are ROADMAP Queue 1 items."""
