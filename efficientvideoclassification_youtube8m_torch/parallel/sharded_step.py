"""Data-parallel train and eval steps (the counterpart of the JAX
package's parallel/sharded_step.py).

The JAX package has two routes to a data-parallel step: one `jit` with
shardings that GSPMD partitions, and shard_map over a per-device program
with one explicit gradient `psum` (`--use_shardmap_train`). Each rank of
the port runs its own per-device program, so both routes are the same
step here: the train steps of `train/step.py` built with the mesh's
process group (the JAX `axis_name`). The contract is the JAX package's
(`train/step.py:369-384`): the batch-mean terms (CE, L_REP) and the l2
term are scaled by 1/n on each rank and the batch-sum L_PRED is not; one
summed, bucketed all-reduce of the gradients; per-variable clipping on
the summed gradients; a replicated TF-Adam update; the reported scalars
averaged except L_PRED, which is summed. The hand-written train kernels
run inside it whenever the single-device step would run them.

The data-parallel eval and int8 eval steps are `train.step`'s
`build_eval_step` and `build_quantized_eval_step` themselves, each rank
on its slice with replicated parameters: their only collective is the
binaries' gather of the ranks' rows (`distributed.gather_eval_rows`).
The validate step also averages its loss scalars over the ranks here.
Without a process group (`mesh.group` None) every builder returns the
plain step.
"""

from __future__ import annotations

from efficientvideoclassification_youtube8m_torch.parallel.mesh import Mesh
from efficientvideoclassification_youtube8m_torch.train.optimizer import Optimizer
from efficientvideoclassification_youtube8m_torch.train.step import (
    build_distill_train_step,
    build_finetune_step,
    build_validate_step,
    reduce_distill_losses,
)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig

# the eight loss scalars of a distill or validate step
DISTILL_SCALARS = (
    "teacher_label_loss", "teacher_final_loss", "teacher_reg_loss",
    "student_loss_state", "pred_loss", "student_label_loss",
    "student_reg_loss", "total_student_loss",
)


def build_sharded_distill_step(cfg: TrainConfig, optimizer: Optimizer,
                               mesh: Mesh, top_k: int = 20,
                               kernel_train_mode=None):
    """The data-parallel distillation step: each rank steps on its slice
    of the global batch; the state stays replicated."""
    return build_distill_train_step(cfg, optimizer, top_k, kernel_train_mode,
                                    group=mesh.group)


def build_sharded_finetune_step(cfg: TrainConfig, optimizer: Optimizer,
                                mesh: Mesh, top_k: int = 20,
                                host_subsampled: bool = False,
                                aggregated: bool = False,
                                kernel_train_mode=None):
    """The data-parallel student-only step (DBoF's batch moments synced
    with `cfg.sync_batch_norm`)."""
    return build_finetune_step(cfg, optimizer, top_k,
                               host_subsampled=host_subsampled,
                               aggregated=aggregated,
                               kernel_train_mode=kernel_train_mode,
                               group=mesh.group)


def build_sharded_validate_step(cfg: TrainConfig, mesh: Mesh, top_k: int = 20):
    """The validate step on this rank's rows, its eight loss scalars those
    of the global batch (`train.step.reduce_distill_losses`)."""
    step = build_validate_step(cfg, top_k)
    if mesh.group is None:
        return step

    def sharded(teacher, student, features_u8, labels, num_frames):
        out = step(teacher, student, features_u8, labels, num_frames)
        losses = reduce_distill_losses({k: out[k] for k in DISTILL_SCALARS},
                                       mesh.group)
        return {**out, **losses}

    return sharded
