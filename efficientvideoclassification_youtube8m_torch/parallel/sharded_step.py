"""Data- and tensor-parallel train and eval steps (the counterpart of the
JAX package's parallel/sharded_step.py).

The JAX package has two routes to a parallel step: one `jit` with
shardings that GSPMD partitions (the only route that takes a "model"
axis), and shard_map over a per-device program with one explicit
gradient `psum` (`--use_shardmap_train`, data-parallel only). Each rank
of the port runs its own per-device program, so both routes are the same
step here: the train steps of `train/step.py` built with the mesh. The
contract is the JAX package's (`train/step.py:369-384`): the batch-mean
terms (CE, L_REP) and the l2 term are scaled by 1/n on each rank (n the
data size) and the batch-sum L_PRED is not; one summed, bucketed
all-reduce of the gradients over the data group; per-variable clipping
on the summed gradients; a TF-Adam update, replicated over the data
group; the reported scalars averaged over it except L_PRED, which is
summed. The hand-written train kernels run inside it whenever the
single-device step would run them.

On a mesh with model > 1 the state holds each rank's columns
(`mesh.shard_state`, the JAX `place_state`): the column-parallel heads
gather their predictions over the model group and every other sharded
leaf is gathered where the forward reads it, so each rank of a model
group computes the same loss on the same rows, as GSPMD's one program
does. The LSTM kernels (last dim 4096 < 4200) stay replicated and run in
the hand-written kernels on every rank.

The eval and int8 eval steps are `train.step`'s `build_eval_step` and
`build_quantized_eval_step` themselves, each rank on its data index's
rows: their collectives are the binaries' gather of one row set per
data index (`distributed.gather_eval_rows`) and, for DBoF's faithful
eval keys, the global batch's frame count. The validate step also
averages its loss scalars over the data group. Without a process group
(`mesh.group` None) every `build_*` function returns the plain step.
"""

from __future__ import annotations

from efficientvideoclassification_youtube8m_torch.parallel.mesh import Mesh
from efficientvideoclassification_youtube8m_torch.train.optimizer import Optimizer
from efficientvideoclassification_youtube8m_torch.train.step import (
    build_distill_train_step,
    build_eval_step,
    build_finetune_step,
    build_quantized_eval_step,
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


def _data_parallel_only(mesh: Mesh, what: str) -> None:
    if mesh.shape["model"] != 1:
        raise ValueError(f"{what} is data-parallel only")


def build_sharded_distill_step(cfg: TrainConfig, optimizer: Optimizer,
                               mesh: Mesh, top_k: int = 20,
                               kernel_train_mode=None):
    """The parallel distillation step: each rank steps on its data
    index's slice of the global batch, with the state `mesh.shard_state`
    laid out."""
    return build_distill_train_step(cfg, optimizer, top_k, kernel_train_mode,
                                    mesh=mesh)


def build_sharded_finetune_step(cfg: TrainConfig, optimizer: Optimizer,
                                mesh: Mesh, top_k: int = 20,
                                host_subsampled: bool = False,
                                aggregated: bool = False,
                                kernel_train_mode=None):
    """The parallel student-only step (DBoF's batch moments synced with
    `cfg.sync_batch_norm`, or always under tensor parallelism)."""
    return build_finetune_step(cfg, optimizer, top_k,
                               host_subsampled=host_subsampled,
                               aggregated=aggregated,
                               kernel_train_mode=kernel_train_mode,
                               mesh=mesh)


def build_shardmap_distill_step(cfg: TrainConfig, optimizer: Optimizer,
                                mesh: Mesh, top_k: int = 20,
                                kernel_train_mode=None):
    """`--use_shardmap_train`: the JAX package's explicit per-device
    route, which every data-parallel step of the port already is; a
    model axis raises ValueError, as in JAX."""
    _data_parallel_only(mesh, "shard_map train path")
    return build_sharded_distill_step(cfg, optimizer, mesh, top_k,
                                      kernel_train_mode)


def build_shardmap_finetune_step(cfg: TrainConfig, optimizer: Optimizer,
                                 mesh: Mesh, top_k: int = 20, **kwargs):
    """The student-only `build_shardmap_distill_step`."""
    _data_parallel_only(mesh, "shard_map train path")
    return build_sharded_finetune_step(cfg, optimizer, mesh, top_k, **kwargs)


def build_sharded_validate_step(cfg: TrainConfig, mesh: Mesh, top_k: int = 20):
    """The validate step on this rank's rows, its eight loss scalars those
    of the global batch (`train.step.reduce_distill_losses` over the data
    group)."""
    step = build_validate_step(cfg, top_k, mesh=mesh)
    if mesh.group is None or mesh.data == 1:
        return step

    def sharded(teacher, student, features_u8, labels, num_frames):
        out = step(teacher, student, features_u8, labels, num_frames)
        losses = reduce_distill_losses({k: out[k] for k in DISTILL_SCALARS},
                                       mesh.group)
        return {**out, **losses}

    return sharded


def build_sharded_eval_step(cfg: TrainConfig, mesh: Mesh, top_k: int = 20,
                            host_subsampled: bool = False,
                            aggregated: bool = False):
    """The eval step on this rank's rows (a sharded student gathers what
    it uses; its predictions are whole)."""
    return build_eval_step(cfg, top_k, host_subsampled=host_subsampled,
                           aggregated=aggregated, mesh=mesh)


def build_sharded_quantized_eval_step(cfg: TrainConfig, mesh: Mesh,
                                      top_k: int = 20,
                                      host_subsampled: bool = False):
    """The int8 eval step on this rank's rows, with replicated int8
    weights; a model axis raises ValueError, as in JAX (per-column scales
    would need the same split as the kernels)."""
    _data_parallel_only(mesh, "--quantize int8 eval")
    return build_quantized_eval_step(cfg, top_k, host_subsampled=host_subsampled)
