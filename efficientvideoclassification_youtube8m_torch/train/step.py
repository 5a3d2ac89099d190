"""The train and eval steps (port of the JAX package's train/step.py):
input preprocessing, the model keyword rules, the teacher and student
forwards, the distill and finetune steps, and the validate, eval and
int8 eval steps with their packed host outputs.

Input contract: raw uint8 features on the model's device; dequantize +
l2-normalize run here.

Faithful quirks (cfg.faithful_quirks=True), as in the JAX package:
  * L_REP enters the student loss twice (train.py:406);
  * the shared global_step advances 2 per batch and drives both learning
    rate schedules (train.py:230,329,413);
  * L_PRED sums (not means) over the batch (train.py:402).

The steps update the state in place (the modules' parameters and the
optimizer slots) and return it with their metrics. Given a `mesh`
(parallel/mesh.py; its data group is the JAX `axis_name`), the train
steps are per-device programs of a data-parallel step
(parallel/sharded_step.py): each rank takes its data index's slice of the
global batch, and one summed all-reduce of the gradients over the data
group gives every rank the global-batch gradient. On a mesh with
model > 1 the towers hold their columns (`parallel.mesh.shard_state`):
the forwards gather what they use (`ops.collectives.apply_gathered`), the
clip sums the sharded gradients' squares over the model group, and the
random draws are those of the JAX package's GSPMD program (no rank
folded in; the global batch's draws, sliced to the rank's rows).
"""

from __future__ import annotations

import contextlib
import functools
from typing import TYPE_CHECKING, Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from efficientvideoclassification_youtube8m_torch import losses as losses_lib
from efficientvideoclassification_youtube8m_torch.metrics.eval_util import (
    topk_and_perr_on_device,
)
from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.ops.preprocess import (
    dequantize,
    l2_normalize,
    student_num_frames,
    uniform_subsample,
)
from efficientvideoclassification_youtube8m_torch.ops.collectives import (
    all_reduce_grads,
    apply_gathered,
    mean_tensors,
    reduce_scalars,
)
from efficientvideoclassification_youtube8m_torch.ops.quantize import (
    quantized_hierarchical_forward,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import (
    Optimizer,
    exponential_decay,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    StudentState,
    params_of,
)
from efficientvideoclassification_youtube8m_torch.utils import profiling
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig

if TYPE_CHECKING:  # the parallel layer imports this module
    from efficientvideoclassification_youtube8m_torch.parallel.mesh import Mesh

Tensors = Dict[str, torch.Tensor]


def resolve_label_loss(cfg: TrainConfig) -> Callable:
    """The label loss from the registry, with its file-backed or quirk
    arguments bound once, when the step is built: `PWELoss` under
    `cfg.faithful_quirks` takes the literal graph's batch-128 reshape;
    `CrossEntropyLossClassImbalance` reads the per-class counts of
    `cfg.class_counts_file` (the reference's `counts_tv`, one integer a
    line)."""
    fn = losses_lib.get_loss(cfg.label_loss)
    if cfg.label_loss == "PWELoss" and cfg.faithful_quirks:
        return functools.partial(fn, faithful_quirks=True)
    if cfg.label_loss == "CrossEntropyLossClassImbalance":
        with open(cfg.class_counts_file or "counts_tv") as f:
            counts = [int(line) for line in f if line.strip()]
        return functools.partial(fn, class_counts=counts)
    return fn


def _model_apply_kwargs(cfg: TrainConfig, device: torch.device,
                        inference: bool = False,
                        kernel_train_mode: Optional[str] = None,
                        kernel_override: Optional[bool] = None,
                        bn_group=None) -> Dict[str, Any]:
    """Model keywords of the forward.

    Inference: the forward-only kernel for bf16 on a CUDA device when
    `cfg.use_pallas_inference` is set; `kernel_override` (the JAX
    `pallas_override`) replaces that rule. Training: the train kernels for
    bf16 on a CUDA device when `cfg.lstm_pallas_train` is set (the JAX
    rule, with "tpu" read as "cuda"; the flags keep the names the shared
    config gives them). `kernel_train_mode` overrides the training rule:
    "on" forces the train kernels (their plain versions on CPU tensors),
    "off" the plain scan. Models without recurrences swallow these. Then
    DBoF's flag block (with `bn_group`, the process group of synced
    batch norm), Gated NetVLAD's training draw and the head's size, as in
    the JAX package."""
    is_cuda = torch.device(device).type == "cuda"
    bf16 = cfg.compute_dtype == "bfloat16"
    kw: Dict[str, Any] = {
        "classifier": cfg.video_level_classifier_model,
        "compute_dtype": torch.bfloat16 if bf16 else torch.float32,
        "is_training": not inference,
    }
    if inference:
        kw["use_kernel"] = (cfg.use_pallas_inference and bf16 and is_cuda
                            if kernel_override is None else kernel_override)
    elif kernel_train_mode is None:
        kw["use_kernel_train"] = cfg.lstm_pallas_train and bf16 and is_cuda
    elif kernel_train_mode in ("on", "off"):
        kw["use_kernel_train"] = kernel_train_mode == "on"
    else:
        raise ValueError(f"kernel_train_mode must be 'on', 'off' or None, "
                         f"got {kernel_train_mode!r}")
    if cfg.model == "DbofModel":
        # DBoF's flag block (frame_level_models.py:119-124)
        kw.update(iterations=cfg.iterations,
                  sample_random=cfg.sample_random_frames,
                  pooling_method=cfg.dbof_pooling_method,
                  add_batch_norm=cfg.dbof_add_batch_norm,
                  bn_group=bn_group)
    if cfg.model == "GatedNetVLADModel":
        kw["iterations"] = cfg.iterations  # the training draw's frames
    if cfg.video_level_classifier_model == "MoeModel":
        kw["num_mixtures"] = cfg.moe_num_mixtures
    else:
        kw["num_hidden_units"] = cfg.num_hidden_units
    return kw


def preprocess_batch(cfg: TrainConfig, features_u8: torch.Tensor,
                     num_frames: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """uint8 [B, T, D] -> l2-normalized f32.

    Padding frames come out EXACTLY 0.0, like the reference's
    dequantize-then-zero-pad order: dequantize maps byte 0 to -1.992, so
    rows past num_frames are re-zeroed here."""
    x = l2_normalize(dequantize(features_u8), dim=2)
    if num_frames is not None:
        T = x.shape[1]
        mask = (torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
                < num_frames.to(device=x.device, dtype=torch.int32)[:, None])
        x = x * mask[:, :, None]
    return x


def _check_model(cfg: TrainConfig, model) -> None:
    if model.name != cfg.model:
        raise ValueError(f"cfg.model is {cfg.model!r}, the module is a "
                         f"{model.name!r}")


def forward_teacher(cfg: TrainConfig, model, model_input: torch.Tensor,
                    num_frames: torch.Tensor, labels=None,
                    inference: bool = False, dropout_keep_prob=1.0,
                    rng: Optional[prng.Key] = None,
                    kernel_train_mode: Optional[str] = None, bn_group=None):
    """The teacher tower: all frames, `cfg.num_inputs_to_lstm` chunks.
    `labels` feed a head's own loss, `rng` its dropout (and DBoF's frame
    sampling); `bn_group` syncs DBoF's batch moments across ranks."""
    _check_model(cfg, model)
    return apply_gathered(
        model, model_input, num_frames, num_chunks=cfg.num_inputs_to_lstm,
        labels=labels, dropout_keep_prob=dropout_keep_prob, rng=rng,
        **_model_apply_kwargs(cfg, model_input.device, inference,
                              kernel_train_mode, bn_group=bn_group),
    )


def forward_student(cfg: TrainConfig, model, model_input_student: torch.Tensor,
                    num_frames_stud: torch.Tensor, labels=None,
                    inference: bool = False, dropout_keep_prob=1.0,
                    rng: Optional[prng.Key] = None,
                    kernel_train_mode: Optional[str] = None,
                    kernel_override: Optional[bool] = None, bn_group=None):
    """`create_model_inference`: the same architecture on the subsampled
    frames, with `cfg.num_inputs_L1` chunks."""
    _check_model(cfg, model)
    return apply_gathered(
        model, model_input_student, num_frames_stud, num_chunks=cfg.num_inputs_L1,
        labels=labels, dropout_keep_prob=dropout_keep_prob, rng=rng,
        **_model_apply_kwargs(cfg, model_input_student.device, inference,
                              kernel_train_mode, kernel_override, bn_group),
    )


def forward_video_level(cfg: TrainConfig, model, model_input: torch.Tensor,
                        labels=None, inference: bool = False,
                        dropout_keep_prob=1.0, rng: Optional[prng.Key] = None):
    """The `--frame_features=False` forward: the flag-selected video-level
    model applied straight to the [B, D] aggregated features
    (train_finetune.py:514-518, readers.py:53-112)."""
    if get_model(cfg.model).frame_level:
        raise ValueError(
            f"--frame_features=False feeds [batch, {model_input.shape[-1]}] "
            f"aggregated features, but --model={cfg.model} is a frame-level "
            "model; pick a video-level head (LogisticModel, MoeModel, ...) "
            "or use frame-feature shards")
    _check_model(cfg, model)
    kw: Dict[str, Any] = {
        "compute_dtype": (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                          else torch.float32),
        "is_training": not inference,
    }
    if "MoeModel" in (cfg.video_level_classifier_model, cfg.model):
        kw["num_mixtures"] = cfg.moe_num_mixtures
    else:
        kw["num_hidden_units"] = cfg.num_hidden_units
    return apply_gathered(model, model_input, labels=labels,
                          dropout_keep_prob=dropout_keep_prob, rng=rng, **kw)


def preprocess_aggregated(features: torch.Tensor) -> torch.Tensor:
    """[B, D] float32 aggregated features -> the l2-normalized model
    input: the reference normalizes along the last axis whatever the
    reader (train_finetune.py:242-244); the features are already float
    averages, so nothing is dequantized."""
    return l2_normalize(features.to(torch.float32), dim=1)


def model_label_loss(out, labels, label_loss_fn: Callable) -> torch.Tensor:
    """A model-supplied loss if the model gives one (a matrix-valued one,
    LinearRegressionWeightedMeanEnsembleDifferenceLoss's, trains on its
    sum, as slim's train op reduces it), else the flag loss."""
    loss = out.get("loss")
    if loss is None:
        return label_loss_fn(out["predictions"], labels)
    return torch.sum(loss) if loss.dim() > 0 else loss


def _shards(module):
    """The module's tensor-parallel layout (`parallel.mesh.shard_module`),
    None when it is whole."""
    return getattr(module, "model_shards", None)


def _merge_updated_stats(model, updated: Optional[Tensors]) -> None:
    """Write the statistics the forward computed (DBoF's batch-norm moving
    averages, "updated_stats") over their parameters, after the optimizer
    update: slim's UPDATE_OPS around the train op (train.py:312-318). The
    statistics got a zero gradient, so the update left them alone. A
    sharded statistic takes this rank's columns of the whole one."""
    if not updated:
        return
    shards = _shards(model)
    with torch.no_grad():
        for name, value in updated.items():
            if shards is not None and name in shards.names:
                value = shards.local(value)
            model.get_parameter(name).copy_(value)


def _distill_losses(cfg: TrainConfig, out_t, out_s, labels,
                    label_loss_fn: Callable) -> Dict[str, torch.Tensor]:
    """The eight scalars of the reference's train graph
    (train.py:294-406)."""
    teacher_label_loss = model_label_loss(out_t, labels, label_loss_fn)
    teacher_reg = out_t["regularization_loss"]
    teacher_final = cfg.regularization_penalty * teacher_reg + teacher_label_loss
    if "state" not in out_t or "state" not in out_s:
        # the reference's train.py unpacks `state, result =
        # model.create_model(...)` (train.py:281-288), which only
        # HierarchicalLstmModel provides
        raise ValueError(
            f"model '{cfg.model}' does not return a distillation 'state'; "
            "teacher-student training requires HierarchicalLstmModel. "
            "Train single-tower models with cli.finetune --start_new_model.")
    l_rep = losses_lib.representation_loss(out_t["state"], out_s["state"])
    l_pred = losses_lib.prediction_kl_loss(out_t["predictions"],
                                           out_s["predictions"])
    student_label_loss = model_label_loss(out_s, labels, label_loss_fn)
    student_reg = out_s["regularization_loss"]
    rep_weight = 2.0 if cfg.faithful_quirks else 1.0
    student_total = (rep_weight * l_rep + l_pred + student_label_loss
                     + cfg.regularization_penalty * student_reg)
    return {
        "teacher_label_loss": teacher_label_loss,
        "teacher_final_loss": teacher_final,
        "teacher_reg_loss": teacher_reg,
        "student_loss_state": l_rep,  # L_REP
        "pred_loss": l_pred,  # L_PRED
        "student_label_loss": student_label_loss,  # L_CE
        "student_reg_loss": student_reg,
        "total_student_loss": student_total,
    }


def param_grads(loss: torch.Tensor, *modules) -> Tuple[Tensors, ...]:
    """d loss / d parameters of each module, as dicts by name; zeros for
    a parameter the loss does not reach (batch-norm moving statistics in
    training), as `jax.grad` gives."""
    params = [params_of(m) for m in modules]
    flat_params = [p for ps in params for p in ps.values()]
    flat = torch.autograd.grad(loss, flat_params, allow_unused=True)
    flat = [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat_params, flat)]
    out, i = [], 0
    for ps in params:
        out.append(dict(zip(ps, flat[i:i + len(ps)])))
        i += len(ps)
    return tuple(out)


def step_rng(cfg: TrainConfig, global_step: int, group=None) -> prng.Key:
    """The key of a train step's dropout and frame sampling:
    ``fold_in(PRNGKey(seed), global_step)``, as the JAX steps derive it;
    in a data-parallel step the rank is folded in too, as the JAX
    shard_map steps fold `axis_index`, so the ranks' draws differ."""
    key = prng.fold_in(prng.prng_key(cfg.seed), global_step)
    return key if group is None else prng.fold_in(key, dist.get_rank(group))


class _Layout:
    """What a train step reads of its mesh: the data group (None without
    one), tensor parallelism, and the rule of its random draws and of
    DBoF's batch moments."""

    def __init__(self, cfg: TrainConfig, mesh: Optional[Mesh]):
        self.mesh = mesh
        self.tp = mesh is not None and mesh.model > 1
        self.group = None if mesh is None else mesh.group
        if self.tp:
            # a data group of one rank has nothing to reduce; JAX runs
            # tensor parallelism as one GSPMD program over the global
            # batch, so its batch moments are the global batch's whatever
            # --sync_batch_norm says
            self.group = self.group if mesh.data > 1 else None
            self.bn_group = self.group
        else:
            self.bn_group = self.group if cfg.sync_batch_norm else None

    def rng(self, cfg: TrainConfig, global_step: int) -> prng.Key:
        """`step_rng`; under tensor parallelism no rank is folded in (the
        JAX GSPMD step folds no device index, train/step.py:430-434)."""
        return step_rng(cfg, global_step, None if self.tp else self.group)

    def draws(self):
        """Under tensor parallelism with data > 1, the rank's rows of the
        global batch's draws."""
        if self.tp and self.mesh.data > 1:
            return prng.global_batch_rows(self.mesh.data_index, self.mesh.data)
        return contextlib.nullcontext()


def _distill(cfg: TrainConfig, state: DistillState, features_u8, labels,
             num_frames, kernel_train_mode: Optional[str] = None,
             mesh: Optional[Mesh] = None):
    label_loss_fn = resolve_label_loss(cfg)
    layout = _Layout(cfg, mesh)
    group = layout.group
    model_input = preprocess_batch(cfg, features_u8, num_frames)
    model_input_s = uniform_subsample(model_input, cfg.every_n)
    nf_student = student_num_frames(num_frames, cfg.every_n, cfg.max_num_frames)
    rng_t, rng_s = prng.split(layout.rng(cfg, state.global_step))
    with layout.draws():
        out_t = forward_teacher(cfg, state.teacher, model_input, num_frames,
                                labels, dropout_keep_prob=state.dropout_keep_prob,
                                rng=rng_t, kernel_train_mode=kernel_train_mode,
                                bn_group=layout.bn_group)
        out_s = forward_student(cfg, state.student, model_input_s, nf_student,
                                labels, dropout_keep_prob=state.dropout_keep_prob,
                                rng=rng_s, kernel_train_mode=kernel_train_mode,
                                bn_group=layout.bn_group)
    ls = _distill_losses(cfg, out_t, out_s, labels, label_loss_fn)
    total = ls["teacher_final_loss"] + ls["total_student_loss"]
    if group is not None:
        # the batch-mean terms (CE, L_REP) and the l2 term / n (n the data
        # size), so that the ranks' summed gradients are the global
        # batch's; the batch-SUM L_PRED stays unscaled
        total = (total - ls["pred_loss"]) / dist.get_world_size(group) + ls["pred_loss"]
    g_t, g_s = param_grads(total, state.teacher, state.student)
    ls = {name: value.detach() for name, value in ls.items()}
    return (ls, out_t["predictions"].detach(), g_t, g_s,
            (out_t.get("updated_stats"), out_s.get("updated_stats")))


def distill_loss_and_grads(cfg: TrainConfig, state: DistillState,
                           features_u8: torch.Tensor, labels: torch.Tensor,
                           num_frames: torch.Tensor,
                           kernel_train_mode: Optional[str] = None,
                           mesh: Optional[Mesh] = None):
    """Both towers forward and ONE backward of ``teacher_final +
    total_student`` (the teacher gets no gradient from the student terms:
    L_REP and L_PRED detach it), with the dropout keys of
    `state.global_step` (`step_rng`, split into teacher and student).
    Returns (the eight loss scalars, detached; the teacher's predictions,
    detached; the teacher's and the student's gradients, dicts by
    parameter name: under tensor parallelism (`mesh`), this rank's
    columns of the sharded ones, not yet reduced over the data group)."""
    return _distill(cfg, state, features_u8, labels, num_frames,
                    kernel_train_mode, mesh)[:4]


def _schedule(cfg: TrainConfig):
    return exponential_decay(cfg.base_learning_rate, cfg.batch_size,
                             cfg.learning_rate_decay_examples,
                             cfg.learning_rate_decay)


def reduce_distill_losses(ls: Tensors, group) -> Tensors:
    """The eight distill scalars of the global batch from the ranks':
    averaged, except the batch-sum L_PRED, which is summed (and enters
    the total student loss summed), in one all-reduce."""
    ls = dict(ls, total_student_loss=ls["total_student_loss"] - ls["pred_loss"])
    out = reduce_scalars(ls, group, summed=("pred_loss",))
    out["total_student_loss"] = out["total_student_loss"] + out["pred_loss"]
    return out


def build_distill_train_step(cfg: TrainConfig, optimizer: Optimizer,
                             top_k: int = 20,
                             kernel_train_mode: Optional[str] = None,
                             mesh: Optional[Mesh] = None):
    """Returns step(state, features_u8, labels, num_frames) -> (state,
    metrics): `distill_loss_and_grads`, then one optimizer update per
    tower (gradients clipped per variable), both at the learning rate of
    the same pre-update global step, which then advances by 2 in faithful
    mode, else 1. The metrics are the loss scalars, the learning rate,
    the new global step, and the teacher's top-k and exact PERR (the
    reference's per-step log covers the teacher only).

    With a `mesh` (a process group), the step is one rank's part of a
    data-parallel step (the JAX step with `axis_name`): the batch-mean
    loss terms and the l2 term are scaled by 1/n (n the data size), the
    batch-sum L_PRED is not, one bucketed all-reduce over the data group
    sums the gradients, and the clipped TF-Adam update then runs
    identically on every rank of a data group. The reported scalars are
    averaged over the data group (L_PRED summed), and DBoF's moving
    statistics averaged (its batch moments too, inside the forward, with
    `cfg.sync_batch_norm`, or always under tensor parallelism). The top-k
    and PERR are this rank's rows."""
    schedule = _schedule(cfg)
    step_increment = 2 if cfg.faithful_quirks else 1
    resolve_label_loss(cfg)  # a missing counts file fails here, not mid-run
    group = _Layout(cfg, mesh).group

    def step(state: DistillState, features_u8, labels, num_frames):
        ls, preds_t, g_t, g_s, (upd_t, upd_s) = _distill(
            cfg, state, features_u8, labels, num_frames, kernel_train_mode,
            mesh)
        if group is not None:
            all_reduce_grads([g_t, g_s], group)
            ls = reduce_distill_losses(ls, group)
            upd_t, upd_s = mean_tensors(upd_t, group), mean_tensors(upd_s, group)
        lr = schedule(state.global_step)
        optimizer.update(g_t, state.opt_teacher, params_of(state.teacher), lr,
                         _shards(state.teacher))
        optimizer.update(g_s, state.opt_student, params_of(state.student), lr,
                         _shards(state.student))
        _merge_updated_stats(state.teacher, upd_t)
        _merge_updated_stats(state.student, upd_s)
        state.global_step += step_increment
        topk_val, topk_idx, perr = topk_and_perr_on_device(preds_t, labels,
                                                           top_k)
        metrics = dict(
            ls,
            learning_rate=lr,
            global_step=state.global_step,
            topk_val=topk_val,
            topk_idx=topk_idx,
            perr_precision=perr,
        )
        return state, metrics

    return step


def build_finetune_step(cfg: TrainConfig, optimizer: Optimizer,
                        top_k: int = 20, host_subsampled: bool = False,
                        aggregated: bool = False,
                        kernel_train_mode: Optional[str] = None,
                        mesh: Optional[Mesh] = None):
    """Student-only training: CE + reg (train_finetune.py:263-331).
    Returns step(state, features_u8, labels, num_frames) -> (state,
    metrics); the global step advances by 1. The dropout key (and DBoF's
    sampling key) is `step_rng` of the global step.

    `host_subsampled`: the frames were strided to every_n on the host;
    `num_frames` stays the ORIGINAL count. The uint8 frames are
    subsampled before preprocessing, so only the kept ones are
    dequantized and normalized.

    `aggregated`: the `--frame_features=False` branch: [B, D] float32
    features of pre-aggregated Examples into a video-level model
    (`forward_video_level`); `num_frames` is the reader's all-ones
    placeholder and is ignored.

    With a `mesh`, one rank's part of a data-parallel (and
    tensor-parallel) step, as in `build_distill_train_step`: both loss
    terms are scaled by 1/n and the gradients summed over the data
    group."""
    schedule = _schedule(cfg)
    label_loss_fn = resolve_label_loss(cfg)
    layout = _Layout(cfg, mesh)
    group = layout.group

    def step(state: StudentState, features_u8, labels, num_frames):
        rng = layout.rng(cfg, state.global_step)
        with layout.draws():
            if aggregated:
                out_s = forward_video_level(
                    cfg, state.student, preprocess_aggregated(features_u8),
                    labels, dropout_keep_prob=state.dropout_keep_prob, rng=rng)
            else:
                nf_student = student_num_frames(num_frames, cfg.every_n,
                                                cfg.max_num_frames)
                sub = (features_u8 if host_subsampled
                       else uniform_subsample(features_u8, cfg.every_n))
                model_input_s = preprocess_batch(cfg, sub, nf_student)
                out_s = forward_student(
                    cfg, state.student, model_input_s, nf_student, labels,
                    dropout_keep_prob=state.dropout_keep_prob, rng=rng,
                    kernel_train_mode=kernel_train_mode,
                    bn_group=layout.bn_group)
        label_loss = model_label_loss(out_s, labels, label_loss_fn)
        reg = out_s["regularization_loss"]
        total = cfg.regularization_penalty * reg + label_loss
        if group is not None:
            total = total / dist.get_world_size(group)
        (g_s,) = param_grads(total, state.student)
        scalars = {"student_label_loss": label_loss.detach(),
                   "student_reg_loss": reg.detach()}
        updated = out_s.get("updated_stats")
        if group is not None:
            all_reduce_grads([g_s], group)
            scalars = reduce_scalars(scalars, group)
            updated = mean_tensors(updated, group)
        lr = schedule(state.global_step)
        optimizer.update(g_s, state.opt_student, params_of(state.student), lr,
                         _shards(state.student))
        _merge_updated_stats(state.student, updated)
        state.global_step += 1
        preds = out_s["predictions"].detach()
        topk_val, topk_idx, perr = topk_and_perr_on_device(preds, labels, top_k)
        metrics = {
            **scalars,
            "learning_rate": lr,
            "global_step": state.global_step,
            "topk_val": topk_val,
            "topk_idx": topk_idx,
            "perr_precision": perr,
        }
        return state, metrics

    return step


# Paired-index host pack: two top-k indices per f32 lane. Bits 0-15 hold
# the even index, 16-29 the odd one, and bits 31+30 are ALWAYS set: the
# sign bit is the layout discriminator (a wide pack's index lanes are
# non-negative floats), and with bit 30 set the exponent field is
# 0x80..0xFE, a NEGATIVE NORMAL f32, never subnormal or NaN. Keeping the
# exponent below 0xFF caps the packable class id at 0x3F7F = 16255
# (YT8M: 4715).
PACKED_IDX_MAX = 0x3F7F
_PAIR_MARKER = -(1 << 30)  # bits 31+30 of an int32 (two's complement)


def _pack_host_outputs(topk_val, topk_idx, per_example_loss, perr,
                       num_classes: Optional[int] = None) -> torch.Tensor:
    """One f32 host bundle per batch: top-k values | top-k indices |
    per-example CE | PERR, read back by the JAX package's
    `parallel.distributed.unpack_host_pack`.

    When every class id fits (num_classes - 1 <= PACKED_IDX_MAX) the
    indices travel as int16 PAIRS bitcast into f32 lanes, [B, k +
    ceil(k/2) + 2], bit-exact; otherwise the wide [B, 2k + 2]
    one-index-per-lane layout (exact for class ids < 2**24)."""
    parts = [topk_val.to(torch.float32)]
    if num_classes is not None and num_classes - 1 <= PACKED_IDX_MAX:
        idx = topk_idx.to(torch.int32)
        if idx.shape[1] % 2:
            idx = F.pad(idx, (0, 1))
        words = idx[:, 0::2] | (idx[:, 1::2] << 16) | _PAIR_MARKER
        parts.append(words.contiguous().view(torch.float32))
    else:
        parts.append(topk_idx.to(torch.float32))
    parts.append(per_example_loss.to(torch.float32)[:, None])
    parts.append(perr.to(torch.float32)[:, None])
    return torch.cat(parts, dim=1)


def _faithful_eval_rngs(cfg: TrainConfig, num_frames: torch.Tensor,
                        mesh: Optional[Mesh] = None):
    """Eval-time frame-sampling keys (teacher, student) for DBoF under
    faithful mode, else (None, None). The reference samples frames at
    random at eval too (model_utils.py:39-58); the keys fold the batch's
    `sum(num_frames)` into `PRNGKey(seed)`, so every batch draws anew.
    The sum stays on the device: the keys are device tensors. On a mesh
    with data > 1 the JAX GSPMD eval step is one program over the global
    batch, so the sum is the global batch's, all-reduced over the data
    group (the draws go through `_eval_draws`)."""
    if not (cfg.faithful_quirks and cfg.model == "DbofModel"):
        return None, None
    total = torch.sum(num_frames)
    if _global_rows(mesh):
        dist.all_reduce(total, group=mesh.group)
    return tuple(prng.split(prng.fold_in(prng.prng_key(cfg.seed), total)))


def _global_rows(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None and mesh.data > 1


def _eval_draws(mesh: Optional[Mesh]):
    """The eval steps' random draws: on a mesh with data > 1 the global
    batch's, this rank's rows sliced out (`prng.global_batch_rows`), as
    the JAX GSPMD eval step draws them."""
    if _global_rows(mesh):
        return prng.global_batch_rows(mesh.data_index, mesh.data)
    return contextlib.nullcontext()


def _eval_outputs(predictions: torch.Tensor, labels: torch.Tensor,
                  top_k: int) -> Dict[str, torch.Tensor]:
    """The eval binaries' shared per-batch outputs: per-example CE,
    device top-k, exact PERR, and the packed host bundle."""
    eps = 10e-6
    fl = labels.to(torch.float32)
    per_example_loss = -torch.sum(
        fl * torch.log(predictions + eps)
        + (1 - fl) * torch.log(1 - predictions + eps), dim=1)
    topk_val, topk_idx, perr = topk_and_perr_on_device(predictions, labels,
                                                       top_k)
    return {
        "predictions": predictions,
        "per_example_loss": per_example_loss,
        "topk_val": topk_val,
        "topk_idx": topk_idx,
        "perr_precision": perr,
        "host_pack": _pack_host_outputs(topk_val, topk_idx, per_example_loss,
                                        perr, num_classes=predictions.shape[-1]),
    }


def build_validate_step(cfg: TrainConfig, top_k: int = 20,
                        mesh: Optional[Mesh] = None):
    """Student eval with the teacher present for L_REP
    (validate.py:109-189): both towers forward-only. Returns
    step(teacher, student, features_u8, labels, num_frames) -> the eight
    loss scalars and the student's `_eval_outputs`. `mesh`: the rank's
    rows are its data index's slice of the global batch (DBoF's eval
    keys, `_faithful_eval_rngs`)."""
    label_loss_fn = resolve_label_loss(cfg)

    @torch.no_grad()
    def step(teacher, student, features_u8, labels, num_frames):
        with profiling.annotate("step.eval"):
            model_input = preprocess_batch(cfg, features_u8, num_frames)
            model_input_s = uniform_subsample(model_input, cfg.every_n)
            nf_student = student_num_frames(num_frames, cfg.every_n,
                                            cfg.max_num_frames)
            rng_t, rng_s = _faithful_eval_rngs(cfg, num_frames, mesh)
            with _eval_draws(mesh):
                out_t = forward_teacher(cfg, teacher, model_input, num_frames,
                                        labels, inference=True, rng=rng_t)
                out_s = forward_student(cfg, student, model_input_s, nf_student,
                                        labels, inference=True, rng=rng_s)
            ls = _distill_losses(cfg, out_t, out_s, labels, label_loss_fn)
            return {**ls, **_eval_outputs(out_s["predictions"], labels, top_k)}

    return step


def build_eval_step(cfg: TrainConfig, top_k: int = 20,
                    kernel_override: Optional[bool] = None,
                    host_subsampled: bool = False,
                    aggregated: bool = False,
                    mesh: Optional[Mesh] = None):
    """Student-only eval (eval_finetune.py:108-176). Returns
    step(student, features_u8, labels, num_frames) -> `_eval_outputs`.

    `host_subsampled`: the frames were strided to every_n on the host;
    `num_frames` stays the ORIGINAL count. `kernel_override` replaces the
    rule that picks the forward-only kernel. `aggregated`: [B, D] float32
    pre-aggregated features into the video-level model
    (eval_finetune.py:298-302). `mesh`: as in `build_validate_step`."""

    @torch.no_grad()
    def step(student, features_u8, labels, num_frames):
        with profiling.annotate("step.eval"):
            if aggregated:
                out_s = forward_video_level(cfg, student,
                                            preprocess_aggregated(features_u8),
                                            labels, inference=True)
                return _eval_outputs(out_s["predictions"], labels, top_k)
            # subsample uint8 first: only the kept frames are preprocessed
            nf_student = student_num_frames(num_frames, cfg.every_n,
                                            cfg.max_num_frames)
            sub = (features_u8 if host_subsampled
                   else uniform_subsample(features_u8, cfg.every_n))
            model_input_s = preprocess_batch(cfg, sub, nf_student)
            _, rng_s = _faithful_eval_rngs(cfg, num_frames, mesh)
            with _eval_draws(mesh):
                out_s = forward_student(cfg, student, model_input_s, nf_student,
                                        labels, inference=True, rng=rng_s,
                                        kernel_override=kernel_override)
            return _eval_outputs(out_s["predictions"], labels, top_k)

    return step


def build_quantized_eval_step(cfg: TrainConfig, top_k: int = 20,
                              host_subsampled: bool = False):
    """`build_eval_step` with the int8 forward (ops/quantize.py): takes
    QUANTIZED parameters (`ops.quantize.quantize_hierarchical_params`);
    same outputs. On a CUDA device with `cfg.use_pallas_inference` the
    recurrences run in the int8 kernel. Flagship HierarchicalLstm + MoE
    only."""
    if (cfg.model != "HierarchicalLstmModel"
            or cfg.video_level_classifier_model != "MoeModel"):
        raise ValueError(
            "--quantize int8 covers the flagship HierarchicalLstmModel "
            "+ MoeModel configuration")

    def step(qparams, features_u8, labels, num_frames):
        with profiling.annotate("step.eval"):
            nf_student = student_num_frames(num_frames, cfg.every_n,
                                            cfg.max_num_frames)
            sub = (features_u8 if host_subsampled
                   else uniform_subsample(features_u8, cfg.every_n))
            model_input_s = preprocess_batch(cfg, sub, nf_student)
            predictions = quantized_hierarchical_forward(
                qparams, model_input_s, nf_student, cfg.num_inputs_L1,
                cfg.num_classes, cfg.moe_num_mixtures,
                use_kernel=(cfg.use_pallas_inference
                            and features_u8.device.type == "cuda"))
            return _eval_outputs(predictions, labels, top_k)

    return step
