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
optimizer slots) and return it with their metrics.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from efficientvideoclassification_youtube8m_torch import losses as losses_lib
from efficientvideoclassification_youtube8m_torch.metrics.eval_util import (
    perr_precision_on_device,
    topk_on_device,
)
from efficientvideoclassification_youtube8m_torch.ops.preprocess import (
    dequantize,
    l2_normalize,
    student_num_frames,
    uniform_subsample,
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
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

Tensors = Dict[str, torch.Tensor]


def resolve_label_loss(cfg: TrainConfig) -> Callable:
    """The label loss from the registry. Only CrossEntropyLoss is ported;
    the other names raise (ROADMAP Queue 1 item 12)."""
    return losses_lib.get_loss(cfg.label_loss)


def _model_apply_kwargs(cfg: TrainConfig, device: torch.device,
                        inference: bool = False,
                        kernel_train_mode: Optional[str] = None,
                        kernel_override: Optional[bool] = None
                        ) -> Dict[str, Any]:
    """Model keywords of the forward.

    Inference: the forward-only kernel for bf16 on a CUDA device when
    `cfg.use_pallas_inference` is set; `kernel_override` (the JAX
    `pallas_override`) replaces that rule. Training: the train kernels for
    bf16 on a CUDA device when `cfg.lstm_pallas_train` is set (the JAX
    rule, with "tpu" read as "cuda"; the flags keep the names the shared
    config gives them). `kernel_train_mode` overrides the training rule:
    "on" forces the train kernels (their plain versions on CPU tensors),
    "off" the plain scan."""
    is_cuda = torch.device(device).type == "cuda"
    bf16 = cfg.compute_dtype == "bfloat16"
    kw: Dict[str, Any] = {
        "classifier": cfg.video_level_classifier_model,
        "compute_dtype": torch.bfloat16 if bf16 else torch.float32,
        # MoeModel is the only head ported so far
        "num_mixtures": cfg.moe_num_mixtures,
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
                    num_frames: torch.Tensor, inference: bool = False,
                    kernel_train_mode: Optional[str] = None):
    """The teacher tower: all frames, `cfg.num_inputs_to_lstm` chunks."""
    _check_model(cfg, model)
    return model(
        model_input, num_frames, num_chunks=cfg.num_inputs_to_lstm,
        **_model_apply_kwargs(cfg, model_input.device, inference,
                              kernel_train_mode),
    )


def forward_student(cfg: TrainConfig, model, model_input_student: torch.Tensor,
                    num_frames_stud: torch.Tensor, inference: bool = False,
                    kernel_train_mode: Optional[str] = None,
                    kernel_override: Optional[bool] = None):
    """`create_model_inference`: the same architecture on the subsampled
    frames, with `cfg.num_inputs_L1` chunks."""
    _check_model(cfg, model)
    return model(
        model_input_student, num_frames_stud, num_chunks=cfg.num_inputs_L1,
        **_model_apply_kwargs(cfg, model_input_student.device, inference,
                              kernel_train_mode, kernel_override),
    )


def _distill_losses(cfg: TrainConfig, out_t, out_s, labels,
                    label_loss_fn: Callable) -> Dict[str, torch.Tensor]:
    """The eight scalars of the reference's train graph
    (train.py:294-406)."""
    teacher_label_loss = label_loss_fn(out_t["predictions"], labels)
    teacher_reg = out_t["regularization_loss"]
    teacher_final = cfg.regularization_penalty * teacher_reg + teacher_label_loss
    l_rep = losses_lib.representation_loss(out_t["state"], out_s["state"])
    l_pred = losses_lib.prediction_kl_loss(out_t["predictions"],
                                           out_s["predictions"])
    student_label_loss = label_loss_fn(out_s["predictions"], labels)
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


def _grads(loss: torch.Tensor, *modules) -> Tuple[Tensors, ...]:
    """d loss / d parameters of each module, as dicts by name."""
    params = [params_of(m) for m in modules]
    flat = torch.autograd.grad(loss, [p for ps in params for p in ps.values()])
    out, i = [], 0
    for ps in params:
        out.append(dict(zip(ps, flat[i:i + len(ps)])))
        i += len(ps)
    return tuple(out)


def distill_loss_and_grads(cfg: TrainConfig, state: DistillState,
                           features_u8: torch.Tensor, labels: torch.Tensor,
                           num_frames: torch.Tensor,
                           kernel_train_mode: Optional[str] = None):
    """Both towers forward and ONE backward of ``teacher_final +
    total_student`` (the teacher gets no gradient from the student terms:
    L_REP and L_PRED detach it). Returns (the eight loss scalars,
    detached; the teacher's predictions, detached; the teacher's and the
    student's gradients, dicts by parameter name)."""
    label_loss_fn = resolve_label_loss(cfg)
    model_input = preprocess_batch(cfg, features_u8, num_frames)
    model_input_s = uniform_subsample(model_input, cfg.every_n)
    nf_student = student_num_frames(num_frames, cfg.every_n, cfg.max_num_frames)
    out_t = forward_teacher(cfg, state.teacher, model_input, num_frames,
                            kernel_train_mode=kernel_train_mode)
    out_s = forward_student(cfg, state.student, model_input_s, nf_student,
                            kernel_train_mode=kernel_train_mode)
    ls = _distill_losses(cfg, out_t, out_s, labels, label_loss_fn)
    g_t, g_s = _grads(ls["teacher_final_loss"] + ls["total_student_loss"],
                      state.teacher, state.student)
    ls = {name: value.detach() for name, value in ls.items()}
    return ls, out_t["predictions"].detach(), g_t, g_s


def _schedule(cfg: TrainConfig):
    return exponential_decay(cfg.base_learning_rate, cfg.batch_size,
                             cfg.learning_rate_decay_examples,
                             cfg.learning_rate_decay)


def build_distill_train_step(cfg: TrainConfig, optimizer: Optimizer,
                             top_k: int = 20,
                             kernel_train_mode: Optional[str] = None):
    """Returns step(state, features_u8, labels, num_frames) -> (state,
    metrics): `distill_loss_and_grads`, then one optimizer update per
    tower (gradients clipped per variable), both at the learning rate of
    the same pre-update global step, which then advances by 2 in faithful
    mode, else 1. The metrics are the loss scalars, the learning rate,
    the new global step, and the teacher's top-k and exact PERR (the
    reference's per-step log covers the teacher only)."""
    schedule = _schedule(cfg)
    step_increment = 2 if cfg.faithful_quirks else 1
    resolve_label_loss(cfg)  # an unported loss fails here, not mid-run

    def step(state: DistillState, features_u8, labels, num_frames):
        ls, preds_t, g_t, g_s = distill_loss_and_grads(
            cfg, state, features_u8, labels, num_frames, kernel_train_mode)
        lr = schedule(state.global_step)
        optimizer.update(g_t, state.opt_teacher, params_of(state.teacher), lr)
        optimizer.update(g_s, state.opt_student, params_of(state.student), lr)
        state.global_step += step_increment
        topk_val, topk_idx = topk_on_device(preds_t, top_k)
        metrics = dict(
            ls,
            learning_rate=lr,
            global_step=state.global_step,
            topk_val=topk_val,
            topk_idx=topk_idx,
            perr_precision=perr_precision_on_device(preds_t, labels),
        )
        return state, metrics

    return step


def build_finetune_step(cfg: TrainConfig, optimizer: Optimizer,
                        top_k: int = 20, host_subsampled: bool = False,
                        aggregated: bool = False,
                        kernel_train_mode: Optional[str] = None):
    """Student-only training: CE + reg (train_finetune.py:263-331).
    Returns step(state, features_u8, labels, num_frames) -> (state,
    metrics); the global step advances by 1.

    `host_subsampled`: the frames were strided to every_n on the host;
    `num_frames` stays the ORIGINAL count. The uint8 frames are
    subsampled before preprocessing, so only the kept ones are
    dequantized and normalized."""
    if aggregated:
        raise NotImplementedError(
            "the aggregated --frame_features=False branch is not ported yet "
            "(ROADMAP Queue 1 item 12)")
    schedule = _schedule(cfg)
    label_loss_fn = resolve_label_loss(cfg)

    def step(state: StudentState, features_u8, labels, num_frames):
        nf_student = student_num_frames(num_frames, cfg.every_n,
                                        cfg.max_num_frames)
        sub = (features_u8 if host_subsampled
               else uniform_subsample(features_u8, cfg.every_n))
        model_input_s = preprocess_batch(cfg, sub, nf_student)
        out_s = forward_student(cfg, state.student, model_input_s, nf_student,
                                kernel_train_mode=kernel_train_mode)
        label_loss = label_loss_fn(out_s["predictions"], labels)
        reg = out_s["regularization_loss"]
        (g_s,) = _grads(cfg.regularization_penalty * reg + label_loss,
                        state.student)
        lr = schedule(state.global_step)
        optimizer.update(g_s, state.opt_student, params_of(state.student), lr)
        state.global_step += 1
        preds = out_s["predictions"].detach()
        topk_val, topk_idx = topk_on_device(preds, top_k)
        metrics = {
            "student_label_loss": label_loss.detach(),
            "student_reg_loss": reg.detach(),
            "learning_rate": lr,
            "global_step": state.global_step,
            "topk_val": topk_val,
            "topk_idx": topk_idx,
            "perr_precision": perr_precision_on_device(preds, labels),
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


def _check_eval_model(cfg: TrainConfig) -> None:
    """Stands where the JAX eval steps call `_faithful_eval_rngs`, which
    draws eval-time frame-sampling rngs for `DbofModel` under faithful
    mode and none for the other models. DbofModel is not ported (ROADMAP
    Queue 1 item 12), so it raises here instead of evaluating without
    them."""
    if cfg.model == "DbofModel":
        raise NotImplementedError(
            "DbofModel and its eval-time frame sampling are not ported yet "
            "(ROADMAP Queue 1 item 12)")


def _eval_outputs(predictions: torch.Tensor, labels: torch.Tensor,
                  top_k: int) -> Dict[str, torch.Tensor]:
    """The eval binaries' shared per-batch outputs: per-example CE,
    device top-k, exact PERR, and the packed host bundle."""
    eps = 10e-6
    fl = labels.to(torch.float32)
    per_example_loss = -torch.sum(
        fl * torch.log(predictions + eps)
        + (1 - fl) * torch.log(1 - predictions + eps), dim=1)
    topk_val, topk_idx = topk_on_device(predictions, top_k)
    perr = perr_precision_on_device(predictions, labels)
    return {
        "predictions": predictions,
        "per_example_loss": per_example_loss,
        "topk_val": topk_val,
        "topk_idx": topk_idx,
        "perr_precision": perr,
        "host_pack": _pack_host_outputs(topk_val, topk_idx, per_example_loss,
                                        perr, num_classes=predictions.shape[-1]),
    }


def build_validate_step(cfg: TrainConfig, top_k: int = 20):
    """Student eval with the teacher present for L_REP
    (validate.py:109-189): both towers forward-only. Returns
    step(teacher, student, features_u8, labels, num_frames) -> the eight
    loss scalars and the student's `_eval_outputs`."""
    label_loss_fn = resolve_label_loss(cfg)
    _check_eval_model(cfg)

    @torch.no_grad()
    def step(teacher, student, features_u8, labels, num_frames):
        model_input = preprocess_batch(cfg, features_u8, num_frames)
        model_input_s = uniform_subsample(model_input, cfg.every_n)
        nf_student = student_num_frames(num_frames, cfg.every_n,
                                        cfg.max_num_frames)
        out_t = forward_teacher(cfg, teacher, model_input, num_frames,
                                inference=True)
        out_s = forward_student(cfg, student, model_input_s, nf_student,
                                inference=True)
        ls = _distill_losses(cfg, out_t, out_s, labels, label_loss_fn)
        return {**ls, **_eval_outputs(out_s["predictions"], labels, top_k)}

    return step


def build_eval_step(cfg: TrainConfig, top_k: int = 20,
                    kernel_override: Optional[bool] = None,
                    host_subsampled: bool = False,
                    aggregated: bool = False):
    """Student-only eval (eval_finetune.py:108-176). Returns
    step(student, features_u8, labels, num_frames) -> `_eval_outputs`.

    `host_subsampled`: the frames were strided to every_n on the host;
    `num_frames` stays the ORIGINAL count. `kernel_override` replaces the
    rule that picks the forward-only kernel."""
    if aggregated:
        raise NotImplementedError(
            "the aggregated --frame_features=False branch is not ported yet "
            "(ROADMAP Queue 1 item 12)")
    _check_eval_model(cfg)

    @torch.no_grad()
    def step(student, features_u8, labels, num_frames):
        # subsample uint8 first: only the kept frames are preprocessed
        nf_student = student_num_frames(num_frames, cfg.every_n,
                                        cfg.max_num_frames)
        sub = (features_u8 if host_subsampled
               else uniform_subsample(features_u8, cfg.every_n))
        model_input_s = preprocess_batch(cfg, sub, nf_student)
        out_s = forward_student(cfg, student, model_input_s, nf_student,
                                inference=True, kernel_override=kernel_override)
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
