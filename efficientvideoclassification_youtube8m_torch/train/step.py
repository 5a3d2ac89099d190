"""The forward half of the train/eval step (port of the JAX package's
train/step.py): input preprocessing, the model keyword rules, and the
teacher and student forwards. The distill, finetune and eval steps come
with the training port.

Input contract: raw uint8 features; dequantize + l2-normalize run here,
on the model's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from efficientvideoclassification_youtube8m_torch.ops.preprocess import (
    dequantize,
    l2_normalize,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


def _model_apply_kwargs(cfg: TrainConfig, device: torch.device,
                        inference: bool = False) -> Dict[str, Any]:
    """Model keywords of the forward. On the inference path the fused
    kernel is used for bf16 on a CUDA device when
    `cfg.use_pallas_inference` is set (the flag keeps the name the shared
    config gives it)."""
    if not inference:
        raise NotImplementedError(
            "the training forward comes with the distill step "
            "(ROADMAP Queue 1 item 7)")
    return {
        "classifier": cfg.video_level_classifier_model,
        "compute_dtype": torch.bfloat16
        if cfg.compute_dtype == "bfloat16" else torch.float32,
        "use_kernel": (cfg.use_pallas_inference
                       and cfg.compute_dtype == "bfloat16"
                       and torch.device(device).type == "cuda"),
        # MoeModel is the only head ported so far
        "num_mixtures": cfg.moe_num_mixtures,
    }


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
                    num_frames: torch.Tensor, inference: bool = False):
    """The teacher tower: all frames, `cfg.num_inputs_to_lstm` chunks."""
    _check_model(cfg, model)
    return model(
        model_input, num_frames, num_chunks=cfg.num_inputs_to_lstm,
        **_model_apply_kwargs(cfg, model_input.device, inference=inference),
    )


def forward_student(cfg: TrainConfig, model, model_input_student: torch.Tensor,
                    num_frames_stud: torch.Tensor, inference: bool = False):
    """`create_model_inference`: the same architecture on the subsampled
    frames, with `cfg.num_inputs_L1` chunks."""
    _check_model(cfg, model)
    return model(
        model_input_student, num_frames_stud, num_chunks=cfg.num_inputs_L1,
        **_model_apply_kwargs(cfg, model_input_student.device,
                              inference=inference),
    )
