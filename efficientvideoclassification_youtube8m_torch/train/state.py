"""Training state (port of the JAX package's train/state.py).

The JAX pytree of parameters, optimizer slots and the shared global
step becomes a dataclass holding the two towers' `nn.Module`s, their
optimizer slots (dicts of tensors keyed by parameter name, plus Adam's
count), the global step (a Python int) and the dropout keep-prob. The
train steps update it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.train.optimizer import Optimizer
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


def init_model(cfg: TrainConfig, generator: Optional[torch.Generator] = None,
               device=None) -> nn.Module:
    """`cfg.model` at the config's sizes, with weights drawn from
    `generator` (the counterpart of the JAX `model.init`)."""
    return get_model(cfg.model)(
        cfg.total_feature_size, cfg.num_classes,
        lstm_cells=cfg.lstm_cells, lstm_layers=cfg.lstm_layers,
        classifier=cfg.video_level_classifier_model,
        classifier_kwargs={"num_mixtures": cfg.moe_num_mixtures},
        generator=generator, device=device,
    )


def params_of(module: nn.Module) -> dict:
    """The module's parameters by name: what the optimizer updates."""
    return dict(module.named_parameters())


@dataclasses.dataclass
class DistillState:
    """Teacher + student joint training state (cli train.py)."""

    teacher: nn.Module
    student: nn.Module
    opt_teacher: dict
    opt_student: dict
    global_step: int  # shared, advances 2 per batch in faithful mode
    dropout_keep_prob: float  # the reference's dropout_var


@dataclasses.dataclass
class StudentState:
    """Student-only state (finetune)."""

    student: nn.Module
    opt_student: dict
    global_step: int
    dropout_keep_prob: float


def init_distill_state(cfg: TrainConfig, optimizer: Optimizer,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> DistillState:
    """Teacher then student drawn from `generator` (a fresh one seeded
    with `cfg.seed` when None), zero optimizer slots, step 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    teacher = init_model(cfg, generator, device)
    student = init_model(cfg, generator, device)
    return DistillState(
        teacher=teacher,
        student=student,
        opt_teacher=optimizer.init(params_of(teacher)),
        opt_student=optimizer.init(params_of(student)),
        global_step=0,
        dropout_keep_prob=cfg.dropout,
    )


def student_state_from_distill(state: DistillState, optimizer: Optimizer
                               ) -> StudentState:
    """The convert step (train_convert_model.py:360-401): keep the
    student, drop the teacher, and start the finetune phase from fresh
    optimizer slots and step 0."""
    return StudentState(
        student=state.student,
        opt_student=optimizer.init(params_of(state.student)),
        global_step=0,
        dropout_keep_prob=state.dropout_keep_prob,
    )
