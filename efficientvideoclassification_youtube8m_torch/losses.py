"""Loss registry (port of the JAX package's losses.py): the label loss
and the two distillation losses of the distill step.

Reductions follow the reference: per-example sum over classes, mean over
the batch, except L_PRED, which is a SUM over the batch (train.py:402).
The other label losses of the JAX registry are known here by name and
raise until they are ported.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

LOSS_REGISTRY: Dict[str, Callable] = {}

# registered in the JAX package, not ported yet (ROADMAP Queue 1, the model zoo and losses)
_NOT_PORTED = (
    "CrossEntropyLossWithSparsity", "CrossEntropyLossTop50", "PWELoss",
    "CrossEntropyLossClassImbalance", "CrossEntropyLossPositives", "NewLoss",
    "HingeLoss", "SoftmaxLoss",
)


def register_loss(name: str):
    def deco(fn):
        LOSS_REGISTRY[name] = fn
        return fn

    return deco


def get_loss(name: str) -> Callable:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the loss {name!r} is not ported yet (ROADMAP Queue 1, the model zoo and losses)")
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown loss {name!r}; registered: {sorted(LOSS_REGISTRY)}"
        ) from None


_EPSILON = 10e-6  # the reference's epsilon (losses.py:34 etc.)


@register_loss("CrossEntropyLoss")
def cross_entropy_loss(predictions: torch.Tensor, labels: torch.Tensor,
                       **_) -> torch.Tensor:
    """losses.py:86-97, the default label loss: binary cross-entropy
    summed over classes, mean over the batch."""
    float_labels = labels.to(torch.float32)
    ce = -(float_labels * torch.log(predictions + _EPSILON)
           + (1.0 - float_labels) * torch.log(1.0 - predictions + _EPSILON))
    return torch.mean(torch.sum(ce, dim=1))


def representation_loss(teacher_state: torch.Tensor,
                        student_state: torch.Tensor) -> torch.Tensor:
    """L_REP: mean over the batch of ||t_state - s_state||^2
    (train.py:359-362). The teacher side is detached, as the reference
    restricts the student train op to the student's variables."""
    per_example = torch.sum(
        torch.square(teacher_state.detach() - student_state), dim=1)
    return torch.mean(per_example)


def prediction_kl_loss(teacher_predictions: torch.Tensor,
                       student_predictions: torch.Tensor,
                       epsilon: float = 1e-20) -> torch.Tensor:
    """L_PRED: SUM over the batch of KL(Cat(t) || Cat(s)), both sides'
    sigmoid outputs renormalized per row into categorical distributions
    (train.py:398-402). `epsilon` guards both row normalizers (a row whose
    every class underflowed to 0) and both logs; normal values are
    unchanged by it. The teacher side is detached."""
    t = teacher_predictions.detach()
    t = t / torch.clamp(torch.sum(t, dim=1, keepdim=True), min=epsilon)
    s = student_predictions / torch.clamp(
        torch.sum(student_predictions, dim=1, keepdim=True), min=epsilon)
    kl = torch.sum(t * (torch.log(t + epsilon) - torch.log(s + epsilon)),
                   dim=1)
    return torch.sum(kl)
