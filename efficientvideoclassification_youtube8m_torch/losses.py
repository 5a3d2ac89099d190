"""Loss registry (port of the JAX package's losses.py): the nine label
losses of the reference's losses.py as ``loss(predictions, labels) ->
scalar``, and the two distillation losses of the distill step.

Reductions follow the reference: per-example sum over classes, mean over
the batch, except L_PRED, which is a SUM over the batch (train.py:402).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

LOSS_REGISTRY: Dict[str, Callable] = {}


def register_loss(name: str):
    def deco(fn):
        LOSS_REGISTRY[name] = fn
        return fn

    return deco


def get_loss(name: str) -> Callable:
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown loss {name!r}; registered: {sorted(LOSS_REGISTRY)}"
        ) from None


_EPSILON = 10e-6  # the reference's epsilon (losses.py:34 etc.)


def _binary_ce(predictions, float_labels, epsilon=_EPSILON):
    return -(float_labels * torch.log(predictions + epsilon)
             + (1.0 - float_labels) * torch.log(1.0 - predictions + epsilon))


def _row_sum_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(x, dim=1))


@register_loss("CrossEntropyLoss")
def cross_entropy_loss(predictions: torch.Tensor, labels: torch.Tensor,
                       **_) -> torch.Tensor:
    """losses.py:86-97, the default label loss: binary cross-entropy
    summed over classes, mean over the batch."""
    return _row_sum_mean(_binary_ce(predictions, labels.to(torch.float32)))


@register_loss("CrossEntropyLossWithSparsity")
def cross_entropy_loss_with_sparsity(predictions, labels, **_):
    """losses.py:28-41: CE + 0.1 * the mean row sum of the predictions."""
    ce = _row_sum_mean(_binary_ce(predictions, labels.to(torch.float32)))
    return ce + 0.1 * _row_sum_mean(predictions)


@register_loss("CrossEntropyLossTop50")
def cross_entropy_loss_top50(predictions, labels, **_):
    """losses.py:43-60: CE masked to each row's top-50 predictions (every
    class at or above the 50th value, so ties may keep more), rescaled
    by 4716/50."""
    ce = _binary_ce(predictions, labels.to(torch.float32))
    values = torch.topk(predictions, 50, dim=1).values[:, 49]
    mask = (predictions >= values[:, None]).to(torch.float32)
    return _row_sum_mean(ce * mask * (4716.0 / 50.0))


@register_loss("PWELoss")
def pwe_loss(predictions, labels, faithful_quirks: bool = False, **_):
    """losses.py:62-84: the pairwise exponential loss, as the sum of the
    reference's matrix-valued loss (what slim's train op differentiates),
    in the factorized O(V) form of the JAX package:
    sum_{a,b} p_a (1-p_b) e^{-(l_a - l_b)} / (sum p * sum (1-p)) per row,
    summed, over the batch. `faithful_quirks` keeps the literal graph's
    hard-coded reshape to 128 rows (losses.py:70-71): any other batch
    raises, as the JAX package does."""
    float_labels = labels.to(torch.float32)
    if faithful_quirks and predictions.shape[0] != 128:
        raise ValueError(f"PWELoss with faithful_quirks reshapes the "
                         f"predictions to 128 rows; the batch has "
                         f"{predictions.shape[0]}")
    a = torch.sum(predictions * torch.exp(-float_labels), dim=1)
    b = torch.sum((1.0 - predictions) * torch.exp(float_labels), dim=1)
    per = a * b / (torch.sum(predictions, dim=1)
                   * torch.sum(1.0 - predictions, dim=1))
    return torch.sum(per) / predictions.shape[0]


@register_loss("CrossEntropyLossClassImbalance")
def cross_entropy_loss_class_imbalance(predictions, labels, class_counts=None,
                                       total_examples=4906660.0 + 1401828.0, **_):
    """losses.py:99-119: the positive terms weighted by 1/sqrt(class
    frequency), from per-class counts (the reference's `counts_tv` file,
    read once when the step is built)."""
    if class_counts is None:
        raise ValueError("CrossEntropyLossClassImbalance needs class_counts")
    float_labels = labels.to(torch.float32)
    counts = torch.as_tensor(class_counts, dtype=torch.float32,
                             device=predictions.device)
    pw = 1.0 / torch.sqrt(counts / total_examples)
    ce = -(pw[None, :] * float_labels * torch.log(predictions + _EPSILON)
           + (1.0 - float_labels) * torch.log(1.0 - predictions + _EPSILON))
    return _row_sum_mean(ce)


@register_loss("CrossEntropyLossPositives")
def cross_entropy_loss_positives(predictions, labels, **_):
    """losses.py:121-131: only the positive-label CE terms."""
    float_labels = labels.to(torch.float32)
    return _row_sum_mean(-(float_labels * torch.log(predictions + _EPSILON)))


@register_loss("NewLoss")
def new_loss(predictions, labels, **_):
    """losses.py:133-151: hard examples on both sides, positives below
    0.9 and negatives above the least positive probability OF THE WHOLE
    BATCH minus 0.1 (at least 0.1)."""
    float_labels = labels.to(torch.float32)
    bad_positive = (predictions < 0.9).to(torch.float32)
    ce1 = bad_positive * float_labels * torch.log(predictions + _EPSILON)
    prob_positive = predictions * float_labels + (1.0 - float_labels)
    min_prob_positive = torch.clamp(torch.min(prob_positive) - 0.1, min=0.1)
    prob_negative = predictions * (1.0 - float_labels)
    bad_negative = (prob_negative > min_prob_positive).to(torch.float32)
    ce0 = (bad_negative * (1.0 - float_labels)
           * torch.log(1.0 - predictions + _EPSILON))
    return _row_sum_mean(-(ce0 + ce1))


@register_loss("HingeLoss")
def hinge_loss(predictions, labels, b: float = 1.0, **_):
    """losses.py:153-169: the multi-label hinge on +-1 sign labels."""
    sign_labels = 2.0 * labels.to(torch.float32) - 1.0
    return _row_sum_mean(torch.clamp(b - sign_labels * predictions, min=0.0))


@register_loss("SoftmaxLoss")
def softmax_loss(predictions, labels, **_):
    """losses.py:172-196: softmax CE against L1-normalized labels (with
    the reference's row-sum floor of 10e-8)."""
    epsilon = 10e-8
    float_labels = labels.to(torch.float32)
    label_rowsum = torch.clamp(torch.sum(float_labels, dim=1, keepdim=True),
                               min=epsilon)
    norm_labels = float_labels / label_rowsum
    softmax_outputs = torch.softmax(predictions, dim=-1)
    return torch.mean(-torch.sum(norm_labels * torch.log(softmax_outputs), dim=1))


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
