"""Metrics: the host-side numpy metrics (a copy of the JAX package's:
the AP and mAP calculators, EvaluationMetrics, train_step_metrics) and
the device-side top-k and PERR in torch (metrics/eval_util.py)."""

from efficientvideoclassification_youtube8m_torch.metrics.average_precision import (
    AveragePrecisionCalculator,
)
from efficientvideoclassification_youtube8m_torch.metrics.eval_util import (
    EvaluationMetrics,
    calculate_gap,
    calculate_hit_at_one,
    calculate_precision_at_equal_recall_rate,
    flatten,
    topk_and_perr_on_device,
    top_k_by_class,
    top_k_triplets,
    train_step_metrics,
)
from efficientvideoclassification_youtube8m_torch.metrics.mean_average_precision import (
    MeanAveragePrecisionCalculator,
)

__all__ = [
    "AveragePrecisionCalculator",
    "MeanAveragePrecisionCalculator",
    "EvaluationMetrics",
    "calculate_gap",
    "calculate_hit_at_one",
    "calculate_precision_at_equal_recall_rate",
    "flatten",
    "topk_and_perr_on_device",
    "top_k_by_class",
    "top_k_triplets",
    "train_step_metrics",
]
