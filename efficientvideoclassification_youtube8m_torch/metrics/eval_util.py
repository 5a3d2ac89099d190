"""Device-side metrics of the train and eval steps (port of the device
part of the JAX package's metrics/eval_util.py). The host-side numpy
metrics do not import jax and are imported from the JAX package, not
copied: `train_step_metrics` turns a step's top-k and PERR into Hit@1,
PERR and GAP.
"""

from __future__ import annotations

from typing import Tuple

import torch

from efficientvideoclassification_youtube8m_tpu.metrics.eval_util import (  # noqa: F401
    train_step_metrics,
)


def topk_on_device(predictions: torch.Tensor, k: int = 20
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k], indices [B, k]) of each row's k largest scores,
    descending. Ties break lowest index first, as `lax.top_k` does: a
    STABLE ascending sort of the negated scores gives that order
    (`torch.topk` does not specify its tie order). Negating twice keeps
    the values' bits."""
    neg, idx = torch.sort(-predictions, dim=1, stable=True)
    return -neg[:, :k], idx[:, :k]


def _perr_from_tau(predictions, labels_f, n, tau):
    """PERR by threshold counting (`_perr_from_tau` of the JAX package):
    scores above the row's n-th largest score tau are in the top n; of
    the scores tied at tau, only (n - #above) fit, and the capacity is
    shared out in proportion (the expectation of a uniform tie pick)."""
    positive = predictions > 0  # the reference's numpy.nonzero filter
    above = predictions > tau[:, None]
    tied = predictions == tau[:, None]
    hits_above = torch.sum(labels_f * above * positive, dim=1)
    count_above = torch.sum(above, dim=1).to(torch.float32)
    tied_label_hits = torch.sum(labels_f * tied * positive, dim=1)
    tied_count = torch.sum(tied, dim=1).to(torch.float32)
    capacity = torch.clamp(n.to(torch.float32) - count_above, min=0.0)
    hits = hits_above + capacity * tied_label_hits / torch.clamp(
        tied_count, min=1.0)
    return torch.where(
        n > 0, hits / torch.clamp(n, min=1).to(torch.float32),
        torch.zeros_like(hits))


def perr_precision_on_device(predictions: torch.Tensor, labels: torch.Tensor
                             ) -> torch.Tensor:
    """EXACT per-video PERR precision over the full score row: precision
    within the top-|labels| predictions (reference eval_util.py:34-59).
    Returns [B] float32; rows without labels give 0."""
    labels_f = labels.to(torch.float32)
    V = predictions.shape[1]
    n = torch.sum(labels_f, dim=1).to(torch.int64)
    sorted_vals, _ = torch.sort(predictions, dim=1)  # ascending
    # n-th largest score; rows with n == 0 read the last column and are
    # masked out by _perr_from_tau
    pos = torch.clamp(V - n, 0, V - 1)
    tau = torch.gather(sorted_vals, 1, pos[:, None])[:, 0]
    return _perr_from_tau(predictions, labels_f, n, tau)
