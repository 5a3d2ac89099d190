"""TensorBoard summaries (port of the JAX package's utils/summary.py).

The events-file writer and the reference's summary helpers do not import
jax and are imported from the JAX package: `SummaryWriter`,
`for_master`, `make_histogram_from_stats`, `add_global_step_summary`,
`add_epoch_summary`. This module ports `write_variable_histograms`, whose
statistics the JAX package computes on the device with jax.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch
from torch import nn

from efficientvideoclassification_youtube8m_tpu.utils.summary import (  # noqa: F401
    _BUCKET_LIMITS,
    SummaryWriter,
    add_epoch_summary,
    add_global_step_summary,
    for_master,
    make_histogram_from_stats,
)

with np.errstate(over="ignore"):
    # f32 limits: the limits beyond f32's range become +/-inf, which only
    # matters for values no f32 parameter holds
    _LIMITS_F32 = _BUCKET_LIMITS.astype(np.float32)


def jax_order(names):
    """`names` (dotted parameter names) in the order jax flattens the JAX
    parameter tree: dict keys sorted, list entries by index."""
    return sorted(names, key=lambda n: tuple(int(p) if p.isdigit() else p
                                             for p in n.split(".")))


def histogram_stats(tensors) -> np.ndarray:
    """Histogram statistics of each tensor, computed on its device like
    the JAX package's `histogram_stats_on_device`, and fetched in ONE
    transfer: a float64 array [P, 5 + L] of (num, min, max, sum,
    sum_squares, bucket counts). Non-finite values are dropped; a value v
    falls in the first bucket whose limit is >= v (`bucketize(right=False)`
    = `searchsorted(side="left")`); counts are integers (exact in float64)."""
    rows = []
    for t in tensors:
        x = t.detach().reshape(-1).to(torch.float32)
        limits = torch.from_numpy(_LIMITS_F32).to(x.device)
        finite = torch.isfinite(x)
        xf = torch.where(finite, x, 0.0)
        idx = torch.bucketize(x, limits, right=False).clamp_(0, len(limits) - 1)
        counts = torch.zeros(len(limits), dtype=torch.int64, device=x.device)
        counts.index_add_(0, idx, finite.to(torch.int64))
        head = torch.stack([
            finite.sum().to(torch.float64),
            torch.where(finite, x, float("inf")).min().to(torch.float64),
            torch.where(finite, x, float("-inf")).max().to(torch.float64),
            xf.sum().to(torch.float64),
            (xf * xf).sum().to(torch.float64),
        ])
        rows.append(torch.cat([head, counts.to(torch.float64)]))
    return torch.stack(rows).cpu().numpy()


def write_variable_histograms(writer: SummaryWriter,
                              params: Union[nn.Module, Dict[str, torch.Tensor]],
                              prefix: str, global_step: int) -> None:
    """One histogram per model variable, tag = its path with slashes
    (`model/rnn_l1/0/kernel`), in the JAX package's order — the rebuild of
    `tf.summary.histogram` over `slim.get_model_variables()`
    (train.py:426-427), emitted at the save_summaries_secs cadence."""
    named = dict(params.state_dict() if isinstance(params, nn.Module) else params)
    names = jax_order(named)
    stats = histogram_stats([named[n] for n in names])
    for name, row in zip(names, stats):
        num, vmin, vmax, vsum, sumsq = row[:5]
        writer.add_summary(
            make_histogram_from_stats(
                f"{prefix}/{name.replace('.', '/')}", float(num),
                float(vmin) if num else 0.0, float(vmax) if num else 0.0,
                float(vsum), float(sumsq), row[5:]),
            global_step)
