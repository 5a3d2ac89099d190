"""The frozen yardstick of NeXtVLAD's work (the model of
`portbench/reference/nextvlad.py`): the FLOPs and the least bytes of one
forward, and the least time it could take on the H100.

FLOPs count the matrix products, 2 per multiply-add, over every padded
frame row (the program computes them all): in each branch the expansion
[D, E], the attention [E, G], the cluster logits [E, G K] a frame, and
the aggregation a video (K x T G x F); then the hidden FC, the two gating
FCs and the logistic head a video. Elementwise work is not counted.

The least bytes: the uint8 frames read once, every parameter read once
in the configuration's bfloat16, the float32 predictions written once.

Rates: `portbench/counts.py`'s (the H100 SXM's data sheet, dense, at
700 W).
"""

from __future__ import annotations

import math
from typing import Dict

from portbench.counts import BF16_FLOPS, HBM_BYTES
from portbench.weights_vlad import branches, leaves


def forward_flops(flags: Dict, widths: Dict, batch: int) -> int:
    """Model FLOPs of one forward on `batch` videos of `max_num_frames`
    frames, at a configuration's flags and "nextvlad" widths."""
    T = flags["max_num_frames"]
    rows = batch * T
    total, codes = 0, 0
    for _, D, K, G in branches(flags, widths):
        E = widths["expansion"] * D
        F = E // G
        total += 2 * rows * (D * E + E * G + E * G * K)
        total += 2 * batch * K * T * G * F
        codes += F * K
    H = widths["hidden_size"]
    S = H // widths["gating_reduction"]
    total += 2 * batch * (codes * H + 2 * H * S + H * flags["num_classes"])
    return total


def parameters(flags: Dict, widths: Dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaves(flags, widths))


def forward_bytes(flags: Dict, widths: Dict, batch: int) -> int:
    features = sum(int(s) for s in str(flags["feature_sizes"]).split(","))
    return (batch * flags["max_num_frames"] * features + 2 * parameters(flags, widths)
            + 4 * batch * flags["num_classes"])


def bound_s(flags: Dict, widths: Dict, batch: int) -> float:
    """The least seconds one forward could take: the larger of its FLOPs
    over the bf16 peak and its bytes over the memory rate."""
    return max(forward_flops(flags, widths, batch) / BF16_FLOPS,
               forward_bytes(flags, widths, batch) / HBM_BYTES)

