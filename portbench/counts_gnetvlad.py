"""The frozen yardstick of Gated NetVLAD's work (the model of
`portbench/reference/gated_netvlad.py`): the FLOPs and the least bytes of
one forward, and the least time it could take on the H100.

FLOPs count the matrix products, 2 per multiply-add, over every padded
frame row (the program computes them all): in each branch the cluster
logits [D, K] a frame and the aggregation a video (K x T x D); then a
video's hidden FC [codes, H], context gate [H, H], MoE head (gates and
experts, [H, (2 m + 1) V]) and probability gate [V, V]. Elementwise work
is not counted.

The least bytes: the uint8 frames read once, every parameter read once
in the configuration's bfloat16, the float32 predictions written once.

Rates: `portbench/counts.py`'s (the H100 SXM's data sheet, dense, at
700 W).
"""

from __future__ import annotations

import math
from typing import Dict

from portbench.counts import BF16_FLOPS, HBM_BYTES
from portbench.weights_gnetvlad import branches, leaves


def forward_flops(flags: Dict, widths: Dict, batch: int) -> int:
    """Model FLOPs of one forward on `batch` videos of `max_num_frames`
    frames, at a configuration's flags and "gnetvlad" widths."""
    T = flags["max_num_frames"]
    total, codes = 0, 0
    for _, D, K in branches(flags, widths):
        total += 2 * batch * T * D * K * 2  # the logits and the aggregation
        codes += D * K
    H, V, m = widths["hidden_size"], flags["num_classes"], flags["moe_num_mixtures"]
    per_video = codes * H + H * H + H * (2 * m + 1) * V + V * V
    return total + 2 * batch * per_video


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
