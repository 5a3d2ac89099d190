"""The frozen yardstick of the LSTM baseline's work (the model of
`portbench/reference/lstm.py`): the FLOPs and the least bytes of one
forward, the least time it could take on the H100, and the least time
of one call of the scan kernel on a layer.

FLOPs count the matrix products, 2 per multiply-add, over every padded
row-step (the program computes them all): in each layer the input
projection [D, 4H] and the recurrent product [H, 4H] on each of the
batch x max_num_frames row-steps, D the features for the first layer and
H above it; then the MoE head's two products a video (`counts.head_flops`).
Elementwise work is not counted.

The least bytes: the uint8 frames read once, every parameter read once
in the configuration's bfloat16, the float32 predictions written once.

Rates and the scan's bound: `portbench/counts.py`'s (the H100 SXM's data
sheet, dense, at 700 W; `counts.bound_ms`, frozen).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench import counts
from portbench.counts import BF16_FLOPS, HBM_BYTES


def layer_widths(flags: Dict) -> List[Tuple[int, int]]:
    """(input width D, units H) of each layer, bottom up."""
    H = flags["lstm_cells"]
    D = sum(int(s) for s in str(flags["feature_sizes"]).split(","))
    return [(D if i == 0 else H, H) for i in range(flags["lstm_layers"])]


def forward_flops(flags: Dict, batch: int) -> int:
    """Model FLOPs of one forward on `batch` videos of `max_num_frames`
    frames at a configuration's flags."""
    rows = batch * flags["max_num_frames"]
    return (sum(2 * rows * (D + H) * 4 * H for D, H in layer_widths(flags))
            + counts.head_flops(flags, batch))


def parameters(flags: Dict) -> int:
    state = flags["lstm_layers"] * 2 * flags["lstm_cells"]
    V, m = flags["num_classes"], flags["moe_num_mixtures"]
    return (sum((D + H) * 4 * H + 4 * H for D, H in layer_widths(flags))
            + state * (2 * m + 1) * V + m * V)


def forward_bytes(flags: Dict, batch: int) -> int:
    features = sum(int(s) for s in str(flags["feature_sizes"]).split(","))
    return (batch * flags["max_num_frames"] * features + 2 * parameters(flags)
            + 4 * batch * flags["num_classes"])


def bound_s(flags: Dict, batch: int) -> float:
    """The least seconds one forward could take: the larger of its FLOPs
    over the bf16 peak and its bytes over the memory rate."""
    return max(forward_flops(flags, batch) / BF16_FLOPS,
               forward_bytes(flags, batch) / HBM_BYTES)


def scan_bound_ms(flags: Dict, batch: int) -> float:
    """The least milliseconds of one call of the bf16 scan kernel on a
    layer: all `max_num_frames` steps of `batch` rows."""
    return counts.bound_ms("lstm_chunk_scan", flags["max_num_frames"], batch,
                           flags["lstm_cells"])
