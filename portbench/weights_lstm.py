"""The LSTM baseline's leaves from the seed, under the program's names
(`portbench/reference/lstm.py` lists them), made on the device by one
torch generator in one uniform draw: every kernel glorot-uniform over its
2-D fan (the starter's initialisation of its LSTM cells and MoE head),
the forget-gate quarter of each LSTM bias uniform on FORGET_BIAS and its
input-gate quarter the negative of it, every other bias zero. The
program and the reference are each handed the same numbers: the
reference draws them again from the same seed on the same device.

The gate biases stand for a trained LSTM's long memory. With zero biases
the forget gate reads sigmoid(1 + ~0.02) = 0.73 and the state keeps a
frame for about three steps, so the final state would hold only the
clip's last few frames. At FORGET_BIAS, plus the cell's forget bias of
1.0, the forget gates read 0.95-0.99 and a frame's weight in the state
halves over 14-100 steps, so the whole 300-step chain reaches the head.
The input gate closes as the forget gate opens (the coupling of Tallec &
Ollivier's chrono initialisation, arXiv:1804.11188), which keeps each
step's map of the state contractive: with the input gate at 0.5 and
glorot recurrent kernels a forget gate near 1 makes the chain chaotic,
and float32 and bf16 runs of it part by up to 0.6 in a prediction."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import weights as weights_lib
from portbench.reference.model import glorot_limit

FORGET_BIAS = (2.0, 4.0)


def leaves(flags: Dict) -> List[weights_lib.Leaf]:
    """(name, shape, glorot limit; 0 for zeros) of every leaf at a
    configuration's flags; the LSTM biases' gate quarters are `draw`'s."""
    H, n = flags["lstm_cells"], flags["lstm_layers"]
    D = sum(int(s) for s in str(flags["feature_sizes"]).split(","))
    state = n * 2 * H
    V, m = flags["num_classes"], flags["moe_num_mixtures"]
    out: List[weights_lib.Leaf] = []
    for i in range(n):
        fan_in = (D if i == 0 else H) + H
        out += [(f"rnn.{i}.kernel", (fan_in, 4 * H), glorot_limit(fan_in, 4 * H)),
                (f"rnn.{i}.bias", (4 * H,), 0.0)]
    out += [("classifier.gates.w", (state, m + 1, V), glorot_limit(state, V * (m + 1))),
            ("classifier.experts.w", (state, m, V), glorot_limit(state, V * m)),
            ("classifier.experts.b", (m, V), 0.0)]
    return out


def draw(flags: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves (float32) at a configuration's flags from the seed: one
    uniform draw for all of the kernels and then each layer's forget-gate
    biases, sliced and scaled (gates i, j, f, o: f the third quarter of a
    bias, i the first)."""
    spec = leaves(flags)
    H, n = flags["lstm_cells"], flags["lstm_layers"]
    g = weights_lib.generator(seed, device)
    total = sum(int(torch.Size(shape).numel()) for _, shape, lim in spec if lim)
    flat = torch.rand(total + n * H, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, lim in spec:
        k = int(torch.Size(shape).numel())
        if lim:
            out[name] = (flat[off:off + k].view(shape) * 2 - 1) * lim
            off += k
        else:
            out[name] = torch.zeros(shape, device=device)
    lo, hi = FORGET_BIAS
    for i in range(n):
        forget = lo + (hi - lo) * flat[off:off + H]
        off += H
        out[f"rnn.{i}.bias"][2 * H:3 * H] = forget
        out[f"rnn.{i}.bias"][:H] = -forget
    return out
