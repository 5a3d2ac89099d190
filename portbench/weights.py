"""Weights from the seed, made on the device by one torch generator in one
large draw a tower: every kernel glorot-uniform over its 2-D fan (the
published initialisation), every bias zero. The program and the
reference are each handed the same numbers: the reference draws them
again from the same seed on the same device."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.model import glorot_limit

Leaf = Tuple[str, Tuple[int, ...], float]  # name, shape, glorot limit (0: zeros)


def tower_leaves(cfg: Dict) -> List[Leaf]:
    """The hierarchical model's leaves under the published names."""
    H, layers = cfg["lstm_cells"], cfg["lstm_layers"]
    D = sum(int(s) for s in str(cfg["feature_sizes"]).split(","))
    state = layers * 2 * H
    V, m = cfg["num_classes"], cfg["moe_num_mixtures"]
    leaves: List[Leaf] = []
    for level, width in (("rnn_l1", D), ("rnn_l2", state)):
        for i in range(layers):
            fan_in = (width if i == 0 else H) + H
            leaves.append((f"{level}.{i}.kernel", (fan_in, 4 * H),
                           glorot_limit(fan_in, 4 * H)))
            leaves.append((f"{level}.{i}.bias", (4 * H,), 0.0))
    leaves.append(("classifier.gates.w", (state, m + 1, V),
                   glorot_limit(state, V * (m + 1))))
    leaves.append(("classifier.experts.w", (state, m, V), glorot_limit(state, V * m)))
    leaves.append(("classifier.experts.b", (m, V), 0.0))
    return leaves


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed & (2 ** 63 - 1))


def draw_tower(cfg: Dict, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One tower's leaves (float32) from `g`: one uniform draw for all of
    its kernels, sliced and scaled."""
    leaves = tower_leaves(cfg)
    total = sum(int(torch.Size(shape).numel()) for _, shape, lim in leaves if lim)
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, lim in leaves:
        n = int(torch.Size(shape).numel())
        if lim:
            out[name] = (flat[off:off + n].view(shape) * 2 - 1) * lim
            off += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def draw(cfg: Dict, towers: Tuple[str, ...], seed: int, device
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The towers' leaves, drawn in order ("teacher" before "student")."""
    g = generator(seed, device)
    return {t: draw_tower(cfg, g, device) for t in towers}
