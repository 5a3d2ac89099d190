"""Gated NetVLAD's leaves from the seed, under the program's names
(`portbench/reference/gated_netvlad.py` lists them), made on the device
by one torch generator in one uniform draw.

They stand for a trained model, so that every part of the mathematics
moves the predictions:

* each kernel followed by a batch norm (the cluster logits', the two
  gates') glorot-uniform over its 2-D fan, and each batch norm's
  statistics away from the identity (`weights_vlad`'s rule): scale on
  [0.5, 1.5], offset on [-0.5, 0.5], moving mean on [-s/2, s/2] and
  moving variance on [s^2/2, 2 s^2], where s is the spread its input
  would have here (frames of unit norm spread evenly over the features;
  unit-spread features after the input batch norm and at the hidden
  FC's output; probabilities of about 1/3);
* each kernel that no batch norm follows (the hidden FC, the MoE's gates
  and experts) uniform with the variance that gives its outputs unit
  spread over these inputs, as a trained model's activations have. At
  glorot's scale the 278,528 x 1,024 FC would put its outputs at about
  0.003 and the MoE's logits at about 1e-3, every prediction at about
  1/3, and a fault before the head would move the predictions less than
  bf16's rounding of them. (Willow's own initialiser, normal with stddev
  1/sqrt(clusters), puts them at 0.06 and 0.01.)
* the cluster centers uniform on [-1, 1], the spread of the batch-normed
  features among which a trained model's centers lie (Willow's
  initialiser, normal with stddev 1/sqrt(D), leaves them near 0, where
  the centers' term would hardly move the code);
* every bias uniform on [-0.5, 0.5].

The program and the reference are each handed the same numbers: the
reference draws them again from the same seed on the same device."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench import weights as weights_lib
from portbench.weights_vlad import Leaf, _bn, _glorot, _glorot_var

PROBABILITY = 1.0 / 3.0  # about what the MoE's predictions read here
GATE_SQUARE = 0.3  # about E[sigmoid(z)^2] for z of unit spread about an offset


def branches(flags: Dict, widths: Dict) -> List[Tuple[str, int, int]]:
    """(name, features D, clusters K) of the two branches: the audio
    branch takes half of the clusters."""
    video, audio = (int(s) for s in str(flags["feature_sizes"]).split(","))
    K = widths["vlad_clusters"]
    return [("video", video, K), ("audio", audio, K // 2)]


def _unit(name: str, shape: Tuple[int, ...], fan_in: int, square: float) -> Leaf:
    """A kernel whose products over `fan_in` inputs of mean square
    `square` have unit spread."""
    lim = math.sqrt(3.0 / (fan_in * square))
    return (name, shape, -lim, lim)


def leaves(flags: Dict, widths: Dict) -> List[Leaf]:
    """Every leaf of the model at a configuration's flags and its
    "gnetvlad" widths."""
    total = sum(int(s) for s in str(flags["feature_sizes"]).split(","))
    out: List[Leaf] = list(_bn("input_bn", total, 1.0 / total))
    codes = 0
    for name, D, K in branches(flags, widths):
        out.append(_glorot(f"{name}.cluster.w", D, K))
        out += _bn(f"{name}.cluster_bn", K, D * _glorot_var(D, K))
        out.append((f"{name}.centers", (D, K), -1.0, 1.0))
        codes += D * K
    H, V, m = widths["hidden_size"], flags["num_classes"], flags["moe_num_mixtures"]
    # the code has unit norm: its entries' mean square is 1 / codes
    out += [_unit("hidden.w", (codes, H), codes, 1.0 / codes), ("hidden.b", (H,), -0.5, 0.5)]
    out.append(_glorot("gate.w", H, H))
    out += _bn("gate_bn", H, H * _glorot_var(H, H))
    out += [_unit("classifier.gates.w", (H, m + 1, V), H, GATE_SQUARE),
            _unit("classifier.experts.w", (H, m, V), H, GATE_SQUARE),
            ("classifier.experts.b", (m, V), -0.5, 0.5)]
    out.append(_glorot("prob_gate.w", V, V))
    out += _bn("prob_gate_bn", V, V * PROBABILITY ** 2 * _glorot_var(V, V))
    return out


def draw(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves (float32) of a configuration file `config` (its "flags"
    and "gnetvlad" widths) from the seed: one uniform draw for all of
    them, sliced and scaled."""
    spec = leaves(config["flags"], config["gnetvlad"])
    g = weights_lib.generator(seed, device)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, lo, hi in spec:
        n = math.prod(shape)
        out[name] = lo + flat[off:off + n].view(shape) * (hi - lo)
        off += n
    return out
