"""NeXtVLAD's leaves from the seed, under the program's names
(`portbench/reference/nextvlad.py` lists them), made on the device by one
torch generator in one uniform draw: every kernel glorot-uniform over its
2-D fan, every bias zero (the port's initialisation of its dense layers;
the authors' is a variance-scaling one), and each batch norm's
statistics away from the identity, so that a batch norm left out
changes the answer: scale on [0.5, 1.5], offset on [-0.5, 0.5], moving
mean on [-s/2, s/2] and moving variance on [s^2/2, 2 s^2], where s is
the spread its input would have under these kernels, frames of unit
norm spread evenly over the features, and unit-spread codes after each
earlier batch norm. The program and the reference are each handed the
same numbers: the reference draws them again from the same seed on the
same device."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import weights as weights_lib
from portbench.reference.model import glorot_limit

Leaf = Tuple[str, Tuple[int, ...], float, float]  # name, shape, uniform on [lo, hi]


def branches(flags: Dict, widths: Dict) -> List[Tuple[str, int, int, int]]:
    """(name, features D, clusters K, groups G) of the two branches: the
    audio branch takes half of the clusters and of the groups."""
    video, audio = (int(s) for s in str(flags["feature_sizes"]).split(","))
    K, G = widths["vlad_clusters"], widths["groups"]
    return [("video", video, K, G), ("audio", audio, K // 2, G // 2)]


def _glorot(name: str, fan_in: int, fan_out: int) -> Leaf:
    lim = glorot_limit(fan_in, fan_out)
    return (name, (fan_in, fan_out), -lim, lim)


def _glorot_var(fan_in: int, fan_out: int) -> float:
    """The variance of a glorot-uniform kernel's entries."""
    return 2.0 / (fan_in + fan_out)


def _bn(name: str, dim: int, var: float) -> List[Leaf]:
    s = var ** 0.5
    return [(f"{name}.scale", (dim,), 0.5, 1.5), (f"{name}.offset", (dim,), -0.5, 0.5),
            (f"{name}.moving_mean", (dim,), -s / 2, s / 2),
            (f"{name}.moving_var", (dim,), var / 2, 2 * var)]


def leaves(flags: Dict, widths: Dict) -> List[Leaf]:
    """Every leaf of the model at a configuration's flags and its
    "nextvlad" widths."""
    total = sum(int(s) for s in str(flags["feature_sizes"]).split(","))
    E_of = widths["expansion"]
    out: List[Leaf] = []
    codes = 0
    for name, D, K, G in branches(flags, widths):
        E = E_of * D
        F = E // G
        # a frame of unit norm spread evenly: |x|^2 = D / total
        wide_var = D / total * _glorot_var(D, E)
        out += [_glorot(f"{name}.expand.w", D, E), (f"{name}.expand.b", (E,), 0.0, 0.0),
                _glorot(f"{name}.attention.w", E, G), (f"{name}.attention.b", (G,), 0.0, 0.0),
                _glorot(f"{name}.cluster.w", E, G * K)]
        out += _bn(f"{name}.cluster_bn", G * K, E * wide_var * _glorot_var(E, G * K))
        out.append(_glorot(f"{name}.centers", F, K))
        out += _bn(f"{name}.vlad_bn", F * K, 1.0 / F)  # l2 over F: entries near 1/sqrt(F)
        codes += F * K
    H = widths["hidden_size"]
    S = H // widths["gating_reduction"]
    out.append(_glorot("hidden.w", codes, H))
    out += _bn("hidden_bn", H, codes * _glorot_var(codes, H))
    out.append(_glorot("gate1.w", H, S))
    out += _bn("gate_bn", S, H * _glorot_var(H, S))
    out.append(_glorot("gate2.w", S, H))
    V = flags["num_classes"]
    out += [_glorot("classifier.fc.w", H, V), ("classifier.fc.b", (V,), 0.0, 0.0)]
    return out


def draw(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves (float32) of a configuration file `config` (its "flags"
    and "nextvlad" widths) from the seed: one uniform draw for all of
    them, sliced and scaled."""
    spec = leaves(config["flags"], config["nextvlad"])
    g = weights_lib.generator(seed, device)
    total = sum(int(torch.Size(shape).numel()) for _, shape, lo, hi in spec if hi > lo)
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, lo, hi in spec:
        n = int(torch.Size(shape).numel())
        if hi > lo:
            out[name] = lo + flat[off:off + n].view(shape) * (hi - lo)
            off += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
