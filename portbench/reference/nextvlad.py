"""The plain reference of NeXtVLAD (Lin, Xiao & Fan, NeXtVLAD: An Efficient
Neural Network to Aggregate Frame-level Features for Large-scale Video
Classification, ECCV 2018 Workshops, arXiv:1811.05014; the authors'
`nextvlad.py`) at inference, in plain PyTorch, float32 with TF32 off.

It imports nothing of the program. Parameters are a dict of tensors under
the program's names: for each branch (``video``, ``audio``)
``<branch>.expand.w`` [D, E] and ``.b``, ``.attention.w`` [E, G] and
``.b``, ``.cluster.w`` [E, G K], ``.cluster_bn.*``, ``.centers`` [F, K]
(F = E / G), ``.vlad_bn.*``; then ``hidden.w`` [codes, H],
``hidden_bn.*``, ``gate1.w`` [H, H / r], ``gate_bn.*``, ``gate2.w``
[H / r, H], and the logistic head ``classifier.fc.w`` [H, V] and ``.b``.
A batch norm's leaves are ``scale``, ``offset``, ``moving_mean`` and
``moving_var``. The widths are read from the shapes.

One branch, for frames x [T, D] and the true-frame mask m [T]:

* x~ = x W_e + b_e; alpha[t, g] = sigmoid(x~ W_a + b_a)[t, g] m[t];
* s[t, g, :] = softmax over K of BN(x~ W_c)[t, g K : (g + 1) K];
* a = s alpha; v[f, k] = sum_{t,g} a[t, g, k] x~[t, g F + f]
  - c[f, k] sum_{t,g} a[t, g, k];
* v l2-normalised over f for each k, flattened as [F, K], then BN.

The codes of the two branches are concatenated; h = BN(vlad W_h), then
the context gate h sigmoid(relu(BN(h W_g1)) W_g2), then sigmoid(h W_fc
+ b_fc). Batch norm at inference: (x - moving_mean) / sqrt(moving_var +
1e-3) scale + offset (slim's epsilon).

Departures from the authors' code:

* The input is the port's: uint8 frames dequantised to [-2, 2],
  l2-normalised per frame over all the features, padding frames zero
  (`model.preprocess`).
* The true-frame count is the eval binaries' (`model.student_input`):
  int(num_frames / max_frames x (max_frames // every_n)) in float64,
  which at every_n 1 is one frame short at 12 lengths (55, 79, 97, 110,
  123, 158, 171, 194, 207, 220, 233, 246); the authors' mask counts
  every true frame.
* Inference only: no dropout, the batch norms' moving statistics.
* The aggregation is written as one product for each video.

Every product goes through `prec.mm(x, w)`, so that a lower precision
(the control) can be put in its place; `PLAIN` is float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import model as ref_model
from portbench.reference.model import PLAIN, Params, Precision

BN_EPS = 1e-3
BRANCHES = ("video", "audio")


def batch_norm(params: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """The batch norm `name` at inference over the last axis of x."""
    mean, var = params[f"{name}.moving_mean"], params[f"{name}.moving_var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * params[f"{name}.scale"] + params[f"{name}.offset"]


def branch(params: Params, name: str, x: torch.Tensor, mask: torch.Tensor,
           prec: Precision = PLAIN) -> torch.Tensor:
    """One feature's code [B, F K] from its frames x [B, T, D] and the mask
    [B, T]."""
    B, T, D = x.shape
    F, K = params[f"{name}.centers"].shape
    wide = prec.mm(x.reshape(B * T, D), params[f"{name}.expand.w"]) + params[f"{name}.expand.b"]
    G = wide.shape[1] // F
    alpha = torch.sigmoid(prec.mm(wide, params[f"{name}.attention.w"])
                          + params[f"{name}.attention.b"]) * mask.reshape(B * T, 1)
    logits = batch_norm(params, f"{name}.cluster_bn", prec.mm(wide, params[f"{name}.cluster.w"]))
    a = (torch.softmax(logits.reshape(B * T, G, K), dim=2) * alpha[:, :, None]).reshape(B, T * G, K)
    xg = wide.reshape(B, T * G, F)
    v = torch.stack([prec.mm(a[b].transpose(0, 1), xg[b]) for b in range(B)])  # [B, K, F]
    v = v.transpose(1, 2) - a.sum(dim=1)[:, None, :] * params[f"{name}.centers"]  # [B, F, K]
    v = v / torch.sqrt(torch.clamp((v * v).sum(dim=1, keepdim=True), min=1e-12))
    return batch_norm(params, f"{name}.vlad_bn", v.reshape(B, F * K))


def forward(params: Params, x: torch.Tensor, num_frames: torch.Tensor,
            feature_sizes, prec: Precision = PLAIN) -> Dict[str, torch.Tensor]:
    """The model on preprocessed frames x [B, T, sum(feature_sizes)] with
    true lengths num_frames [B]: {"hidden" (after the gate), "predictions"}."""
    T = x.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :] < num_frames[:, None]).to(x.dtype)
    split = int(feature_sizes[0])
    vlad = torch.cat([branch(params, "video", x[:, :, :split], mask, prec),
                      branch(params, "audio", x[:, :, split:], mask, prec)], dim=1)
    h = batch_norm(params, "hidden_bn", prec.mm(vlad, params["hidden.w"]))
    g = torch.relu(batch_norm(params, "gate_bn", prec.mm(h, params["gate1.w"])))
    h = h * torch.sigmoid(prec.mm(g, params["gate2.w"]))
    pred = torch.sigmoid(prec.mm(h, params["classifier.fc.w"]) + params["classifier.fc.b"])
    return {"hidden": h, "predictions": pred}


def predictions(params: Params, frames_u8: torch.Tensor, num_frames: torch.Tensor,
                cfg: Dict, prec: Precision = PLAIN) -> torch.Tensor:
    """The predictions [B, V] for uint8 frames [B, max_frames, D] and the
    videos' true lengths, under a configuration file's flags `cfg`."""
    x, nf = ref_model.student_input(frames_u8, num_frames.to(torch.int64),
                                    cfg["every_n"], cfg["max_num_frames"])
    sizes = [int(s) for s in str(cfg["feature_sizes"]).split(",")]
    return forward(params, x, nf, sizes, prec)["predictions"]
