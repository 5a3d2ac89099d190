"""The plain reference of Gated NetVLAD (Miech, Laptev & Sivic, Learnable
pooling with Context Gating for video classification, arXiv:1706.06905;
the authors' github.com/antoine77340/Youtube-8M-WILLOW, `NetVLADModelLF`
and `NetVLAD` in `frame_level_models.py`, `willow_MoeModel` in
`video_level_models.py`) at inference, in plain PyTorch, float32 with
TF32 off, at the README's Gated NetVLAD flags (`netvlad_cluster_size`
256, `netvlad_hidden_size` 1024, `netvlad_relu` False, `gating` True,
`moe_prob_gating` True, `netvlad_add_batch_norm` and `moe_num_mixtures`
at their defaults, True and 2).

It imports nothing of the program. Parameters are a dict of tensors under
the program's names (Willow's variable in brackets): ``input_bn.*``
[input_bn]; for each branch (``video``, ``audio``) ``<branch>.cluster.w``
[D, K] [cluster_weights], ``.cluster_bn.*`` [cluster_bn] and
``.centers`` [D, K] [cluster_weights2]; ``hidden.w`` [codes, H]
[hidden1_weights] and ``hidden.b`` [hidden1_biases]; ``gate.w`` [H, H]
[gating_weights_2] and ``gate_bn.*`` [gating_bn]; the MoE head's
``classifier.gates.w`` [H, mixtures + 1, V] [gates], ``.experts.w`` [H,
mixtures, V] and ``.experts.b`` [experts]; ``prob_gate.w`` [V, V]
[gating_prob_weights] and ``prob_gate_bn.*`` [gating_prob_bn]. A batch
norm's leaves are ``scale``, ``offset``, ``moving_mean`` and
``moving_var``. The widths are read from the shapes.

`NetVLADModelLF.create_model`, line by line, for frames x [B, T, 1152]
and the true-frame mask m [B, T]:

* ``reshaped_input = slim.batch_norm(reshaped_input, scope="input_bn")``:
  the input batch norm over every frame row's 1152 features;
* ``video_NetVLAD = NetVLAD(1024, max_frames, cluster_size, ...)``,
  ``audio_NetVLAD = NetVLAD(128, max_frames, cluster_size/2, ...)``; each
  ``forward`` on its slice of the features, 0-1023 and 1024-1151;
* ``vlad = tf.concat([vlad_video, vlad_audio], 1)``;
* ``activation = tf.matmul(vlad, hidden1_weights)``; with
  `netvlad_relu` False ``activation += hidden1_biases`` and no batch norm
  or relu6;
* `gating`: ``gates = tf.matmul(activation, gating_weights_2)``,
  ``slim.batch_norm(gates, scope="gating_bn")``, ``tf.sigmoid``,
  ``activation = tf.multiply(activation, gates)``;
* the head, `willow_MoeModel`: ``gate_activations`` (no bias) and
  ``expert_activations`` of ``vocab_size x (num_mixtures + 1)`` and
  ``x num_mixtures``, a softmax over the mixtures + 1 gates and sigmoid
  experts a class, ``probabilities`` the sum of the first
  ``num_mixtures`` products (`model.moe`); `moe_prob_gating` with its
  input 'prob': ``gates = tf.matmul(probabilities, gating_weights)``,
  ``slim.batch_norm(gates, scope="gating_prob_bn")``, ``tf.sigmoid``,
  ``probabilities = tf.multiply(probabilities, gates)``.

`NetVLAD.forward`, for one branch's rows x [B T, D]:

* ``activation = tf.matmul(reshaped_input, cluster_weights)``,
  ``slim.batch_norm(activation, scope="cluster_bn")``,
  ``tf.nn.softmax(activation)`` over the K clusters;
* ``a_sum = tf.reduce_sum(activation, -2, keep_dims=True)`` over the
  frames, ``a = tf.multiply(a_sum, cluster_weights2)`` [B, D, K];
* ``vlad = tf.matmul(activation^T, reshaped_input)`` transposed to [B, D,
  K], ``vlad = tf.subtract(vlad, a)``;
* ``vlad = tf.nn.l2_normalize(vlad, 1)`` over D for each cluster,
  ``tf.reshape(vlad, [-1, cluster_size * feature_size])`` in [D, K]
  order, ``tf.nn.l2_normalize(vlad, 1)`` over the whole code
  (``x / sqrt(max(sum(x^2), 1e-12))``).

Batch norm at inference: (x - moving_mean) / sqrt(moving_var + 1e-3)
scale + offset (slim's epsilon).

Departures from the authors' code:

* Willow draws `iterations` (300) frames uniformly with replacement
  (``utils.SampleRandomFrames``), at eval too, and sums over the draws;
  here the sums run over every true frame, masked (the assignment of a
  padding frame is 0). The sum over the true frames is the expectation
  of the sum over the draws, up to a factor a video (300 / frames) that
  the intra-normalisation removes, and it is deterministic.
* The input is the port's (`model.preprocess`): uint8 frames dequantised
  to [-2, 2], l2-normalised per frame over all the features, padding
  frames zero.
* The true-frame count is the eval binaries' (`lstm.lengths`, divided
  on the host in float64), which at every_n 1 is one frame short at 12
  lengths; Willow's `num_frames` counts every true frame.
* Inference only: the batch norms' moving statistics.
* The aggregation is written as one product for each video.

Every product goes through `prec.mm(x, w)`, so that a lower precision
(the control) can be put in its place; `PLAIN` is float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import model as ref_model
from portbench.reference.lstm import lengths
from portbench.reference.model import PLAIN, Params, Precision
from portbench.reference.nextvlad import batch_norm

BRANCHES = ("video", "audio")


def l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`tf.nn.l2_normalize(x, dim)`."""
    return x / torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=True), min=1e-12))


def branch(params: Params, name: str, x: torch.Tensor, mask: torch.Tensor,
           prec: Precision = PLAIN) -> torch.Tensor:
    """One feature's code [B, D K] from its batch-normed frames x [B, T, D]
    and the mask [B, T]."""
    B, T, D = x.shape
    K = params[f"{name}.centers"].shape[1]
    logits = batch_norm(params, f"{name}.cluster_bn",
                        prec.mm(x.reshape(B * T, D), params[f"{name}.cluster.w"]))
    a = torch.softmax(logits, dim=1).reshape(B, T, K) * mask[:, :, None]
    v = torch.stack([prec.mm(a[b].transpose(0, 1), x[b]) for b in range(B)])  # [B, K, D]
    v = v.transpose(1, 2) - a.sum(dim=1)[:, None, :] * params[f"{name}.centers"]  # [B, D, K]
    return l2_normalize(l2_normalize(v, 1).reshape(B, D * K), 1)


def gate(params: Params, name: str, x: torch.Tensor, prec: Precision = PLAIN
         ) -> torch.Tensor:
    """Willow's gate: x sigmoid(BN(x W)), W at `name`.w, BN at `name`_bn."""
    return x * torch.sigmoid(batch_norm(params, f"{name}_bn", prec.mm(x, params[f"{name}.w"])))


def forward(params: Params, x: torch.Tensor, num_frames: torch.Tensor,
            feature_sizes, prec: Precision = PLAIN) -> Dict[str, torch.Tensor]:
    """The model on preprocessed frames x [B, T, sum(feature_sizes)] with
    true lengths num_frames [B]: {"hidden" (after the context gate),
    "predictions"}."""
    T = x.shape[1]
    mask = (torch.arange(T, device=x.device)[None, :] < num_frames[:, None]).to(x.dtype)
    x = batch_norm(params, "input_bn", x)
    split = int(feature_sizes[0])
    vlad = torch.cat([branch(params, "video", x[:, :, :split], mask, prec),
                      branch(params, "audio", x[:, :, split:], mask, prec)], dim=1)
    h = prec.mm(vlad, params["hidden.w"]) + params["hidden.b"]
    h = gate(params, "gate", h, prec)
    p = ref_model.moe(params, h, prec)[0]
    p = gate(params, "prob_gate", p, prec)
    return {"hidden": h, "predictions": p}


def predictions(params: Params, frames_u8: torch.Tensor, num_frames: torch.Tensor,
                cfg: Dict, prec: Precision = PLAIN) -> torch.Tensor:
    """The predictions [B, V] for uint8 frames [B, max_frames, D] (or
    already strided to every_n) and the videos' true lengths, under a
    configuration file's flags `cfg`."""
    every_n, max_frames = cfg["every_n"], cfg["max_num_frames"]
    if frames_u8.shape[1] == max_frames:
        frames_u8 = frames_u8[:, ::every_n]
    nf = lengths(num_frames, every_n, max_frames)
    sizes = [int(s) for s in str(cfg["feature_sizes"]).split(",")]
    return forward(params, ref_model.preprocess(frames_u8, nf), nf, sizes, prec)["predictions"]
