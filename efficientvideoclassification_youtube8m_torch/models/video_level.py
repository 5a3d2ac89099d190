"""Video-level classifier heads (port of the JAX package's
models/video_level.py): every head of the reference's
video_level_models.py, the MoE head of the flagship and the five
ensemble heads.

Each head is an `nn.Module` whose constructor takes the JAX `init`'s
arguments and draws its weights from `key` as the JAX init does, and
whose `forward` returns "predictions" [B, vocab] and
"regularization_loss" (the slim l2 regularizers of the reference), and
"loss" where the head supplies its own training loss. Only `MoeModel`
multiplies in `compute_dtype`; the others run in float32, as in the JAX
package, and swallow the keywords they do not read.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.models.base import (
    Params,
    dense,
    dense_init,
    dropout,
    gather_classes,
    glorot_uniform,
    head_input,
    l2_loss,
    linear,
    register_model,
)
from efficientvideoclassification_youtube8m_torch.ops import prng


@register_model("MoeModel")
class MoeModel(nn.Module):
    """Per-class softmax mixture of logistic experts (+ one dummy expert).

    gates = FC(input, vocab*(m+1), no bias); experts = FC(input,
    vocab*m). Softmax over the m+1 gates per (batch, class), sigmoid
    experts, prediction = sum of the first m gate*expert products.
    Weights are stored in the JAX layout ``gates.w [D, m+1, V]``,
    ``experts.w [D, m, V]``, ``experts.b [m, V]``.

    Column-parallel under tensor parallelism (`parallel.mesh.shard_module`
    sets `model_shards`): the rank with model index r of k holds the
    classes ``[r V/k, (r+1) V/k)`` of all three, computes their
    predictions (the mixture softmax is over axis 1, so it stays local)
    and gathers the [B, V] predictions; the l2 term is the model group's
    sum of the local ones, and the input's gradient the group's sum.
    """

    column_parallel = True

    def __init__(self, input_size: int, vocab_size: int,
                 num_mixtures: int = 2,
                 key: Optional[prng.Key] = None, device=None,
                 **_):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_mixtures = num_mixtures
        # the JAX init's keys; glorot fan-in/out of the reference's 2-D
        # [D, V*K] layout
        kg, ke = prng.split(key or prng.prng_key(0))
        gates_w = glorot_uniform(
            (input_size, vocab_size * (num_mixtures + 1)), kg, device
        ).reshape(input_size, num_mixtures + 1, vocab_size)
        experts_w = glorot_uniform(
            (input_size, vocab_size * num_mixtures), ke, device
        ).reshape(input_size, num_mixtures, vocab_size)
        self.gates = Params(w=gates_w)
        self.experts = Params(
            w=experts_w,
            b=torch.zeros(num_mixtures, vocab_size, device=device))

    def forward(self, model_input: torch.Tensor, l2_penalty: float = 1e-8,
                compute_dtype: torch.dtype = torch.float32,
                num_mixtures: Optional[int] = None,
                **_) -> Dict[str, Any]:
        if num_mixtures is not None and num_mixtures != self.num_mixtures:
            raise ValueError(f"the module has {self.num_mixtures} mixtures, "
                             f"not {num_mixtures}")
        D = model_input.shape[-1]
        m, V = self.num_mixtures, self.experts.b.shape[-1]  # this rank's classes
        x = head_input(self, model_input).to(compute_dtype)
        gate_act = dense(self.gates.w.reshape(D, -1).to(compute_dtype),
                         x).reshape(-1, m + 1, V)
        expert_act = dense(self.experts.w.reshape(D, -1).to(compute_dtype),
                           x).reshape(-1, m, V) + self.experts.b
        gating = torch.softmax(gate_act, dim=1)  # [B, m+1, V]
        experts = torch.sigmoid(expert_act)  # [B, m, V]
        predictions = torch.sum(gating[:, :m] * experts, dim=1)
        l2 = l2_loss(self.gates.w) + l2_loss(self.experts.w)
        predictions, l2 = gather_classes(self, predictions, l2)
        return {"predictions": predictions, "regularization_loss": l2_penalty * l2}


@register_model("LogisticModel")
class LogisticModel(nn.Module):
    """Sigmoid FC(vocab) with weight l2 (video_level_models.py:375-392);
    column-parallel under tensor parallelism, as `MoeModel`."""

    column_parallel = True

    def __init__(self, input_size: int, vocab_size: int,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        self.fc = dense_init(input_size, vocab_size, key, device)

    def forward(self, model_input, l2_penalty: float = 1e-8, **_):
        out = torch.sigmoid(linear(self.fc, head_input(self, model_input)))
        out, l2 = gather_classes(self, out, l2_loss(self.fc.w))
        return {"predictions": out, "regularization_loss": l2_penalty * l2}


class _HiddenHead(nn.Module):
    """A hidden FC and an output FC, the JAX init's two keys."""

    def __init__(self, input_size: int, vocab_size: int,
                 num_hidden_units: int = 1024,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        k1, k2 = prng.split(key or prng.prng_key(0))
        self.hidden = dense_init(input_size, num_hidden_units, k1, device)
        self.out = dense_init(num_hidden_units, vocab_size, k2, device)

    def _weights_l2(self) -> torch.Tensor:
        return l2_loss(self.hidden.w) + l2_loss(self.out.w)


@register_model("SingleHiddenLayerModel")
class SingleHiddenLayerModel(_HiddenHead):
    """Sigmoid hidden -> sigmoid FC (video_level_models.py:21-45)."""

    def forward(self, model_input, l2_penalty: float = 1e-7, **_):
        hidden = torch.sigmoid(linear(self.hidden, model_input))
        out = torch.sigmoid(linear(self.out, hidden))
        reg = (l2_penalty * self._weights_l2()
               + 1e-4 * l2_loss(self.hidden.b) + 1e-3 * l2_loss(self.out.b))
        return {"predictions": out, "regularization_loss": reg}


@register_model("SingleHiddenLayerModelDropout")
class SingleHiddenLayerModelDropout(_HiddenHead):
    """The same, with keep-prob dropout between the layers
    (video_level_models.py:47-71), drawn from `rng` when one is given."""

    def forward(self, model_input, l2_penalty: float = 1e-8,
                dropout_keep_prob=1.0, rng: Optional[prng.Key] = None, **_):
        hidden = torch.sigmoid(linear(self.hidden, model_input))
        if rng is not None:
            hidden = dropout(hidden, dropout_keep_prob, rng)
        out = torch.sigmoid(linear(self.out, hidden))
        reg = l2_penalty * self._weights_l2() + 1e-4 * l2_loss(self.out.b)
        return {"predictions": out, "regularization_loss": reg}


@register_model("DoubleHiddenLayerModelDropout")
class DoubleHiddenLayerModelDropout(nn.Module):
    """2048-tanh -> dropout -> 1024-sigmoid -> sigmoid FC
    (video_level_models.py:73-96)."""

    def __init__(self, input_size: int, vocab_size: int,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        k1, k2, k3 = prng.split(key or prng.prng_key(0), 3)
        self.hidden1 = dense_init(input_size, 2048, k1, device)
        self.hidden2 = dense_init(2048, 1024, k2, device)
        self.out = dense_init(1024, vocab_size, k3, device)

    def forward(self, model_input, l2_penalty: float = 1e-8,
                dropout_keep_prob=1.0, rng: Optional[prng.Key] = None, **_):
        hidden = torch.tanh(linear(self.hidden1, model_input))
        if rng is not None:
            hidden = dropout(hidden, dropout_keep_prob, rng)
        hidden = torch.sigmoid(linear(self.hidden2, hidden))
        out = torch.sigmoid(linear(self.out, hidden))
        reg = (l2_penalty * (l2_loss(self.hidden1.w) + l2_loss(self.hidden2.w)
                             + l2_loss(self.out.w))
               + 1e-4 * l2_loss(self.out.b))
        return {"predictions": out, "regularization_loss": reg}


# Class-frequency bands of the 4716 YT8M classes and their per-band
# positive/negative CE weights (video_level_models.py:98-167):
# (first class, end class, hidden units, positive weight, negative weight).
_SPLIT_BANDS = (
    (0, 30, 1024, 1.0, 1.0),
    (30, 300, 512, 2.0, 0.25),
    (300, 1500, 256, 4.0, 0.1),
    (1500, 4716, 256, 10.0, 0.01),
)


@register_model("SplitSingleHiddenLayerModel")
class SplitSingleHiddenLayerModel(nn.Module):
    """Four per-frequency-band heads with a model-supplied weighted CE
    loss (needs the 4716-class vocab)."""

    def __init__(self, input_size: int, vocab_size: int,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        if vocab_size != 4716:
            raise ValueError("band boundaries are defined for the 4716-class vocab")
        keys = prng.split(key or prng.prng_key(0), 2 * len(_SPLIT_BANDS))
        for bi, (lo, hi, hid, _, _) in enumerate(_SPLIT_BANDS):
            band = nn.Module()
            band.hidden = dense_init(input_size, hid, keys[2 * bi], device)
            band.out = dense_init(hid, hi - lo, keys[2 * bi + 1], device)
            self.add_module(f"band{bi}", band)

    def forward(self, model_input, labels: Optional[torch.Tensor] = None,
                l2_penalty: float = 1e-7, **_):
        epsilon = 10e-6
        outputs, reg, loss = [], 0.0, 0.0
        float_labels = None if labels is None else labels.to(torch.float32)
        for bi, (lo, hi, _, wpos, wneg) in enumerate(_SPLIT_BANDS):
            band = getattr(self, f"band{bi}")
            hidden = torch.sigmoid(linear(band.hidden, model_input))
            out = torch.sigmoid(linear(band.out, hidden))
            outputs.append(out)
            reg = reg + l2_penalty * (l2_loss(band.hidden.w) + l2_loss(band.out.w))
            if float_labels is not None:
                lab = float_labels[:, lo:hi]
                ce = (wpos * lab * torch.log(out + epsilon)
                      + wneg * (1 - lab) * torch.log(1 - out + epsilon))
                loss = loss + torch.sum(-ce, dim=1)
        result = {"predictions": torch.cat(outputs, dim=1),
                  "regularization_loss": reg}
        if float_labels is not None:
            result["loss"] = torch.mean(loss)
        return result


@register_model("ScaledSingleHiddenLayerModel")
class ScaledSingleHiddenLayerModel(_HiddenHead):
    """A SingleHidden head whose outputs are min-max rescaled per row
    (video_level_models.py:169-197)."""

    def forward(self, model_input, l2_penalty: float = 1e-8, **_):
        hidden = torch.sigmoid(linear(self.hidden, model_input))
        out = torch.sigmoid(linear(self.out, hidden))
        o_max = torch.amax(out, dim=1, keepdim=True)
        o_min = torch.amin(out, dim=1, keepdim=True)
        out = (out - o_min) / (o_max - o_min)
        reg = l2_penalty * self._weights_l2() + 1e-3 * l2_loss(self.out.b)
        return {"predictions": out, "regularization_loss": reg}


@register_model("SingleHiddenLayerResidualModel")
class SingleHiddenLayerResidualModel(nn.Module):
    """Splits the input at 6400 into features and logit-space old
    predictions and adds a tanh residual (video_level_models.py:199-225)."""

    SPLIT = 6400

    def __init__(self, input_size: int, vocab_size: int,
                 num_hidden_units: int = 1024,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        k1, k2 = prng.split(key or prng.prng_key(0))
        self.hidden = dense_init(self.SPLIT, num_hidden_units, k1, device)
        self.out = dense_init(num_hidden_units, vocab_size, k2, device)

    def forward(self, model_input, l2_penalty: float = 1e-8,
                dropout_keep_prob=1.0, rng: Optional[prng.Key] = None, **_):
        old_predictions = model_input[:, self.SPLIT:]
        hidden = torch.sigmoid(linear(self.hidden, model_input[:, :self.SPLIT]))
        if rng is not None:
            hidden = dropout(hidden, dropout_keep_prob, rng)
        residual = torch.tanh(linear(self.out, hidden))
        out = torch.sigmoid(residual + old_predictions)
        reg = (l2_penalty * (l2_loss(self.hidden.w) + l2_loss(self.out.w))
               + 1e-4 * l2_loss(self.out.b))
        return {"predictions": out, "regularization_loss": reg}


# ------------------------------------------------------- ensemble heads
#
# The weight-over-models heads (video_level_models.py:227-373): their
# `vocab_size` is K, the number of models whose predictions
# `old_predictions [B', K, classes]` stacks (B' >= B; the first B rows
# are used).


def _softmax_weighted_blend(weights_logits, old_predictions):
    """Softmax over the K-model axis of `weights_logits [B, K]`, then the
    weighted sum of `old_predictions [B, K, vocab]`."""
    weights = torch.softmax(weights_logits, dim=-1)
    return torch.sum(weights[:, :, None] * old_predictions, dim=1)


@register_model("LinearRegressionEnsemble")
class LinearRegressionEnsemble(nn.Module):
    """Learned per-video softmax weights over K stacked prior predictions
    (video_level_models.py:227-251)."""

    def __init__(self, input_size: int, vocab_size: int,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        self.weights = dense_init(input_size, vocab_size, key, device)

    def forward(self, model_input, old_predictions=None,
                l2_penalty: float = 1e-8, **_):
        old_predictions = old_predictions[: model_input.shape[0]]
        out = _softmax_weighted_blend(linear(self.weights, model_input),
                                      old_predictions)
        return {"predictions": out,
                "regularization_loss": l2_penalty * l2_loss(self.weights.w)}


@register_model("LinearRegressionWeightedMeanEnsemble")
class LinearRegressionWeightedMeanEnsemble(nn.Module):
    """The ensemble blend with a learned sigmoid-alpha mix toward the plain
    mean (video_level_models.py:253-281)."""

    def __init__(self, input_size: int, vocab_size: int,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        self.weights = dense_init(input_size, vocab_size, key, device)
        self.alpha_logit = nn.Parameter(torch.tensor(2.0, device=device))

    def forward(self, model_input, old_predictions=None,
                l2_penalty: float = 1e-8, **_):
        old_predictions = old_predictions[: model_input.shape[0]]
        out = _softmax_weighted_blend(linear(self.weights, model_input),
                                      old_predictions)
        alpha = torch.sigmoid(self.alpha_logit)
        out = out * (1 - alpha) + torch.mean(old_predictions, dim=1) * alpha
        return {"predictions": out,
                "regularization_loss": l2_penalty * l2_loss(self.weights.w)}


@register_model("LinearRegressionWeightedMeanEnsembleDifferenceLoss")
class LinearRegressionWeightedMeanEnsembleDifferenceLoss(
        LinearRegressionWeightedMeanEnsemble):
    """The WeightedMean blend plus a top-20-masked margin loss, a [B,
    vocab] matrix that training sums (video_level_models.py:283-317).
    Without labels (inference) only the predictions are computed."""

    def forward(self, model_input, old_predictions=None, labels=None,
                l2_penalty: float = 1e-8, **_):
        result = super().forward(model_input, old_predictions=old_predictions,
                                 l2_penalty=l2_penalty)
        if labels is not None:
            out = result["predictions"]
            mean_pred = torch.mean(old_predictions[: model_input.shape[0]], dim=1)
            fl = labels.to(torch.float32)
            loss = -(out - mean_pred) * fl + (out - mean_pred) * (1 - fl)
            values = torch.topk(out, 20, dim=1).values[:, 19]
            mask = (out >= values[:, None]).to(torch.float32)
            result["loss"] = loss * mask
        return result


@register_model("IndependentClassEnsemble")
class IndependentClassEnsemble(nn.Module):
    """A per-(model, class) softmax weight table over the K-model axis
    (video_level_models.py:319-344)."""

    def __init__(self, input_size: int, vocab_size: int,
                 num_classes: int = 4716,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        self.weights = nn.Parameter(
            torch.ones(vocab_size, num_classes, device=device))

    def forward(self, model_input, old_predictions=None, **_):
        old_predictions = old_predictions[: model_input.shape[0]]
        mask = (old_predictions > 0).to(torch.float32)
        weights = torch.softmax(mask * self.weights[None, :, :], dim=1)
        out = torch.sum(weights * old_predictions, dim=1)
        return {"predictions": out,
                "regularization_loss": torch.zeros((), device=out.device)}


@register_model("SingleHiddenLayerEnsemble")
class SingleHiddenLayerEnsemble(nn.Module):
    """512-sigmoid hidden -> softmax weights over K old predictions
    (video_level_models.py:346-373)."""

    def __init__(self, input_size: int, vocab_size: int,
                 key: Optional[prng.Key] = None, device=None, **_):
        super().__init__()
        k1, k2 = prng.split(key or prng.prng_key(0))
        self.hidden = dense_init(input_size, 512, k1, device)
        self.weights = dense_init(512, vocab_size, k2, device)

    def forward(self, model_input, old_predictions=None,
                l2_penalty: float = 1e-8, **_):
        old_predictions = old_predictions[: model_input.shape[0]]
        hidden = torch.sigmoid(linear(self.hidden, model_input))
        out = _softmax_weighted_blend(linear(self.weights, hidden),
                                      old_predictions)
        reg = l2_penalty * (l2_loss(self.hidden.w) + l2_loss(self.weights.w))
        return {"predictions": out, "regularization_loss": reg}
