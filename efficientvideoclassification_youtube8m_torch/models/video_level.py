"""Video-level classifier heads (port of the JAX package's
models/video_level.py). Only `MoeModel`, the flagship's head, so far."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.models.base import (
    dense,
    glorot_uniform,
    l2_loss,
    register_model,
)


class _Weights(nn.Module):
    """A named group of parameters, so that `state_dict` keys follow the
    JAX pytree paths ("gates.w", "experts.b", ...)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, value in tensors.items():
            self.register_parameter(name, nn.Parameter(value))


@register_model("MoeModel")
class MoeModel(nn.Module):
    """Per-class softmax mixture of logistic experts (+ one dummy expert).

    gates = FC(input, vocab*(m+1), no bias); experts = FC(input,
    vocab*m). Softmax over the m+1 gates per (batch, class), sigmoid
    experts, prediction = sum of the first m gate*expert products.
    Weights are stored in the JAX layout ``gates.w [D, m+1, V]``,
    ``experts.w [D, m, V]``, ``experts.b [m, V]``.
    """

    def __init__(self, input_size: int, vocab_size: int,
                 num_mixtures: int = 2,
                 generator: Optional[torch.Generator] = None, device=None,
                 **_):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_mixtures = num_mixtures
        # glorot fan-in/out of the reference's 2-D [D, V*K] layout
        gates_w = glorot_uniform(
            (input_size, vocab_size * (num_mixtures + 1)), generator
        ).reshape(input_size, num_mixtures + 1, vocab_size)
        experts_w = glorot_uniform(
            (input_size, vocab_size * num_mixtures), generator
        ).reshape(input_size, num_mixtures, vocab_size)
        self.gates = _Weights(w=gates_w.to(device))
        self.experts = _Weights(
            w=experts_w.to(device),
            b=torch.zeros(num_mixtures, vocab_size, device=device))

    def forward(self, model_input: torch.Tensor, l2_penalty: float = 1e-8,
                compute_dtype: torch.dtype = torch.float32,
                num_mixtures: Optional[int] = None,
                **_) -> Dict[str, Any]:
        if num_mixtures is not None and num_mixtures != self.num_mixtures:
            raise ValueError(f"the module has {self.num_mixtures} mixtures, "
                             f"not {num_mixtures}")
        D = model_input.shape[-1]
        m, V = self.num_mixtures, self.vocab_size
        x = model_input.to(compute_dtype)
        gate_act = dense(self.gates.w.reshape(D, -1).to(compute_dtype),
                         x).reshape(-1, m + 1, V)
        expert_act = dense(self.experts.w.reshape(D, -1).to(compute_dtype),
                           x).reshape(-1, m, V) + self.experts.b
        gating = torch.softmax(gate_act, dim=1)  # [B, m+1, V]
        experts = torch.sigmoid(expert_act)  # [B, m, V]
        predictions = torch.sum(gating[:, :m] * experts, dim=1)
        reg = l2_penalty * (l2_loss(self.gates.w) + l2_loss(self.experts.w))
        return {"predictions": predictions, "regularization_loss": reg}
