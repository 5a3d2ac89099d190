"""Model registry and shared helpers (port of the JAX package's
models/base.py).

The reference selects models by flag string; here the same strings
resolve through an explicit registry of `nn.Module` classes. A model's
constructor takes the JAX `init`'s arguments (plus `key` and `device`)
and draws the JAX init's weights from `key`; its `forward` returns a
dict with "predictions" [B, vocab] and "regularization_loss", like the
JAX `apply`, and optionally "loss" (a model-supplied training loss) and
"updated_stats" (batch-norm moving statistics to write back after the
optimizer update).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.ops.collectives import (
    copy_to_model,
    gather_columns,
    reduce_from_model,
)

MODEL_REGISTRY: Dict[str, Any] = {}


def register_model(name: str, frame_level: bool = False) -> Callable:
    """Register a model class under the flag string `name`. A
    `frame_level` model takes [B, T, D] frames and `num_frames`; the
    others take [B, D] video-level features. Both become attributes of
    the class (`name`, `frame_level`)."""
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        cls.name = name
        cls.frame_level = frame_level
        return cls

    return deco


def get_model(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        ) from None


def glorot_uniform(shape, key: Optional[prng.Key] = None,
                   device=None) -> torch.Tensor:
    """slim.fully_connected's default weight init (uniform Xavier) over
    the 2-D fan-in/fan-out ``shape[0], shape[1]``, drawn from `key` as
    the JAX `glorot_uniform` draws it (key (0, 0) when None)."""
    fan_in, fan_out = shape[0], shape[1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return prng.uniform(key or prng.prng_key(0), shape, -limit, limit, device)


class Params(nn.Module):
    """A named group of parameters, so that `state_dict` keys follow the
    JAX pytree paths ("gates.w", "experts.b", ...)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, value in tensors.items():
            self.register_parameter(name, nn.Parameter(value))


def dense_init(in_dim: int, out_dim: int, key: Optional[prng.Key] = None,
               device=None, use_bias: bool = True) -> Params:
    """The JAX `dense_init`: a glorot-uniform ``w [in, out]`` drawn from
    `key` and a zero ``b [out]``."""
    tensors = {"w": glorot_uniform((in_dim, out_dim), key, device)}
    if use_bias:
        tensors["b"] = torch.zeros(out_dim, device=device)
    return Params(**tensors)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The JAX `dense(p, x)` of a `dense_init` group."""
    return dense(p.w, x, getattr(p, "b", None))


def dense(w: torch.Tensor, x: torch.Tensor, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """``x @ w (+ b)`` over the last axis with a float32 result. Operands
    of a lower precision are multiplied on their exact values in float32,
    so the sum is accumulated and returned unrounded, as
    ``preferred_element_type=float32`` does; float64 operands stay
    float64."""
    acc = torch.promote_types(torch.promote_types(x.dtype, w.dtype), torch.float32)
    y = torch.matmul(x.to(acc), w.to(acc))
    if b is not None:
        y = y + b
    return y


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """`tf.nn.l2_loss`: sum(x**2) / 2."""
    return 0.5 * torch.sum(torch.square(x))


def dropout(x: torch.Tensor, keep_prob, key: prng.Key) -> torch.Tensor:
    """`tf.nn.dropout` with keep-prob semantics, the JAX `dropout`: kept
    units scaled by 1/keep_prob, the mask ``bernoulli(key, keep_prob)``
    drawn as `jax.random` draws it. `keep_prob` is a float or a 0-d
    tensor, used in float32."""
    keep = torch.as_tensor(keep_prob, dtype=torch.float32)
    mask = prng.batch_uniform(key, x.shape, 0.0, 1.0, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def head_input(head: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A column-parallel head's input: `x`, whose gradient is summed over
    the head's model group when the head is sharded (each rank's classes
    give a part of it)."""
    shards = getattr(head, "model_shards", None)
    return x if shards is None else copy_to_model(x, shards)


def gather_classes(head: nn.Module, predictions: torch.Tensor,
                   l2: torch.Tensor):
    """A column-parallel head's [B, V] predictions and whole l2 term from
    this rank's classes (`gather_columns` and `reduce_from_model` over
    its model group, `parallel.mesh.shard_module`); as they are when the
    head is not sharded."""
    shards = getattr(head, "model_shards", None)
    if shards is None:
        return predictions, l2
    return gather_columns(predictions, shards), reduce_from_model(l2, shards)
