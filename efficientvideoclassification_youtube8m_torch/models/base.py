"""Model registry and shared helpers (port of the JAX package's
models/base.py).

The reference selects models by flag string; here the same strings
resolve through an explicit registry of `nn.Module` classes. A model's
`forward` returns a dict with "predictions" [B, vocab] and
"regularization_loss", like the JAX `apply`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from efficientvideoclassification_youtube8m_torch.ops import prng

MODEL_REGISTRY: Dict[str, Any] = {}


def register_model(name: str) -> Callable:
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        cls.name = name
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


def dense(w: torch.Tensor, x: torch.Tensor, b: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """``x @ w (+ b)`` over the last axis with a float32 result. Operands
    of a lower precision are multiplied on their exact values in float32,
    so the sum is accumulated and returned unrounded, as
    ``preferred_element_type=float32`` does."""
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if b is not None:
        y = y + b
    return y


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    """`tf.nn.l2_loss`: sum(x**2) / 2."""
    return 0.5 * torch.sum(torch.square(x))
