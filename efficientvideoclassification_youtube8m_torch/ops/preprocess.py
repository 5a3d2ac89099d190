"""Input preprocessing ops (port of the JAX package's ops/preprocess.py).

Same semantics as the JAX functions of the same names: the host hands
over RAW uint8 features and these run on the serving device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def dequantize(
    feat: torch.Tensor,
    max_quantized_value: float = 2.0,
    min_quantized_value: float = -2.0,
) -> torch.Tensor:
    """Map byte-quantized features back to floats:
    ``x * (range/255) + (range/512 + min)``, in float32."""
    if max_quantized_value <= min_quantized_value:
        raise ValueError("max_quantized_value must exceed min_quantized_value")
    quantized_range = max_quantized_value - min_quantized_value
    scalar = quantized_range / 255.0
    bias = (quantized_range / 512.0) + min_quantized_value
    return feat.to(torch.float32) * scalar + bias


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 epsilon: float = 1e-12) -> torch.Tensor:
    """`tf.nn.l2_normalize` semantics: x * rsqrt(max(sum(x^2), eps))."""
    sq = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=epsilon))


def uniform_subsample(x: torch.Tensor, every_n: int, dim: int = 1
                      ) -> torch.Tensor:
    """Keep frames [0, every_n, 2*every_n, ...] along `dim` (a view)."""
    index = [slice(None)] * x.dim()
    index[dim] = slice(None, None, every_n)
    return x[tuple(index)]


def host_subsample(features_u8, every_n: int) -> np.ndarray:
    """HOST-side every-n frame stride on the raw uint8 batch, applied
    before the device transfer so student paths move 1/every_n of the
    bytes. Contiguous, because contiguity matters for the transfer."""
    return np.ascontiguousarray(np.asarray(features_u8)[:, ::every_n])


def student_num_frames(num_frames: torch.Tensor, every_n: int,
                       max_frames: int = 300) -> torch.Tensor:
    """`num_frames/300 * (300//every_n)` cast to int, as the reference
    computes it: in FLOAT64 before the truncating cast. A float32
    recompute is off by one for many (num_frames, every_n) pairs, so the
    answer comes from a float64 table indexed by the capped frame count
    (int32, on `num_frames`' device)."""
    max_student = max_frames // every_n
    table = (np.arange(max_frames + 1, dtype=np.float64) / max_frames
             * max_student).astype(np.int64).astype(np.int32)
    table = torch.from_numpy(table).to(num_frames.device)
    idx = torch.clamp(num_frames.to(torch.int64), 0, max_frames)
    return table[idx]


def resize_axis(x: torch.Tensor, dim: int, new_size: int,
                fill_value: Any = 0) -> torch.Tensor:
    """Truncate or pad `x` with `fill_value` along `dim` to `new_size`
    (pad at the end)."""
    old = x.shape[dim]
    if old == new_size:
        return x
    if old > new_size:
        return torch.narrow(x, dim, 0, new_size)
    pad_shape = list(x.shape)
    pad_shape[dim] = new_size - old
    pad = torch.full(pad_shape, fill_value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=dim)
