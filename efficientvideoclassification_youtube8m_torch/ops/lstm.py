"""TF1-semantics LSTM in plain PyTorch (port of the JAX package's
ops/lstm.py).

The math of the reference's `BasicLSTMCell(forget_bias=1.0,
state_is_tuple=False)` in a `MultiRNNCell` driven by `dynamic_rnn`:

  * gate pre-activations ``[x, h] @ kernel + bias`` split i, j, f, o;
  * ``new_c = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)``,
    ``new_h = tanh(new_c) * sigmoid(o)``;
  * for steps ``t >= seq_len`` the state is frozen and the output is 0;
  * the multi-layer state is ``[c0, h0, c1, h1, ...]``.

The input projection ``x @ Wx`` is hoisted out of the time loop, and the
layers run one after the other over the whole sequence. This module is
the plain oracle the CUDA kernel (ops/kernels/lstm_scan.py) is held to,
and the path every non-bf16 or CPU forward takes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class BasicLSTMCell(nn.Module):
    """Parameters of one cell in the JAX (and TF) layout:
    ``kernel [input_size + num_units, 4 * num_units]``, ``bias [4 * num_units]``.
    Glorot-uniform kernel (TF1.3 `_linear` default), zero bias."""

    def __init__(self, input_size: int, num_units: int,
                 generator: Optional[torch.Generator] = None,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        fan_in = input_size + num_units
        fan_out = 4 * num_units
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        kernel = torch.empty(fan_in, fan_out, dtype=torch.float32)
        kernel.uniform_(-limit, limit, generator=generator)
        self.kernel = nn.Parameter(kernel.to(device=device, dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros(fan_out, device=device, dtype=dtype))


def init_basic_lstm_cell(generator: Optional[torch.Generator],
                         input_size: int, num_units: int, device=None,
                         dtype: torch.dtype = torch.float32) -> BasicLSTMCell:
    return BasicLSTMCell(input_size, num_units, generator, device, dtype)


def init_multi_lstm(generator: Optional[torch.Generator], input_size: int,
                    num_units: int, num_layers: int, device=None,
                    dtype: torch.dtype = torch.float32) -> nn.ModuleList:
    """Stack of cells; layer 0 consumes the input, deeper layers consume h."""
    sizes = [input_size] + [num_units] * (num_layers - 1)
    return nn.ModuleList(
        init_basic_lstm_cell(generator, s, num_units, device, dtype)
        for s in sizes)


def lstm_cell_step(params: BasicLSTMCell, x: torch.Tensor, c: torch.Tensor,
                   h: torch.Tensor, forget_bias: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One unmasked BasicLSTMCell step."""
    gates = torch.cat([x, h], dim=-1) @ params.kernel + params.bias
    i, j, f, o = torch.chunk(gates, 4, dim=-1)
    new_c = c * torch.sigmoid(f + forget_bias) + torch.sigmoid(i) * torch.tanh(j)
    new_h = torch.tanh(new_c) * torch.sigmoid(o)
    return new_c, new_h


def _lstm_layer_scan(
    params: BasicLSTMCell,
    xs: torch.Tensor,  # [B, T, D]
    seq_len: torch.Tensor,  # [B] int
    forget_bias: float,
    compute_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer over a full sequence with dynamic_rnn masking.

    Returns (outputs [B, T, H], final_c [B, H], final_h [B, H]).

    Precision follows the JAX scan: f32/f64 add the bias into the hoisted
    projection; bf16 stores the projection in bf16, re-adds the bias in
    f32 inside the step, multiplies bf16(h) by bf16 Wh with f32
    accumulation (the bf16 values carried exactly in f32), and stacks
    the outputs in bf16.
    """
    B, T, D = xs.shape
    H = params.kernel.shape[-1] // 4
    acc_dtype = torch.float64 if compute_dtype == torch.float64 else torch.float32
    low_precision = compute_dtype == torch.bfloat16
    w_x = params.kernel[:D].to(compute_dtype)
    w_h = params.kernel[D:].to(compute_dtype).to(acc_dtype)
    bias = params.bias.to(acc_dtype)

    x_proj = torch.matmul(xs.to(compute_dtype), w_x)
    if not low_precision:
        x_proj = x_proj.to(acc_dtype) + bias

    seq_len = seq_len.to(device=xs.device, dtype=torch.int32)
    c = torch.zeros(B, H, dtype=acc_dtype, device=xs.device)
    h = torch.zeros(B, H, dtype=acc_dtype, device=xs.device)
    outs = torch.empty(B, T, H, device=xs.device,
                       dtype=compute_dtype if low_precision else acc_dtype)
    for t in range(T):
        if low_precision:
            gates = h.to(compute_dtype).to(acc_dtype) @ w_h
            gates = gates + x_proj[:, t].to(acc_dtype) + bias
        else:
            gates = h @ w_h + x_proj[:, t]
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        new_c = (c * torch.sigmoid(f + forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        valid = (t < seq_len)[:, None]
        c = torch.where(valid, new_c, c)
        h = torch.where(valid, new_h, h)
        outs[:, t] = torch.where(valid, new_h, 0.0)
    return outs, c, h


def multi_lstm_scan(
    params: Sequence[BasicLSTMCell],
    xs: torch.Tensor,  # [B, T, D]
    seq_len: torch.Tensor,  # [B]
    forget_bias: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    return_outputs: bool = False,
):
    """Stacked-LSTM `dynamic_rnn` over a full sequence.

    Returns the final state ``[c0, h0, c1, h1, ...]`` of shape
    [B, num_layers * 2H] and, with `return_outputs`, the top layer's
    per-step outputs [B, T, H].
    """
    state_parts = []
    layer_in = xs
    outs = None
    for layer_params in params:
        outs, c_fin, h_fin = _lstm_layer_scan(
            layer_params, layer_in, seq_len, forget_bias, compute_dtype)
        state_parts.extend([c_fin, h_fin])
        layer_in = outs
    final_state = torch.cat(state_parts, dim=-1)
    if return_outputs:
        return final_state, outs
    return final_state
