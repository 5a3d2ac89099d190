"""int8 quantized inference path (port of the JAX package's
ops/quantize.py).

A weight+activation int8 forward for the flagship HierarchicalLstm
student (and teacher):

  * weights: per-output-channel symmetric int8 (separate scales for the
    LSTM kernels' x-rows and h-rows, and per column of the MoE gates and
    experts);
  * activations: dynamic per-row symmetric int8;
  * products: int8 x int8 -> int32 (`torch._int_mm`), rescaled to f32;
    all gate, softmax and sigmoid math stays f32.

Scales are ``max(amax / 127, 1e-12)`` with a true quotient, and values
round half to even, as `jnp.round` does. The stacked recurrence runs as
a plain scan (`quantized_multi_lstm_scan`) or through the int8 CUDA
kernel per layer (`quantized_multi_lstm_scan_fused`, ops/kernels/
lstm_scan_int8.py). Exposed through `serving.Predictor(...,
quantize="int8")` and `train.step.build_quantized_eval_step`.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_scan_int8 import (
    lstm_chunk_scan_int8,
    row_scale,
)

Tensors = Dict[str, torch.Tensor]


def _weight_scale(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Symmetric per-output-channel scale: amax over the reduction axis."""
    return row_scale(w.movedim(axis, -1))[..., 0]


def quantize_weight(w: torch.Tensor, axis: int = 0):
    """(int8 values, f32 scales) of `w`, one scale per slice along every
    axis but `axis`."""
    scale = _weight_scale(w, axis)
    q = torch.clamp(torch.round(w / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def _row_quant(x: torch.Tensor):
    """Dynamic per-row (last-axis) int8 activation quantization."""
    scale = row_scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int_mm_layout(w_q: torch.Tensor) -> torch.Tensor:
    """An int8 weight [K, N] stored column-major (the transposed view of a
    contiguous [N, K]): the layout in which `int_mm` hands it to cuBLASLt
    without a copy. The values, and so the tests' comparisons, are those
    of `w_q`."""
    return w_q.t().contiguous().t()


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact, through
    `torch._int_mm`. On CUDA it takes a row-major `a` and a column-major
    `b` (cuBLASLt's int8 layout: with both row-major it refused K = 32 and
    48 on an H100), M > 16, and K and N padded to multiples of 16 (the MoE
    gates have N = 3 * 4716): the operands are padded with zeros and the
    result is sliced. It never falls back to a float product."""
    if a.device.type == "cuda":
        M, K = a.shape
        N = b.shape[1]
        pad_m, pad_k, pad_n = max(17 - M, 0), -K % 16, -N % 16
        if pad_m or pad_k:
            a = F.pad(a, (0, pad_k, 0, pad_m))
        b_t = b.t()  # [N, K]; contiguous when `b` has the int_mm layout
        if pad_k or pad_n:
            b_t = F.pad(b_t, (0, pad_k, 0, pad_n))
        return torch._int_mm(a.contiguous(), b_t.contiguous().t())[:M, :N]
    return torch._int_mm(a.contiguous(), b)


def int8_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor
             ) -> torch.Tensor:
    """f32 activations [..., D] x int8 weights [D, N] -> f32 [..., N]
    through an int8 x int8 -> int32 product."""
    x_q, x_scale = _row_quant(x)
    y = int_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    y = y.reshape(*x.shape[:-1], w_q.shape[-1])
    return y.to(torch.float32) * x_scale * w_scale


# --- parameters ----------------------------------------------------------

def _get(node: Any, key: str) -> Any:
    """A child of a JAX-layout tree (dicts and lists) or of a module."""
    return node[key] if isinstance(node, dict) else getattr(node, key)


def _tensor(value: Any, device) -> torch.Tensor:
    """A parameter as a tensor on `device` (None: where it is), detached."""
    t = value.detach() if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.array(value))
    return t if device is None else t.to(device)


# --- LSTM ----------------------------------------------------------------

def quantize_lstm_cell(cell: Any, input_size: int, device=None) -> Tensors:
    """Split the TF-layout kernel [D+H, 4H] at the x/h row boundary and
    quantize each block per column: the two products run separately and
    see different input ranges. `cell` is a `BasicLSTMCell` or a JAX
    ``{"kernel", "bias"}`` dict."""
    kernel = _tensor(_get(cell, "kernel"), device)
    wx_q, wx_s = quantize_weight(kernel[:input_size])
    # wh_q stays row-major [H, 4H], as the int8 kernel reads it
    wh_q, wh_s = quantize_weight(kernel[input_size:])
    return {
        "wx_q": int_mm_layout(wx_q), "wx_scale": wx_s,
        "wh_q": wh_q, "wh_scale": wh_s,
        "bias": _tensor(_get(cell, "bias"), device).to(torch.float32),
    }


def _quantized_lstm_layer_scan(qp: Tensors, xs: torch.Tensor,
                               seq_len: torch.Tensor,
                               forget_bias: float = 1.0):
    """One layer with both products on the int8 path; gate math and
    carries stay f32. Returns (outputs f32 [B, T, H], final c, final h)."""
    B, T, _ = xs.shape
    H = qp["wx_q"].shape[-1] // 4
    bias = qp["bias"]
    # [B, T, 4H], stored bf16 between the hoisted product and the scan,
    # like the bf16 path
    x_proj = int8_dot(xs.to(torch.float32), qp["wx_q"], qp["wx_scale"])
    x_proj = x_proj.to(torch.bfloat16)

    seq = seq_len.to(device=xs.device, dtype=torch.int32)
    c = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
    h = torch.zeros(B, H, dtype=torch.float32, device=xs.device)
    outs = torch.empty(B, T, H, dtype=torch.float32, device=xs.device)
    for t in range(T):
        gates = int8_dot(h, qp["wh_q"], qp["wh_scale"])
        gates = gates + x_proj[:, t].to(torch.float32) + bias
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        new_c = (c * torch.sigmoid(f + forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        valid = (t < seq)[:, None]
        c = torch.where(valid, new_c, c)
        h = torch.where(valid, new_h, h)
        outs[:, t] = torch.where(valid, new_h, 0.0)
    return outs, c, h


def quantized_multi_lstm_scan(qparams: List[Tensors], xs: torch.Tensor,
                              seq_len: torch.Tensor,
                              forget_bias: float = 1.0) -> torch.Tensor:
    """Stacked dynamic_rnn on the int8 path (f32 inter-layer outputs);
    returns the [c0, h0, c1, h1, ...] state layout."""
    state_parts = []
    layer_in = xs
    for qp in qparams:
        outs, c_fin, h_fin = _quantized_lstm_layer_scan(
            qp, layer_in, seq_len, forget_bias)
        state_parts.extend([c_fin, h_fin])
        layer_in = outs
    return torch.cat(state_parts, dim=-1)


def quantized_multi_lstm_scan_fused(qparams: List[Tensors], xs: torch.Tensor,
                                    seq_len: torch.Tensor,
                                    forget_bias: float = 1.0) -> torch.Tensor:
    """Stacked int8 LSTM with the int8 kernel per layer (the counterpart
    of the JAX `quantized_multi_lstm_scan_pallas`): the recurrent int8
    product and the gate math run in the kernel, the input projection
    stays outside as one int8 product, and the inter-layer outputs are
    bf16. The kernel masks a ragged batch itself, so there is no fall-back
    to the scan for a B without a tile."""
    layer_in = xs.transpose(0, 1)  # [T, B, D] time-major
    state_parts = []
    for qp in qparams:
        x_proj = int8_dot(layer_in.to(torch.float32), qp["wx_q"],
                          qp["wx_scale"]).to(torch.bfloat16)  # [T, B, 4H]
        outs, c_fin, h_fin = lstm_chunk_scan_int8(
            x_proj, qp["wh_q"], qp["wh_scale"], qp["bias"], seq_len,
            forget_bias=forget_bias)
        state_parts.extend([c_fin, h_fin])
        layer_in = outs
    return torch.cat(state_parts, dim=-1)


# --- MoE classifier ------------------------------------------------------

def quantize_moe(params: Any, device=None) -> Tensors:
    """The [D, K, V]-layout MoE head (a `MoeModel` or a JAX tree):
    quantize the flattened [D, K*V] kernels per column."""
    gates_w = _tensor(_get(_get(params, "gates"), "w"), device)
    experts = _get(params, "experts")
    experts_w = _tensor(_get(experts, "w"), device)
    D = gates_w.shape[0]
    gq, gs = quantize_weight(gates_w.reshape(D, -1))
    eq, es = quantize_weight(experts_w.reshape(D, -1))
    return {
        "gates_q": int_mm_layout(gq), "gates_scale": gs,
        "experts_q": int_mm_layout(eq), "experts_scale": es,
        "experts_b": _tensor(_get(experts, "b"), device).to(torch.float32),
    }


def quantized_moe_apply(qp: Tensors, state: torch.Tensor, vocab_size: int,
                        num_mixtures: int) -> torch.Tensor:
    gate_act = int8_dot(state, qp["gates_q"], qp["gates_scale"]).reshape(
        -1, num_mixtures + 1, vocab_size)
    expert_act = int8_dot(state, qp["experts_q"], qp["experts_scale"]).reshape(
        -1, num_mixtures, vocab_size) + qp["experts_b"]
    gating = torch.softmax(gate_act, dim=1)
    experts = torch.sigmoid(expert_act)
    return torch.sum(gating[:, :num_mixtures] * experts, dim=1)


# --- full student/teacher forward ----------------------------------------

@torch.no_grad()
def quantize_hierarchical_params(params: Any, input_size: int,
                                 lstm_cells: int, lstm_layers: int,
                                 device=None) -> Dict[str, Any]:
    """A `HierarchicalLstmModel` (or its JAX-layout tree) -> the int8
    parameter tree ``{"rnn_l1": [cell...], "rnn_l2": [...],
    "classifier": {...}}``, on `device` (when None: the module's device,
    or the CPU for a tree). Layer 0 of each level consumes the level
    input; deeper layers consume h [cells]."""
    state_dim = lstm_layers * 2 * lstm_cells

    def level(cells, in_size):
        sizes = [in_size] + [lstm_cells] * (len(cells) - 1)
        return [quantize_lstm_cell(c, s, device) for c, s in zip(cells, sizes)]

    return {
        "rnn_l1": level(_get(params, "rnn_l1"), input_size),
        "rnn_l2": level(_get(params, "rnn_l2"), state_dim),
        "classifier": quantize_moe(_get(params, "classifier"), device),
    }


@torch.no_grad()
def quantized_hierarchical_forward(
    qparams: Dict[str, Any], model_input: torch.Tensor,
    num_frames: torch.Tensor, num_chunks: int, vocab_size: int,
    num_mixtures: int, use_kernel: bool = False,
) -> torch.Tensor:
    """`HierarchicalLstmModel.forward` with every product on the int8
    path. Inference only (no dropout, no losses); returns predictions
    [B, vocab]. `use_kernel` runs each layer's recurrence through the int8
    CUDA kernel (its plain version on CPU tensors)."""
    B, T, D = model_input.shape
    if T % num_chunks:
        raise ValueError(f"{T} frames do not split into {num_chunks} chunks")
    chunk_len = T // num_chunks
    scan = quantized_multi_lstm_scan_fused if use_kernel else quantized_multi_lstm_scan

    x_chunks = model_input.reshape(B * num_chunks, chunk_len, D)
    chunk_starts = chunk_len * torch.arange(
        num_chunks, dtype=torch.int32, device=model_input.device)
    seq_l1 = torch.clamp(
        num_frames.to(torch.int32)[:, None] - chunk_starts[None, :],
        0, chunk_len,
    ).reshape(B * num_chunks)
    l1_state = scan(qparams["rnn_l1"], x_chunks, seq_l1)

    l2_input = l1_state.reshape(B, num_chunks, -1)
    seq_l2 = torch.ceil(
        num_frames.to(torch.float32) / float(chunk_len)).to(torch.int32)
    state = scan(qparams["rnn_l2"], l2_input, seq_l2)
    return quantized_moe_apply(qparams["classifier"], state, vocab_size,
                               num_mixtures)
