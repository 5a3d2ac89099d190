"""Fused int8 LSTM layer scan: the CUDA kernel's wrapper and its plain
PyTorch version (port of the JAX package's ops/pallas/lstm_scan.py
`_lstm_chunk_kernel_int8`, called through `lstm_chunk_scan_pallas_int8`).

Layout is time-major ([T, B, ...]) like the TPU kernel's. The input
projection (an int8 product, ops/quantize.int8_dot) stays outside the
kernel; the per-row quantization of h, the int8 recurrent product, the
rescale, the gate math and the masking run in the kernel
(ops/csrc/lstm_chunk_scan_int8.cu).

`lstm_chunk_scan_int8` takes its plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from efficientvideoclassification_youtube8m_torch.ops.kernels import _build
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_scan import (
    check_scan_inputs,
)

_LIB_NAME = "lstm_chunk_scan_int8"


def row_scale(x: torch.Tensor) -> torch.Tensor:
    """The symmetric per-row int8 scale ``max(max|x| / 127, 1e-12)`` over
    the last axis (kept), in f32. The division is a true quotient on every
    device: PyTorch's CUDA division by a Python scalar multiplies by the
    scalar's reciprocal, which can land an ulp away, so the divisor is a
    tensor on the device."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    divisor = torch.full((), 127.0, dtype=amax.dtype, device=amax.device)
    return torch.clamp(amax / divisor, min=1e-12).to(torch.float32)


def lstm_chunk_scan_int8_reference(
    x_proj_tm: torch.Tensor,  # [T, B, 4H] bf16 (dequantized x @ Wx, no bias)
    wh_q: torch.Tensor,  # [H, 4H] int8
    wh_scale: torch.Tensor,  # [4H]
    bias: torch.Tensor,  # [4H]
    seq_len: torch.Tensor,  # [B] int
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the TPU kernel's numerics:
    h is carried in f32 and quantized per row each step (round half to
    even of the true quotient, clip to +-127); the int8 product is exact
    (taken in float64 on the int8 values: |acc| < 2**53) and then rounded
    to f32 as the int32 sum would be; gates are ``(f32(xp) + bias) +
    (f32(acc) * h_scale) * wh_scale``. Returns (outs bf16 [T, B, H], final
    c f32 [B, H], final h f32 [B, H])."""
    T, B, G = x_proj_tm.shape
    H = G // 4
    dev = x_proj_tm.device
    w = wh_q.to(torch.float64)
    ws = wh_scale.to(torch.float32)
    b = bias.to(torch.float32)
    seq = seq_len.to(device=dev, dtype=torch.int32)
    c = torch.zeros(B, H, dtype=torch.float32, device=dev)
    h = torch.zeros(B, H, dtype=torch.float32, device=dev)
    outs = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
    for t in range(T):
        h_scale = row_scale(h)
        h_q = torch.clamp(torch.round(h / h_scale), -127, 127)
        acc = (h_q.to(torch.float64) @ w).to(torch.float32)
        gates = (x_proj_tm[t].to(torch.bfloat16).to(torch.float32) + b
                 + acc * h_scale * ws)
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        new_c = (c * torch.sigmoid(f + forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        valid = (t < seq)[:, None]
        c = torch.where(valid, new_c, c)
        h = torch.where(valid, new_h, h)
        outs[t] = torch.where(valid, new_h, 0.0)
    return outs, c, h


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.lstm_chunk_scan_int8
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lstm_chunk_scan_int8_error_string.argtypes = [ctypes.c_int]
    lib.lstm_chunk_scan_int8_error_string.restype = ctypes.c_char_p


def load_kernel() -> ctypes.CDLL:
    """Build ops/csrc/lstm_chunk_scan_int8.cu (at its first use in a
    checkout) and load it."""
    return _build.load_library(_LIB_NAME, _declare)


def lstm_chunk_scan_int8(
    x_proj_tm: torch.Tensor,  # [T, B, 4H] bf16, time-major
    wh_q: torch.Tensor,  # [H, 4H] int8
    wh_scale: torch.Tensor,  # [4H] (cast to f32)
    bias: torch.Tensor,  # [4H] (cast to f32)
    seq_len: torch.Tensor,  # [B] integer
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused int8 T-step LSTM layer scan (time-major IO). Returns
    (outputs bf16 [T,B,H], final_c f32 [B,H], final_h f32 [B,H]).

    On CUDA tensors this launches ops/csrc/lstm_chunk_scan_int8.cu (two
    launches a step on the current stream, no synchronisation) and adds
    one to `lstm_chunk_scan_int8.launches`; on CPU tensors it runs
    `lstm_chunk_scan_int8_reference`. Anything the kernel does not take
    raises. Like `lstm_chunk_scan` it is forward-only: with grad mode on
    and an input that requires grad it raises."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj_tm, wh_scale, bias)):
        raise RuntimeError(
            "lstm_chunk_scan_int8 is forward-only and records no gradient; "
            "call it under torch.no_grad()")
    T, B, H = check_scan_inputs(x_proj_tm, wh_q, bias, seq_len,
                                w_dtype=torch.int8)
    dev = x_proj_tm.device
    if tuple(wh_scale.shape) != (4 * H,):
        raise ValueError(f"wh_scale must be [{4 * H}], got {tuple(wh_scale.shape)}")
    if not wh_scale.is_floating_point():
        raise TypeError("wh_scale must be floating point")
    if wh_scale.device != dev:
        raise ValueError(f"wh_scale is on {wh_scale.device}, x_proj_tm on {dev}")
    if dev.type == "cpu":
        return lstm_chunk_scan_int8_reference(x_proj_tm, wh_q, wh_scale, bias,
                                              seq_len, forget_bias)

    ws = wh_scale.to(torch.float32)
    b = bias.to(torch.float32)
    seq = seq_len.to(torch.int32)
    for name, tensor in (("x_proj_tm", x_proj_tm), ("wh_q", wh_q),
                         ("wh_scale", ws), ("bias", b), ("seq_len", seq)):
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
    c = torch.zeros(B, H, dtype=torch.float32, device=dev)
    h = torch.zeros(2, B, H, dtype=torch.float32, device=dev)  # ping-pong
    if T == 0 or B == 0:
        return outs, c, h[0]
    h_q = torch.empty(B, H, dtype=torch.int8, device=dev)
    h_scale = torch.empty(B, dtype=torch.float32, device=dev)

    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_chunk_scan_int8(
            x_proj_tm.data_ptr(), wh_q.data_ptr(), ws.data_ptr(), b.data_ptr(),
            seq.data_ptr(), outs.data_ptr(), c.data_ptr(), h.data_ptr(),
            h_q.data_ptr(), h_scale.data_ptr(), T, B, H, float(forget_bias),
            stream)
    if err != 0:
        msg = lib.lstm_chunk_scan_int8_error_string(err).decode()
        raise RuntimeError(f"lstm_chunk_scan_int8 kernel launch failed: {msg} ({err})")
    lstm_chunk_scan_int8.launches += 1
    return outs, c, h[T % 2]


lstm_chunk_scan_int8.launches = 0
