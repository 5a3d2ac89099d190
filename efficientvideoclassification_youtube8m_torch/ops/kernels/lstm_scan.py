"""Fused bf16 LSTM layer scan: the CUDA kernel's wrapper and its plain
PyTorch version (port of the JAX package's ops/pallas/lstm_scan.py
inference kernel, `lstm_chunk_scan_pallas` / `multi_lstm_scan_pallas`).

Layout is time-major ([T, B, ...]) like the TPU kernel's. The input
projection ``x @ Wx`` stays outside the kernel as one bf16 matmul;
``h @ Wh``, the gate math and the masking run in the kernel
(ops/csrc/lstm_chunk_scan.cu).

`lstm_chunk_scan` takes its plain version only for tensors on the CPU.
For a CUDA tensor it launches the kernel or raises. The kernel takes any
hidden size: the wrapper zero-pads H to a multiple of 8 (16-byte bf16
rows for TMA; `layout.tma_width`) and slices the outputs back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from efficientvideoclassification_youtube8m_torch.ops.kernels import _build, layout

_LIB_NAME = "lstm_chunk_scan"


def lstm_chunk_scan_reference(
    x_proj_tm: torch.Tensor,  # [T, B, 4H] (x @ Wx, no bias)
    w_h: torch.Tensor,  # [H, 4H]
    bias: torch.Tensor,  # [4H]
    seq_len: torch.Tensor,  # [B] int
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the TPU kernel's
    numerics: h is carried in f32 and rounded to bf16 before the product,
    which is taken in f32 on the bf16 values (f32 accumulation, no bf16
    rounding of the sum); gates are ``(f32(xp) + bias) + h @ Wh``.
    Returns (outs bf16 [T, B, H], final c f32 [B, H], final h f32 [B, H])."""
    T, B, G = x_proj_tm.shape
    H = G // 4
    dev = x_proj_tm.device
    w = w_h.to(torch.bfloat16).to(torch.float32)
    b = bias.to(torch.float32)
    seq = seq_len.to(device=dev, dtype=torch.int32)
    c = torch.zeros(B, H, dtype=torch.float32, device=dev)
    h = torch.zeros(B, H, dtype=torch.float32, device=dev)
    outs = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
    for t in range(T):
        gates = (x_proj_tm[t].to(torch.bfloat16).to(torch.float32) + b
                 + h.to(torch.bfloat16).to(torch.float32) @ w)
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
    fn = lib.lstm_chunk_scan_bf16
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lstm_chunk_scan_error_string.argtypes = [ctypes.c_int]
    lib.lstm_chunk_scan_error_string.restype = ctypes.c_char_p


def load_kernel() -> ctypes.CDLL:
    """Build ops/csrc/lstm_chunk_scan.cu (at its first use in a checkout)
    and load it."""
    return _build.load_library(_LIB_NAME, _declare)


def check_scan_inputs(x_proj_tm: torch.Tensor, w_h: torch.Tensor,
                      bias: torch.Tensor, seq_len: torch.Tensor,
                      w_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[int, int, int]:
    """The shape, dtype and device checks that the forward recurrence
    kernels share. `w_h` must have `w_dtype` where given (the int8 scan),
    else be floating point. Returns (T, B, H)."""
    if x_proj_tm.dim() != 3 or x_proj_tm.shape[-1] % 4:
        raise ValueError(f"x_proj_tm must be [T, B, 4H], got {tuple(x_proj_tm.shape)}")
    T, B, G = x_proj_tm.shape
    H = G // 4
    if tuple(w_h.shape) != (H, G):
        raise ValueError(f"w_h must be [{H}, {G}], got {tuple(w_h.shape)}")
    if tuple(bias.shape) != (G,):
        raise ValueError(f"bias must be [{G}], got {tuple(bias.shape)}")
    if tuple(seq_len.shape) != (B,):
        raise ValueError(f"seq_len must be [{B}], got {tuple(seq_len.shape)}")
    if x_proj_tm.dtype != torch.bfloat16:
        raise TypeError(f"x_proj_tm must be bfloat16, got {x_proj_tm.dtype}")
    if w_dtype is not None:
        if w_h.dtype != w_dtype:
            raise TypeError(f"w_h must be {w_dtype}, got {w_h.dtype}")
    elif not w_h.is_floating_point():
        raise TypeError("w_h must be floating point")
    if not bias.is_floating_point():
        raise TypeError("bias must be floating point")
    if seq_len.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"seq_len must be int32 or int64, got {seq_len.dtype}")
    dev = x_proj_tm.device
    for name, tensor in (("w_h", w_h), ("bias", bias), ("seq_len", seq_len)):
        if tensor.device != dev:
            raise ValueError(f"{name} is on {tensor.device}, x_proj_tm on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the LSTM kernels run on cpu or cuda, not {dev.type}")
    return T, B, H


def lstm_chunk_scan(
    x_proj_tm: torch.Tensor,  # [T, B, 4H] bf16, time-major (x @ Wx, no bias)
    w_h: torch.Tensor,  # [H, 4H] (any float dtype; cast to bf16)
    bias: torch.Tensor,  # [4H] (cast to f32)
    seq_len: torch.Tensor,  # [B] integer
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused T-step LSTM layer scan (time-major IO). Returns
    (outputs bf16 [T,B,H], final_c f32 [B,H], final_h f32 [B,H]).

    On CUDA tensors this launches ops/csrc/lstm_chunk_scan.cu (T step
    launches on the current stream, no synchronisation) and adds one to
    `lstm_chunk_scan.launches`; on CPU tensors it runs
    `lstm_chunk_scan_reference`. Anything the kernel does not take
    raises.

    The scan is forward-only: it records no autograd graph. So that the
    LSTM parameters can never silently get no gradient, a call with grad
    mode on and an input that requires grad raises on either device;
    training goes through ops/kernels/lstm_train.py."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_proj_tm, w_h, bias)):
        raise RuntimeError(
            "lstm_chunk_scan is forward-only and records no gradient; call "
            "it under torch.no_grad(), or train through "
            "ops.kernels.lstm_train (LstmLayerTrain, "
            "multi_lstm_scan_train_fused)")
    T, B, H = check_scan_inputs(x_proj_tm, w_h, bias, seq_len)
    dev = x_proj_tm.device
    if dev.type == "cpu":
        return lstm_chunk_scan_reference(x_proj_tm, w_h, bias, seq_len,
                                         forget_bias)

    Hp = layout.tma_width(H, 2)
    if Hp != H:
        outs, c, h = lstm_chunk_scan(layout.pad_gates(x_proj_tm, Hp),
                                     layout.pad_wh(w_h, Hp),
                                     layout.pad_gates(bias, Hp), seq_len, forget_bias)
        return (outs[..., :H].contiguous(), c[:, :H].contiguous(),
                h[:, :H].contiguous())
    b = bias.to(torch.float32)
    seq = seq_len.to(torch.int32)
    for name, tensor in (("x_proj_tm", x_proj_tm), ("bias", b), ("seq_len", seq)):
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
    c, h, h_bf16 = layout.zero_state(B, H, dev)  # h, h_bf16: ping-pongs
    if T == 0 or B == 0:
        return outs, c, h[0]
    bm, bu = layout.forward_tile(B, H)
    w_packed = layout.pack_wh(w_h, bu, torch.bfloat16)

    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_chunk_scan_bf16(
            x_proj_tm.data_ptr(), w_packed.data_ptr(), b.data_ptr(),
            seq.data_ptr(), outs.data_ptr(), c.data_ptr(), h.data_ptr(),
            h_bf16.data_ptr(), T, B, H, bm, bu, float(forget_bias), stream)
    if err != 0:
        msg = lib.lstm_chunk_scan_error_string(err).decode()
        raise RuntimeError(f"lstm_chunk_scan kernel launch failed: {msg} ({err})")
    lstm_chunk_scan.launches += 1
    return outs, c, h[T % 2]


lstm_chunk_scan.launches = 0


def multi_lstm_scan_fused(
    params: Sequence,
    xs: torch.Tensor,  # [B, T, D]
    seq_len: torch.Tensor,  # [B]
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """Stacked-LSTM forward with the fused scan per layer; returns the
    ``[c0, h0, c1, h1, ...]`` final state like ops.lstm.multi_lstm_scan.
    One transpose to time-major up front; each layer's bf16 outputs feed
    the next layer's projection directly."""
    state_parts = []
    layer_in = xs.transpose(0, 1).to(torch.bfloat16).contiguous()  # [T, B, D]
    for p in params:
        D = layer_in.shape[-1]
        x_proj = torch.matmul(layer_in, p.kernel[:D].to(torch.bfloat16))
        outs, c_fin, h_fin = lstm_chunk_scan(
            x_proj, p.kernel[D:], p.bias, seq_len, forget_bias=forget_bias)
        state_parts.extend([c_fin, h_fin])
        layer_in = outs
    return torch.cat(state_parts, dim=-1)
