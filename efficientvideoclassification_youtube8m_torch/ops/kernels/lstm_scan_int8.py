"""Fused int8 LSTM layer scan: the CUDA kernel's wrapper and its plain
PyTorch version (port of the JAX package's ops/pallas/lstm_scan.py
`_lstm_chunk_kernel_int8`, called through `lstm_chunk_scan_pallas_int8`).

Layout is time-major ([T, B, ...]) like the TPU kernel's. The input
projection (an int8 product, ops/quantize.int8_dot) stays outside the
kernel; the per-row quantization of h, the int8 recurrent product, the
rescale, the gate math and the masking run in the kernel
(ops/csrc/lstm_chunk_scan_int8.cu).

`lstm_chunk_scan_int8` takes its plain version only for tensors on the
CPU. For a CUDA tensor it launches the kernel or raises. The kernel takes
any hidden size: the wrapper zero-pads H to a multiple of 16 (16-byte
int8 rows for TMA; `layout.tma_width`) and slices the outputs back; a
padded unit's h stays 0, so the row scales are those at H.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, Tuple

import torch

from efficientvideoclassification_youtube8m_torch.ops.kernels import _build, layout
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


def quantize_rows_reference(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-step row quantization of h ``[B, H]`` f32: (h_q, the
    integers of ``clip(round_half_even(h / h_scale), -127, 127)`` in f32,
    and h_scale ``[B, 1]`` from `row_scale`)."""
    h_scale = row_scale(h)
    return torch.clamp(torch.round(h / h_scale), -127, 127), h_scale


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
        h_q, h_scale = quantize_rows_reference(h)
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
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.lstm_int8_quantize_rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.lstm_int8_quantize_rows.restype = ctypes.c_int
    lib.lstm_chunk_scan_int8_error_string.argtypes = [ctypes.c_int]
    lib.lstm_chunk_scan_int8_error_string.restype = ctypes.c_char_p


def load_kernel() -> ctypes.CDLL:
    """Build ops/csrc/lstm_chunk_scan_int8.cu (at its first use in a
    checkout) and load it."""
    return _build.load_library(_LIB_NAME, _declare)


# Wh_q packed for the kernel, by the id of the weight tensor: (a weak
# reference to it, its version, the pack's units, the packed slabs).
_PACKED: Dict[int, tuple] = {}


def packed_wh_q(wh_q: torch.Tensor, units: int, Hp: int) -> torch.Tensor:
    """`layout.pack_wh` of Wh_q, zero-padded to Hp units, for `units`:
    made once per weight tensor and kept while the tensor lives and is not
    changed in place. A Predictor or an eval step passes the same Wh_q on
    every call, so none but the first pays for the pack, a byte-strided
    copy (chip_smoke.py phase 7 times it)."""
    key = id(wh_q)
    entry = _PACKED.get(key)
    if entry is not None and entry[0]() is wh_q and entry[1:3] == (wh_q._version, units):
        return entry[3]
    packed = layout.pack_wh(layout.pad_wh(wh_q, Hp), units)
    ref = weakref.ref(wh_q, lambda _: _PACKED.pop(key, None))
    _PACKED[key] = (ref, wh_q._version, units, packed)
    return packed


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.lstm_chunk_scan_int8_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


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

    On CUDA tensors this launches ops/csrc/lstm_chunk_scan_int8.cu with
    the tile of `layout.int8_tile` (a quantize pass and a step kernel a
    step on the current stream, no synchronisation) and adds one to
    `lstm_chunk_scan_int8.launches`; Wh_q is packed once per weight tensor
    (`packed_wh_q`). On CPU tensors it runs
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
    Hp = layout.tma_width(H, 1)
    xp = layout.pad_gates(x_proj_tm, Hp)
    ws = layout.pad_gates(wh_scale.to(torch.float32), Hp)
    b = layout.pad_gates(bias.to(torch.float32), Hp)
    seq = seq_len.to(torch.int32)
    for name, tensor in (("x_proj_tm", xp), ("wh_scale", ws), ("bias", b),
                         ("seq_len", seq)):
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    outs = torch.empty(T, B, Hp, dtype=torch.bfloat16, device=dev)
    # c and the h ping-pong, zeroed in one allocation
    bh = B * Hp
    state = torch.zeros(3 * bh, dtype=torch.float32, device=dev)
    c, h = state[:bh].view(B, Hp), state[bh:].view(2, B, Hp)
    if T == 0 or B == 0:
        return outs[..., :H], c[:, :H], h[0, :, :H]
    h_q = torch.empty(B, Hp, dtype=torch.int8, device=dev)
    h_scale = torch.empty(B, dtype=torch.float32, device=dev)
    rows, units = layout.int8_tile(B, Hp)
    w_packed = packed_wh_q(wh_q, units, Hp)
    lib = load_kernel()
    with torch.cuda.device(dev):
        err = lib.lstm_chunk_scan_int8(
            xp.data_ptr(), w_packed.data_ptr(), ws.data_ptr(), b.data_ptr(),
            seq.data_ptr(), outs.data_ptr(), c.data_ptr(), h.data_ptr(),
            h_q.data_ptr(), h_scale.data_ptr(), T, B, Hp, rows, units,
            float(forget_bias), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "lstm_chunk_scan_int8")
    lstm_chunk_scan_int8.launches += 1
    if Hp != H:
        return (outs[..., :H].contiguous(), c[:, :H].contiguous(),
                h[T % 2, :, :H].contiguous())
    return outs, c, h[T % 2]


lstm_chunk_scan_int8.launches = 0


def quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's per-step row quantization alone, on h ``[B, H]`` f32
    with H % 4 == 0: (h_q int8 [B, H], h_scale f32 [B]). On a CUDA tensor
    it launches the library's quantize pass (the one `lstm_chunk_scan_int8`
    launches before every step; not counted in its launches), so that
    rows made to sit on rounding ties can be held against
    `quantize_rows_reference`; on a CPU tensor it runs that plain
    version."""
    if h.dim() != 2 or h.dtype != torch.float32 or h.shape[1] % 4:
        raise ValueError(f"h must be [B, H] f32 with H % 4 == 0, got "
                         f"{tuple(h.shape)} {h.dtype}")
    if h.device.type == "cpu":
        h_q, h_scale = quantize_rows_reference(h)
        return h_q.to(torch.int8), h_scale[:, 0]
    h = h.contiguous()
    B, H = h.shape
    h_q = torch.empty(B, H, dtype=torch.int8, device=h.device)
    h_scale = torch.empty(B, dtype=torch.float32, device=h.device)
    lib = load_kernel()
    with torch.cuda.device(h.device):
        err = lib.lstm_int8_quantize_rows(
            h.data_ptr(), h_q.data_ptr(), h_scale.data_ptr(), B, H,
            torch.cuda.current_stream(h.device).cuda_stream)
    _raise_on(lib, err, "lstm_int8_quantize_rows")
    return h_q, h_scale
