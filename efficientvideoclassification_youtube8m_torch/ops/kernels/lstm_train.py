"""Train-mode bf16 LSTM layer: the CUDA train kernels' wrappers, their
plain PyTorch versions, and the autograd Function that joins them (port
of the JAX package's ops/pallas/lstm_scan.py train path:
`_train_fwd_pallas`, `make_lstm_layer_train_pallas`,
`multi_lstm_scan_train_pallas`).

The forward kernel runs the recurrence and streams two residuals, the
unmasked gate post-activations and the masked c_t; the backward kernel
runs the reverse-time dh/dc chain from them and emits the bf16 dgates
stream (ops/csrc/lstm_train.cu). As in the JAX custom VJP, the input
projection ``x @ Wx`` and the weight and input gradients (``dWh``,
``dWx``, ``d_bias``, ``d_xs``) are plain large products and a reduction
outside the kernels.

`lstm_train_fwd` and `lstm_train_bwd` take their plain versions only
for tensors on the CPU. For CUDA tensors they launch the kernel or raise.
The kernels take any hidden size: the wrappers zero-pad H to a multiple
of 8 (16-byte bf16 rows for TMA; `layout.tma_width`) and slice the
outputs back. In the backward the padded units' residuals are zero: with
zero rows of Wh and zero cotangents their dh and dc stay 0, so their
dgates are 0 whatever the gates.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from efficientvideoclassification_youtube8m_torch.ops.kernels import _build, layout
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_scan import (
    check_scan_inputs,
)

_LIB_NAME = "lstm_train"


def lstm_train_fwd_reference(
    x_proj_tm: torch.Tensor,  # [T, B, 4H] (x @ Wx, no bias)
    w_h: torch.Tensor,  # [H, 4H]
    bias: torch.Tensor,  # [4H]
    seq_len: torch.Tensor,  # [B] int
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the train forward kernel, with the TPU
    kernel's numerics (h carried in f32, rounded to bf16 before the
    product, which is taken in f32 on the bf16 values). Differentiable by
    autograd. Returns (outs bf16 [T, B, H], gates f32 [T, B, 4H] =
    [sigmoid(i), tanh(j), sigmoid(f + forget_bias), sigmoid(o)] at every
    step, masked cs f32 [T, B, H], final c f32 [B, H], final h f32
    [B, H])."""
    T, B, G = x_proj_tm.shape
    H = G // 4
    dev = x_proj_tm.device
    w = w_h.to(torch.bfloat16).to(torch.float32)
    b = bias.to(torch.float32)
    seq = seq_len.to(device=dev, dtype=torch.int32)
    c = torch.zeros(B, H, dtype=torch.float32, device=dev)
    h = torch.zeros(B, H, dtype=torch.float32, device=dev)
    outs, gates, cs = [], [], []
    for t in range(T):
        pre = (x_proj_tm[t].to(torch.bfloat16).to(torch.float32) + b
               + h.to(torch.bfloat16).to(torch.float32) @ w)
        i, j, f, o = torch.chunk(pre, 4, dim=-1)
        si, tj = torch.sigmoid(i), torch.tanh(j)
        sf, so = torch.sigmoid(f + forget_bias), torch.sigmoid(o)
        new_c = c * sf + si * tj
        new_h = torch.tanh(new_c) * so
        valid = (t < seq)[:, None]
        c = torch.where(valid, new_c, c)
        h = torch.where(valid, new_h, h)
        outs.append(torch.where(valid, new_h, 0.0).to(torch.bfloat16))
        gates.append(torch.cat([si, tj, sf, so], dim=-1))
        cs.append(c)

    def stack(parts, width, dtype):
        if parts:
            return torch.stack(parts)
        return torch.zeros(0, B, width, dtype=dtype, device=dev)

    return (stack(outs, H, torch.bfloat16), stack(gates, G, torch.float32),
            stack(cs, H, torch.float32), c, h)


def lstm_train_bwd_reference(
    w_h: torch.Tensor,  # [H, 4H]
    gates: torch.Tensor,  # [T, B, 4H] f32 post-activations
    cs: torch.Tensor,  # [T, B, H] f32 masked c_t
    d_outs: torch.Tensor,  # [T, B, H] f32
    d_cfin: torch.Tensor,  # [B, H]
    d_hfin: torch.Tensor,  # [B, H]
    seq_len: torch.Tensor,  # [B] int
) -> torch.Tensor:
    """Plain PyTorch version of the train backward kernel, with the TPU
    kernel's numerics: the dh chain multiplies the hi/lo bf16 split of
    dgates by bf16 Wh^T as two f32 products on the bf16 values, and the
    emitted stream is the hi part. Returns dgates bf16 [T, B, 4H]."""
    T, B, G = gates.shape
    dev = gates.device
    w_t = w_h.to(torch.bfloat16).to(torch.float32).t()  # [4H, H]
    seq = seq_len.to(device=dev, dtype=torch.int32)
    dc = d_cfin.to(torch.float32)
    dh = d_hfin.to(torch.float32)
    dgates = torch.empty(T, B, G, dtype=torch.bfloat16, device=dev)
    for t in reversed(range(T)):
        si, tj, sf, so = torch.chunk(gates[t], 4, dim=-1)
        tanh_c = torch.tanh(cs[t])
        c_prev = cs[t - 1] if t > 0 else torch.zeros_like(cs[t])
        valid = (t < seq)[:, None]
        dnew_h = torch.where(valid, dh + d_outs[t], 0.0)
        dnew_c = (torch.where(valid, dc, 0.0)
                  + dnew_h * so * (1.0 - tanh_c * tanh_c))
        dg = torch.cat([
            dnew_c * tj * si * (1.0 - si),
            dnew_c * si * (1.0 - tj * tj),
            dnew_c * c_prev * sf * (1.0 - sf),
            dnew_h * tanh_c * so * (1.0 - so),
        ], dim=-1)
        hi = dg.to(torch.bfloat16)
        lo = (dg - hi.to(torch.float32)).to(torch.bfloat16)
        dh = (hi.to(torch.float32) @ w_t + lo.to(torch.float32) @ w_t
              + torch.where(valid, 0.0, dh))
        dc = dnew_c * sf + torch.where(valid, 0.0, dc)
        dgates[t] = hi
    return dgates


def _declare(lib: ctypes.CDLL) -> None:
    fwd = lib.lstm_train_fwd_bf16
    fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.lstm_train_bwd_bf16
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    lib.lstm_train_error_string.argtypes = [ctypes.c_int]
    lib.lstm_train_error_string.restype = ctypes.c_char_p


def load_kernel() -> ctypes.CDLL:
    """Build ops/csrc/lstm_train.cu (at its first use in a checkout) and
    load it."""
    return _build.load_library(_LIB_NAME, _declare)


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.lstm_train_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _require_contiguous(**tensors: torch.Tensor) -> None:
    for name, tensor in tensors.items():
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lstm_train_fwd(
    x_proj_tm: torch.Tensor,  # [T, B, 4H] bf16, time-major (x @ Wx, no bias)
    w_h: torch.Tensor,  # [H, 4H] (any float dtype; cast to bf16)
    bias: torch.Tensor,  # [4H] (cast to f32)
    seq_len: torch.Tensor,  # [B] integer
    forget_bias: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """Train forward of one layer (time-major IO). Returns (outs bf16
    [T,B,H], gates f32 [T,B,4H], cs f32 [T,B,H], final_c f32 [B,H],
    final_h f32 [B,H]); gates and cs are the backward's residuals.

    On CUDA tensors this launches ops/csrc/lstm_train.cu (T step launches
    on the current stream, no synchronisation) and adds one to
    `lstm_train_fwd.launches`; on CPU tensors it runs
    `lstm_train_fwd_reference`. Anything the kernel does not take raises.
    Records no autograd graph: `LstmLayerTrain` differentiates it."""
    T, B, H = check_scan_inputs(x_proj_tm, w_h, bias, seq_len)
    dev = x_proj_tm.device
    if dev.type == "cpu":
        return lstm_train_fwd_reference(x_proj_tm, w_h, bias, seq_len,
                                        forget_bias)
    Hp = layout.tma_width(H, 2)
    if Hp != H:
        outs, gates, cs, c, h = lstm_train_fwd(
            layout.pad_gates(x_proj_tm, Hp), layout.pad_wh(w_h, Hp),
            layout.pad_gates(bias, Hp), seq_len, forget_bias)
        return (outs[..., :H].contiguous(), layout.unpad_gates(gates, H),
                cs[..., :H].contiguous(), c[:, :H].contiguous(), h[:, :H].contiguous())
    b = bias.to(torch.float32)
    seq = seq_len.to(torch.int32)
    _require_contiguous(x_proj_tm=x_proj_tm, bias=b, seq_len=seq)
    outs = torch.empty(T, B, H, dtype=torch.bfloat16, device=dev)
    gates = torch.empty(T, B, 4 * H, dtype=torch.float32, device=dev)
    cs = torch.empty(T, B, H, dtype=torch.float32, device=dev)
    c, h, h_bf16 = layout.zero_state(B, H, dev)  # h, h_bf16: ping-pongs
    if T == 0 or B == 0:
        return outs, gates, cs, c, h[0]
    bm, bu = layout.forward_tile(B, H)
    w_packed = layout.pack_wh(w_h, bu, torch.bfloat16)
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_train_fwd_bf16(
            x_proj_tm.data_ptr(), w_packed.data_ptr(), b.data_ptr(),
            seq.data_ptr(), outs.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            c.data_ptr(), h.data_ptr(), h_bf16.data_ptr(), T, B, H, bm, bu,
            float(forget_bias), stream)
    _raise_on(lib, err, "lstm_train_fwd")
    lstm_train_fwd.launches += 1
    return outs, gates, cs, c, h[T % 2]


lstm_train_fwd.launches = 0


def lstm_train_bwd(
    w_h: torch.Tensor,  # [H, 4H] (any float dtype; cast to bf16)
    gates: torch.Tensor,  # [T, B, 4H] f32
    cs: torch.Tensor,  # [T, B, H] f32
    d_outs: torch.Tensor,  # [T, B, H] f32
    d_cfin: torch.Tensor,  # [B, H] f32
    d_hfin: torch.Tensor,  # [B, H] f32
    seq_len: torch.Tensor,  # [B] integer
) -> torch.Tensor:
    """Train backward of one layer: the reverse-time dh/dc chain from the
    forward's residuals. Returns dgates bf16 [T, B, 4H] (time-major). The
    forget bias is not needed: sigmoid(f + forget_bias) is a residual.

    On CUDA tensors this launches ops/csrc/lstm_train.cu (a prologue and
    T-1 step launches on the current stream, no synchronisation) and adds
    one to `lstm_train_bwd.launches`; on CPU tensors it runs
    `lstm_train_bwd_reference`. Anything the kernel does not take
    raises."""
    if gates.dim() != 3 or gates.shape[-1] % 4:
        raise ValueError(f"gates must be [T, B, 4H], got {tuple(gates.shape)}")
    T, B, G = gates.shape
    H = G // 4
    shapes = {"w_h": (w_h, (H, G)), "cs": (cs, (T, B, H)),
              "d_outs": (d_outs, (T, B, H)), "d_cfin": (d_cfin, (B, H)),
              "d_hfin": (d_hfin, (B, H)), "seq_len": (seq_len, (B,))}
    for name, (tensor, shape) in shapes.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(tensor.shape)}")
    for name, tensor in (("gates", gates), ("cs", cs), ("d_outs", d_outs),
                         ("d_cfin", d_cfin), ("d_hfin", d_hfin)):
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
    if not w_h.is_floating_point():
        raise TypeError("w_h must be floating point")
    if seq_len.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"seq_len must be int32 or int64, got {seq_len.dtype}")
    dev = gates.device
    for name, (tensor, _) in shapes.items():
        if tensor.device != dev:
            raise ValueError(f"{name} is on {tensor.device}, gates on {dev}")
    if dev.type == "cpu":
        return lstm_train_bwd_reference(w_h, gates, cs, d_outs, d_cfin,
                                        d_hfin, seq_len)
    if dev.type != "cuda":
        raise ValueError(f"the LSTM kernels run on cpu or cuda, not {dev.type}")
    Hp = layout.tma_width(H, 2)
    if Hp != H:
        dgates = lstm_train_bwd(
            layout.pad_wh(w_h, Hp), layout.pad_gates(gates, Hp),
            *(layout.pad_units(x, Hp) for x in (cs, d_outs, d_cfin, d_hfin)), seq_len)
        return layout.unpad_gates(dgates, H)
    w = w_h.to(torch.bfloat16).contiguous()  # K-major for dgates @ Wh^T
    seq = seq_len.to(torch.int32)
    _require_contiguous(gates=gates, cs=cs, d_outs=d_outs, seq_len=seq)
    dgates = torch.empty(T, B, G, dtype=torch.bfloat16, device=dev)
    if T == 0 or B == 0:
        return dgates
    dh = d_hfin.contiguous().clone()
    dc = d_cfin.contiguous().clone()
    lo = torch.empty(2, B, G, dtype=torch.bfloat16, device=dev)
    bm, bn = layout.backward_tile(B, H)
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_train_bwd_bf16(
            w.data_ptr(), gates.data_ptr(), cs.data_ptr(), d_outs.data_ptr(),
            seq.data_ptr(), dh.data_ptr(), dc.data_ptr(), dgates.data_ptr(),
            lo.data_ptr(), T, B, H, bm, bn, stream)
    _raise_on(lib, err, "lstm_train_bwd")
    lstm_train_bwd.launches += 1
    return dgates


lstm_train_bwd.launches = 0


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 matrices with an unrounded f32 result (f32
    sums), as ``preferred_element_type=float32`` gives it."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


class LstmLayerTrain(torch.autograd.Function):
    """One LSTM layer in train mode, differentiable: the counterpart of
    the JAX package's `make_lstm_layer_train_pallas`.

    forward(kernel [D+H, 4H], bias [4H], xs [B, T, D], seq [B],
    forget_bias) -> (outs [B, T, H] bf16, final_c f32 [B, H], final_h f32
    [B, H]). ``x @ Wx`` is a bf16 product; the recurrence is
    `lstm_train_fwd`. The backward runs `lstm_train_bwd` for the dgates
    stream, then, on bf16 operands with f32 results: ``dWh = h_prevᵀ @
    dgates`` (h_prev: the bf16 outputs shifted by one step), ``dWx = xsᵀ
    @ dgates``, ``d_xs = dgates @ Wxᵀ``, and ``d_bias`` sums the bf16
    stream in f32 (the JAX kernel's documented deviation from summing f32
    dgates). No gradient flows to `seq` or `forget_bias`."""

    @staticmethod
    def forward(ctx, kernel, bias, xs, seq_len, forget_bias=1.0):
        D = xs.shape[-1]
        xs_tm = xs.transpose(0, 1).to(torch.bfloat16).contiguous()  # [T, B, D]
        x_proj = torch.matmul(xs_tm, kernel[:D].to(torch.bfloat16))
        outs, gates, cs, c_fin, h_fin = lstm_train_fwd(
            x_proj, kernel[D:], bias, seq_len, forget_bias)
        ctx.save_for_backward(kernel, xs_tm, seq_len, outs, gates, cs)
        ctx.dtypes = (kernel.dtype, bias.dtype, xs.dtype)
        return outs.transpose(0, 1), c_fin, h_fin

    @staticmethod
    def backward(ctx, d_outs, d_cfin, d_hfin):
        kernel, xs_tm, seq_len, outs, gates, cs = ctx.saved_tensors
        kernel_dtype, bias_dtype, xs_dtype = ctx.dtypes
        T, B, D = xs_tm.shape
        H = outs.shape[-1]
        dgates = lstm_train_bwd(
            kernel[D:], gates, cs,
            d_outs.transpose(0, 1).to(torch.float32).contiguous(),
            d_cfin.to(torch.float32), d_hfin.to(torch.float32), seq_len)
        flat_dg = dgates.reshape(T * B, 4 * H)
        h_prev = torch.cat([outs.new_zeros(1, B, H), outs[:-1]])
        d_wh = _mm_f32(h_prev.reshape(T * B, H).t(), flat_dg)
        d_wx = _mm_f32(xs_tm.reshape(T * B, D).t(), flat_dg)
        d_kernel = torch.cat([d_wx, d_wh]).to(kernel_dtype)
        d_bias = flat_dg.to(torch.float32).sum(0).to(bias_dtype)
        d_xs = None
        if ctx.needs_input_grad[2]:
            w_x = kernel[:D].to(torch.bfloat16)
            d_xs = _mm_f32(flat_dg, w_x.t()).reshape(T, B, D)
            d_xs = d_xs.transpose(0, 1).to(xs_dtype)
        return d_kernel, d_bias, d_xs, None, None


def multi_lstm_scan_train_fused(
    params: Sequence,
    xs: torch.Tensor,  # [B, T, D]
    seq_len: torch.Tensor,  # [B]
    forget_bias: float = 1.0,
) -> torch.Tensor:
    """Differentiable stacked-LSTM forward through `LstmLayerTrain` per
    layer; returns the ``[c0, h0, c1, h1, ...]`` final state like
    ops.lstm.multi_lstm_scan. Each layer's bf16 outputs feed the next."""
    state_parts = []
    layer_in = xs
    for p in params:
        outs, c_fin, h_fin = LstmLayerTrain.apply(
            p.kernel, p.bias, layer_in, seq_len, forget_bias)
        state_parts.extend([c_fin, h_fin])
        layer_in = outs
    return torch.cat(state_parts, dim=-1)
