"""The least time an H100 could take for one call of each LSTM kernel:
the larger of the bytes the call must move over the memory rate and the
operations it must do over the tensor cores' peak for their type. Each
input is counted read once and each output written once, whatever the
kernel reads again; every row-step is counted, masked ones included,
since the kernels compute them all (the train forward's gates residual
is unmasked, and a frozen row still carries its state).

Rates: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit
(989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s HBM3).
"""

from __future__ import annotations

from typing import Dict

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12

KERNELS = ("lstm_chunk_scan", "lstm_train_fwd", "lstm_train_bwd", "lstm_chunk_scan_int8")


def _counts(kernel: str, T: int, B: int, H: int):
    """(operations, bytes, peak operations/s) of one call on a layer of T
    steps, B rows and H units."""
    rows = T * B
    bh = B * H
    if kernel in ("lstm_chunk_scan", "lstm_train_fwd"):
        ops = rows * 8 * H * H  # [B, H] x [H, 4H] a step
        # xp [T, B, 4H] bf16 and Wh [H, 4H] bf16, bias f32, seq int32 in;
        # outs [T, B, H] bf16 and the final c and h [B, H] f32 out.
        moved = rows * 4 * H * 2 + H * 4 * H * 2 + 4 * H * 4 + B * 4
        moved += rows * H * 2 + 2 * bh * 4
        if kernel == "lstm_train_fwd":
            moved += rows * 4 * H * 4 + rows * H * 4  # gates and cs, f32
        return ops, moved, BF16_FLOPS
    if kernel == "lstm_train_bwd":
        # (hi + lo) [B, 4H] x Wh^T [4H, H] over the T-1 steps after the
        # prologue: two products a step.
        ops = max(T - 1, 0) * B * 2 * 2 * 4 * H * H
        # gates [T, B, 4H], cs and d_outs [T, B, H] f32, Wh bf16, dc_fin
        # and dh_fin f32, seq in; dgates [T, B, 4H] bf16 out.
        moved = rows * 4 * H * 4 + 2 * rows * H * 4 + H * 4 * H * 2 + 2 * bh * 4 + B * 4
        moved += rows * 4 * H * 2
        return ops, moved, BF16_FLOPS
    if kernel == "lstm_chunk_scan_int8":
        ops = rows * 8 * H * H
        # What ops/quantize.py feeds it: xp [T, B, 4H] bf16, Wh int8
        # [H, 4H] and its f32 scales [4H], bias f32, seq; outs bf16 and
        # the final c and h f32 out.
        moved = rows * 4 * H * 2 + H * 4 * H + 4 * H * 4 + 4 * H * 4 + B * 4
        moved += rows * H * 2 + 2 * bh * 4
        return ops, moved, INT8_OPS
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def bound(kernel: str, T: int, B: int, H: int) -> Dict[str, object]:
    """{"ops", "bytes", "ops_ms", "bytes_ms", "ms", "bound_by"} of one call
    of `kernel` on a layer of T steps, B rows and H units; "ms" is the
    larger of the two times and "bound_by" says which ("operations" or
    "bytes")."""
    ops, moved, peak = _counts(kernel, T, B, H)
    ops_ms = ops / peak * 1e3
    bytes_ms = moved / HBM_BYTES * 1e3
    return {"ops": ops, "bytes": moved, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def achieved(kernel: str, T: int, B: int, H: int, ms: float) -> Dict[str, object]:
    """`bound(kernel, T, B, H)` with the share of it and the operation rate
    ("rate", in 10^12 a second: TFLOP/s, or TOP/s for int8) of a call
    that took `ms` milliseconds."""
    b = bound(kernel, T, B, H)
    return {**b, "share": b["ms"] / ms, "rate": b["ops"] / (ms * 1e-3) / 1e12}
