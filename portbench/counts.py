"""The benchmark's frozen yardstick of work: the H100's peaks, the least
time each LSTM kernel call could take, and the model FLOPs of a step.

The kernel bounds are a frozen copy of the port's
`ops/kernels/bounds.py` as it stood when the benchmark was defined (a
later change to the program cannot move them): the larger of the bytes a
call must move over the memory rate and the operations it must do over
the tensor cores' peak. Each input is counted read once and each output
written once; every row-step of the padded shapes is counted, masked ones
included, since the kernels compute them all.

The model FLOPs count the matrix products of the hierarchical LSTM and
the MoE head, 2 per multiply-add, over every row-step of the padded
shapes: layer 0 of L1 reads the 1152 input features, layer 0 of L2 reads
L1's whole final state (layers x 2 x cells wide), deeper layers read the
cells of the layer below. The count does not depend on which kernel runs
a layer. A training step counts 3 forwards (the forward, and the
backward's two products per forward product); elementwise work is not
counted.

Rates: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12

KERNELS = ("lstm_chunk_scan", "lstm_train_fwd", "lstm_train_bwd",
           "lstm_chunk_scan_int8")


def kernel_counts(kernel: str, T: int, B: int, H: int) -> Tuple[int, int, float]:
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
        moved = (rows * 4 * H * 4 + 2 * rows * H * 4 + H * 4 * H * 2
                 + 2 * bh * 4 + B * 4)
        moved += rows * 4 * H * 2
        return ops, moved, BF16_FLOPS
    if kernel == "lstm_chunk_scan_int8":
        ops = rows * 8 * H * H
        # xp [T, B, 4H] bf16, Wh int8 [H, 4H] and its f32 scales [4H],
        # bias f32, seq in; outs bf16 and the final c and h f32 out.
        moved = rows * 4 * H * 2 + H * 4 * H + 4 * H * 4 + 4 * H * 4 + B * 4
        moved += rows * H * 2 + 2 * bh * 4
        return ops, moved, INT8_OPS
    raise ValueError(f"unknown kernel {kernel!r}; one of {KERNELS}")


def bound_ms(kernel: str, T: int, B: int, H: int) -> float:
    """The least milliseconds one call of `kernel` could take."""
    ops, moved, peak = kernel_counts(kernel, T, B, H)
    return max(ops / peak, moved / HBM_BYTES) * 1e3


# --------------------------------------------------------- the model


def tower_layers(cfg: Dict, tower: str, batch: int) -> List[Dict]:
    """The recurrent layers of one forward of a tower on `batch` videos:
    one entry a layer with its steps T, rows B, units H and input width
    D. `cfg` is a configuration file's "flags" (the port's flag names)."""
    H = cfg["lstm_cells"]
    layers = cfg["lstm_layers"]
    frames = cfg["max_num_frames"]
    if tower == "student":
        frames //= cfg["every_n"]
        chunks = cfg["num_inputs_L1"]
    else:
        chunks = cfg["num_inputs_to_lstm"]
    features = sum(int(s) for s in str(cfg["feature_sizes"]).split(","))
    state = layers * 2 * H
    out = []
    for level, (T, B, D) in enumerate(((frames // chunks, batch * chunks, features),
                                       (chunks, batch, state))):
        for i in range(layers):
            out.append({"level": level + 1, "T": T, "B": B, "H": H,
                        "D": D if i == 0 else H})
    return out


def head_flops(cfg: Dict, batch: int) -> int:
    """The MoE head's two products: gates [state, V (m+1)] and experts
    [state, V m]."""
    state = cfg["lstm_layers"] * 2 * cfg["lstm_cells"]
    m = cfg["moe_num_mixtures"]
    return 2 * batch * state * cfg["num_classes"] * (2 * m + 1)


def forward_flops(cfg: Dict, tower: str, batch: int) -> int:
    """Model FLOPs of one forward of `tower` on `batch` videos."""
    total = head_flops(cfg, batch)
    for layer in tower_layers(cfg, tower, batch):
        rows = layer["T"] * layer["B"]
        total += 2 * rows * (layer["D"] + layer["H"]) * 4 * layer["H"]
    return total


def step_flops(cfg: Dict, work: Dict, batch: int) -> int:
    """Model FLOPs of one step of `work` (a cell file's "work": the
    "towers" it runs and the "forwards" a step counts: 1 for a forward
    pass, 3 for a training step)."""
    return work["forwards"] * sum(forward_flops(cfg, t, batch) for t in work["towers"])


def step_kernel_calls(cfg: Dict, work: Dict, batch: int) -> List[Tuple[str, int, int, int]]:
    """The recurrence kernel calls of one step as (kernel, T, B, H): each
    of `work`'s "kernels" on every layer of its towers (a training step
    names the train forward and backward, a forward pass its scan)."""
    return [(k, layer["T"], layer["B"], layer["H"])
            for tower in work["towers"] for layer in tower_layers(cfg, tower, batch)
            for k in work["kernels"]]


def step_kernel_launches(cfg: Dict, work: Dict, batch: int) -> int:
    """Device kernel launches of those calls: a forward call launches one
    kernel a step, a backward call a prologue and one a step after it."""
    return sum(T for _, T, _, _ in step_kernel_calls(cfg, work, batch))


def step_bound_ms(cfg: Dict, work: Dict, batch: int) -> float:
    """The summed bounds of one step's recurrence kernel calls."""
    return sum(bound_ms(*call) for call in step_kernel_calls(cfg, work, batch))
