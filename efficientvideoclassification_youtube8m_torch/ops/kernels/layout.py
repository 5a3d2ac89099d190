"""What the LSTM step kernels need around them: the packed Wh of the
forward and the tile each kernel runs with (ops/csrc/lstm_step.cuh,
ops/csrc/lstm_train.cu, ops/csrc/lstm_chunk_scan_int8.cu).

The forward's block owns BU hidden units and all four gate columns of
them, and reads its slice of Wh K-major as one TMA box, so the wrapper
packs Wh once per call: row ``tile*4*BU + g*BU + uu`` of the packed
``[tiles*4*BU, H]`` is column ``g*H + tile*BU + uu`` of Wh, zero for
units past H. The backward's product ``dgates @ Whᵀ`` reads Wh ``[H, 4H]``
itself: it is already K-major there, one unit a row.

The int8 forward packs its Wh_q the same way, into int8 slabs.

TMA reads rows whose strides are multiples of 16 bytes, so the kernels
run at a hidden size that makes a row of h 16 bytes long (`tma_width`):
a wrapper zero-pads any other H up to it (`pad_gates`, `pad_wh`) and
slices its outputs back. A padded unit's gates are 0 and its zero rows
of Wh add nothing to the products, so its c and h stay exactly 0 and the
real units come out as at H.

The libraries are built for the tiles in `FWD_TILES`, `BWD_TILES` and
`INT8_TILES` only; the plan functions pick one of them from the layer's
shape.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SMS = 132  # streaming multiprocessors of an H100 SXM

# (rows, units) of a block, rows = 64 per consumer warpgroup, in order of
# preference; every block runs a 4-stage ring (hopper.cuh kStages).
# Forward: 128 x 32 units wherever it gives every SM two blocks (student
# and teacher L1), else 64 x 32 (the B=256 layers); a 128 x 64-unit tile
# reads Wh half as often but needs more registers than its epilogue
# leaves it. Backward: 64 x 128 units where it gives every SM two blocks
# (teacher L1), else 64 x 32 (a 128 x 128 tile was faster at student L1
# but leaves 80 blocks for 132 SMs). Deeper rings, a 128 x 256 backward
# tile, and clusters of 2 or 4 blocks sharing Wh (forward) or hi and lo
# (backward) by TMA multicast were no faster on an H100 (PERF.md).
FWD_TILES = ((128, 32), (64, 32))
BWD_TILES = ((64, 128), (64, 32))
# int8 forward: 128 x 32 units where that gives every SM two blocks
# (student and teacher L1, where it was faster than 64 x 32 on an H100),
# else 64 x 32 (the B=256 layers: 128 blocks for 132 SMs).
INT8_TILES = ((128, 32), (64, 32))
WAVES = 2  # blocks an SM that a preferred tile must give


def pack_wh(w_h: torch.Tensor, bu: int, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Wh ``[H, 4H]`` -> the forward's K-major slabs ``[tiles*4*bu, H]`` in
    `dtype` (default: w_h's), on w_h's device, units past H zero. The cast
    and the permutation are one copy."""
    H = w_h.shape[0]
    if tuple(w_h.shape) != (H, 4 * H):
        raise ValueError(f"w_h must be [H, 4H], got {tuple(w_h.shape)}")
    tiles = -(-H // bu)
    w = w_h.reshape(H, 4, H)
    if tiles * bu != H:
        w = torch.nn.functional.pad(w, (0, tiles * bu - H))
    packed = torch.empty(tiles, 4, bu, H, dtype=dtype or w_h.dtype, device=w_h.device)
    packed.permute(3, 1, 0, 2).copy_(w.reshape(H, 4, tiles, bu))  # [k, g, tile, uu]
    return packed.view(tiles * 4 * bu, H)


def tma_width(H: int, itemsize: int) -> int:
    """H rounded up so that H elements of `itemsize` bytes fill whole 16-byte
    units, as a TMA row stride must."""
    multiple = 16 // itemsize
    return -(-H // multiple) * multiple


def pad_units(x: torch.Tensor, Hp: int) -> torch.Tensor:
    """x ``[..., H]`` with zero units appended up to ``[..., Hp]``."""
    H = x.shape[-1]
    return x if Hp == H else torch.nn.functional.pad(x, (0, Hp - H))


def pad_gates(x: torch.Tensor, Hp: int) -> torch.Tensor:
    """x ``[..., 4H]`` (gate g of unit u at ``g*H + u``) -> ``[..., 4Hp]``,
    each gate's units zero-padded up to Hp."""
    H = x.shape[-1] // 4
    if Hp == H:
        return x
    return pad_units(x.unflatten(-1, (4, H)), Hp).flatten(-2)


def unpad_gates(x: torch.Tensor, H: int) -> torch.Tensor:
    """The inverse of `pad_gates`: ``[..., 4Hp]`` -> ``[..., 4H]``, contiguous."""
    Hp = x.shape[-1] // 4
    if Hp == H:
        return x
    return x.unflatten(-1, (4, Hp))[..., :H].flatten(-2)


def pad_wh(w_h: torch.Tensor, Hp: int) -> torch.Tensor:
    """Wh ``[H, 4H]`` -> ``[Hp, 4Hp]``, zero rows and gate columns for the
    units past H."""
    H = w_h.shape[0]
    if Hp == H:
        return w_h
    return pad_gates(torch.nn.functional.pad(w_h, (0, 0, 0, Hp - H)), Hp)


def zero_state(B: int, H: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's zeroed state: c ``[B, H]`` f32, the h ping-pong ``[2,
    B, H]`` f32 and its bf16 copy ``[2, B, H]`` (the A operand), as views
    of one buffer, so a call makes one allocation and one memset for
    them: at the B=256 layers the host's time per call is what the card
    waits on."""
    n = B * H
    buf = torch.zeros(4 * n, dtype=torch.float32, device=device)
    return (buf[:n].view(B, H), buf[n:3 * n].view(2, B, H),
            buf[3 * n:].view(torch.bfloat16).view(2, B, H))


def unpack_wh(packed: torch.Tensor, bu: int, H: int) -> torch.Tensor:
    """The inverse of `pack_wh`: ``[tiles*4*bu, H]`` -> Wh ``[H, 4H]``."""
    tiles = -(-H // bu)
    w = packed.reshape(tiles, 4, bu, H).permute(3, 1, 0, 2)  # [k, g, tile, uu]
    return w.reshape(H, 4, tiles * bu)[:, :, :H].reshape(H, 4 * H)


def grid(B: int, H: int, tile: Tuple[int, int]) -> Tuple[int, int]:
    """(unit tiles, row tiles) of a launch with `tile` = (rows, units)."""
    rows, units = tile
    return -(-H // units), -(-B // rows)


def _plan(B: int, H: int, tiles) -> Tuple[int, int]:
    """The first tile whose grid gives every SM `WAVES` blocks; where none
    does, the one with the most blocks."""
    for tile in tiles:
        x, y = grid(B, H, tile)
        if x * y >= WAVES * SMS:
            return tile
    return max(tiles, key=lambda tile: grid(B, H, tile)[0] * grid(B, H, tile)[1])


def forward_tile(B: int, H: int) -> Tuple[int, int]:
    """(rows, units) of the forward step kernel for a [B, H] layer."""
    return _plan(B, H, FWD_TILES)


def backward_tile(B: int, H: int) -> Tuple[int, int]:
    """(rows, units) of the backward step kernel for a [B, H] layer."""
    return _plan(B, H, BWD_TILES)


def int8_tile(B: int, H: int) -> Tuple[int, int]:
    """(rows, units) of the int8 step kernel for a [B, H] layer."""
    return _plan(B, H, INT8_TILES)
