"""What surrounds the LSTM step kernels, on the CPU: the packed Wh of
the forward (bf16 and int8), the tile plans, the tiles the CUDA sources
are built for, the bounds that chip_smoke.py prints beside each kernel's
time, and the arithmetic the int8 kernel's row quantization rests on.
The kernels themselves run only on the card (chip_smoke.py phases 2, 5
and 7); their plain versions are held against the JAX package in
tests/test_torch_lstm.py, tests/test_torch_lstm_train.py and
tests/test_torch_quantize.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from efficientvideoclassification_youtube8m_torch.ops.kernels import bounds, layout
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_scan_int8 import (
    quantize_rows_reference,
)

CSRC = Path(layout.__file__).resolve().parent.parent / "csrc"
FLAGSHIP = [s for s in chip_smoke.LAYER_SHAPES if s[0].startswith(("student", "teacher"))]


@pytest.mark.parametrize("H,bu,dtype", [
    pytest.param(48, 32, torch.float32, id="48-32"),
    pytest.param(1024, 32, torch.float32, id="1024-32"),
    pytest.param(1024, 64, torch.float32, id="1024-64"),
    pytest.param(16, 32, torch.float32, id="16-32"),
    # the int8 kernel's Wh_q slabs, and back
    pytest.param(48, 32, torch.int8, id="int8-48-32"),
    pytest.param(1024, 32, torch.int8, id="int8-1024-32"),
])
def test_pack_wh_puts_each_gate_column_in_its_slab(H, bu, dtype):
    w = np.random.default_rng(H + bu).standard_normal((H, 4 * H))
    w = torch.from_numpy(np.clip(np.rint(w * 60), -127, 127) if dtype == torch.int8
                         else w).to(dtype)
    packed = layout.pack_wh(w, bu)
    tiles = -(-H // bu)
    assert packed.shape == (tiles * 4 * bu, H) and packed.is_contiguous()
    assert packed.dtype == dtype and torch.equal(layout.unpack_wh(packed, bu, H), w)
    slabs = packed.reshape(tiles, 4 * bu, H)
    for tile in range(tiles):
        for g in range(4):
            for uu in range(bu):
                u = tile * bu + uu
                col = slabs[tile, g * bu + uu]
                if u < H:
                    assert torch.equal(col, w[:, g * H + u])
                else:
                    assert not col.any()  # units past H are zero


@pytest.mark.parametrize("H,bu", [(48, 32), (1024, 64)])
def test_pack_wh_round_trips_in_bf16(H, bu):
    w = torch.randn(H, 4 * H, generator=torch.Generator().manual_seed(H)).bfloat16()
    packed = layout.pack_wh(w, bu)
    assert packed.dtype == torch.bfloat16
    assert torch.equal(layout.unpack_wh(packed, bu, H), w)


@pytest.mark.parametrize("H,bu", [(48, 32), (64, 32)])
def test_pack_wh_casts_in_the_same_copy(H, bu):
    """An f32 Wh packed straight to bf16 (what the wrappers do) equals the
    bf16 Wh packed, including a strided Wh (a slice of the layer's kernel)."""
    rng = np.random.default_rng(H)
    kernel = torch.from_numpy(rng.standard_normal((H + 24, 4 * H)).astype(np.float32))
    w = kernel[24:]
    packed = layout.pack_wh(w, bu, torch.bfloat16)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert torch.equal(packed, layout.pack_wh(w.bfloat16(), bu))
    assert torch.equal(layout.unpack_wh(packed, bu, H), w.bfloat16())


def test_zero_state_gives_disjoint_zeroed_views():
    B, H = 5, 16
    c, h, hb = layout.zero_state(B, H, "cpu")
    assert (c.shape, c.dtype) == ((B, H), torch.float32)
    assert (h.shape, h.dtype) == ((2, B, H), torch.float32)
    assert (hb.shape, hb.dtype) == ((2, B, H), torch.bfloat16)
    assert all(t.is_contiguous() and not t.any() for t in (c, h, hb))
    c.fill_(1.0)
    h.fill_(2.0)
    hb.fill_(3.0)
    assert (c == 1).all() and (h == 2).all() and (hb == 3).all()
    # 16-byte aligned, as a TMA base address must be
    assert all(t.data_ptr() % 16 == 0 for t in (c, h, hb))


def test_pack_wh_rejects_a_non_lstm_shape():
    with pytest.raises(ValueError, match=r"\[H, 4H\]"):
        layout.pack_wh(torch.zeros(8, 24), 32)


PLANS = {
    "forward": (layout.forward_tile, layout.FWD_TILES),
    "backward": (layout.backward_tile, layout.BWD_TILES),
    "int8": (layout.int8_tile, layout.INT8_TILES),
}


@pytest.mark.parametrize("shape", chip_smoke.LAYER_SHAPES, ids=lambda s: s[0])
@pytest.mark.parametrize("which", ["forward", "backward", "int8"])
def test_tile_plan_covers_every_row_and_unit(shape, which):
    _, T, B, H, _ = shape
    plan, built = PLANS[which]
    tile = plan(B, H)
    assert tile in built
    rows, units = tile
    x, y = layout.grid(B, H, tile)
    assert x * units >= H > (x - 1) * units
    assert y * rows >= B > (y - 1) * rows
    if shape in FLAGSHIP:
        assert x * y >= 100, f"{which} {shape[0]}: {x * y} blocks"


def test_tile_plan_at_the_flagship_shapes():
    """The tiles that were fastest on an H100 at these shapes (PERF.md)."""
    picked = {name: (layout.forward_tile(B, H), layout.backward_tile(B, H),
                     layout.int8_tile(B, H))
              for name, _, B, H, _ in FLAGSHIP}
    assert picked == {
        "student_L1": ((128, 32), (64, 32), (128, 32)),
        "student_L2": ((64, 32), (64, 32), (64, 32)),
        "teacher_L1": ((128, 32), (64, 128), (128, 32)),
        "teacher_L2": ((64, 32), (64, 32), (64, 32)),
    }


@pytest.mark.parametrize("source,macro,tiles", [
    ("lstm_step.cuh", "LSTM_FWD_TILE", layout.FWD_TILES),
    ("lstm_train.cu", "LSTM_BWD_TILE", layout.BWD_TILES),
    ("lstm_chunk_scan_int8.cu", "LSTM_INT8_TILE", layout.INT8_TILES),
])
def test_the_sources_build_every_planned_tile(source, macro, tiles):
    text = (CSRC / source).read_text()
    built = {tuple(map(int, m)) for m in
             re.findall(rf"^\s*{macro}\((\d+), (\d+)\)$", text, re.M)}
    assert built == set(tiles)


# The Motivation's hand count (H=1024): a train-forward row-step moves
# 30 KiB (xp in; outs, gates, cs out) plus Wh's 8 MiB once, against 3.35
# TB/s; a train-backward row-step is 16*H^2 flops over T-1 steps, against
# 989 TFLOP/s. bounds.py also counts the small tensors (bias, seq, the
# final states), which this hand count leaves out.
HAND = {  # name: (fwd ms, bwd ms)
    "teacher_L1": (0.707, 1.216),
    "teacher_L2": (0.050, 0.083),
    "student_L1": (0.073, 0.109),
    "student_L2": (0.014, 0.017),
}


@pytest.mark.parametrize("shape", FLAGSHIP, ids=lambda s: s[0])
def test_train_bounds_match_the_hand_count(shape):
    name, T, B, H, _ = shape
    fwd = bounds.bound("lstm_train_fwd", T, B, H)
    bwd = bounds.bound("lstm_train_bwd", T, B, H)
    assert fwd["bound_by"] == "bytes" and bwd["bound_by"] == "operations"
    small = 4 * H * 4 + 4 * B + 2 * B * H * 4  # bias, seq, final c and h
    big = T * B * 30 * H + 8 * H * H
    assert fwd["bytes"] == big + small
    assert abs(big / 3.35e12 * 1e3 - HAND[name][0]) < 6e-4
    assert bwd["ops"] == (T - 1) * B * 16 * H * H
    assert abs(bwd["ms"] - HAND[name][1]) < 6e-4
    assert fwd["ms"] == fwd["bytes_ms"] and bwd["ms"] == bwd["ops_ms"]


@pytest.mark.parametrize("shape", FLAGSHIP, ids=lambda s: s[0])
def test_inference_bounds(shape):
    """The forward-only scan is bound by the tensor cores (8*H^2 flops
    against 10*H bytes a row-step); the int8 one counts 1,979 TOP/s and
    the int8 Wh that ops/quantize.py feeds it."""
    _, T, B, H, _ = shape
    scan = bounds.bound("lstm_chunk_scan", T, B, H)
    int8 = bounds.bound("lstm_chunk_scan_int8", T, B, H)
    assert scan["bound_by"] == "operations"
    assert scan["ops"] == int8["ops"] == T * B * 8 * H * H
    assert scan["ms"] == pytest.approx(T * B * 8 * H * H / 989e12 * 1e3)
    assert int8["ops_ms"] == pytest.approx(scan["ops_ms"] * 989 / 1979)
    assert int8["bytes"] == scan["bytes"] - 4 * H * H + 16 * H  # int8 Wh, f32 scales
    assert int8["ms"] == max(int8["ops_ms"], int8["bytes_ms"])


def test_achieved_share_and_rate():
    b = bounds.bound("lstm_train_bwd", 15, 5120, 1024)
    got = bounds.achieved("lstm_train_bwd", 15, 5120, 1024, 2 * b["ms"])
    assert got["share"] == pytest.approx(0.5)
    assert got["rate"] == pytest.approx(989 / 2)
    assert got["bound_by"] == b["bound_by"] and got["ms"] == b["ms"]
    with pytest.raises(ValueError, match="unknown kernel"):
        bounds.bound("lstm_int4", 1, 1, 8)


def _kernel_quantize_threshold() -> float:
    """The threshold of the int8 kernel's quantize
    (ops/csrc/lstm_chunk_scan_int8.cu `quantize`), read from the source:
    the reciprocal product t = x * RN(1/scale) is rounded, and where |t -
    rint(t)| exceeds the threshold (t near a half-way point) the true
    quotient is rounded instead."""
    text = (CSRC / "lstm_chunk_scan_int8.cu").read_text()
    assert "return {scale, __frcp_rn(scale)};" in text
    body = re.search(r"int quantize\(float x, RowScale s\) \{\n(.*?)\n\}", text, re.S).group(1)
    assert "const float t = __fmul_rn(x, s.inv);" in body and "float r = rintf(t);" in body
    m = re.search(r"if \(fabsf\(__fsub_rn\(t, r\)\) > ([0-9.]+)f\) "
                  r"r = rintf\(__fdiv_rn\(x, s\.scale\)\);", body)
    assert m, "the quantize has no true-quotient fallback"
    return float(m.group(1))


def _quantize_by_reciprocal(x: torch.Tensor, scale: torch.Tensor, threshold) -> torch.Tensor:
    """The int8 kernel's quantize in f32 with a fallback `threshold` (None:
    no fallback)."""
    inv = torch.tensor(1.0, dtype=torch.float32) / scale
    t = x * inv
    r = torch.round(t)
    if threshold is not None:
        far = (t - r).abs() > torch.tensor(threshold, dtype=torch.float32)
        r = torch.where(far, torch.round(x / scale), r)
    return torch.clamp(r, -127, 127)


def _reciprocal_misses(threshold) -> int:
    """Values of chip_smoke.near_tie_rows() that the rule with `threshold`
    rounds away from the true quotient (`quantize_rows_reference`)."""
    x = chip_smoke.near_tie_rows()
    want, scale = quantize_rows_reference(x)
    return int((_quantize_by_reciprocal(x, scale, threshold) != want).sum())


def test_reciprocal_quantize_rounds_as_the_true_quotient():
    """The kernel's rule, with the threshold its source holds, rounds every
    crafted row as the true quotient does."""
    assert chip_smoke.near_tie_rows().numel() > 10000
    assert _reciprocal_misses(_kernel_quantize_threshold()) == 0


@pytest.mark.parametrize("threshold", [None, 0.4999995], ids=["no-fallback", "too-narrow"])
def test_the_near_tie_rows_catch_a_broken_fallback(threshold):
    """Without the fallback, or with a window of 5e-7 around the half-way
    points (narrower than the product's 2.3e-5 error), the crafted rows
    round some value away from the true quotient."""
    assert _reciprocal_misses(threshold) > 0


@pytest.mark.parametrize("H,itemsize,want", [(1024, 2, 1024), (100, 2, 104), (100, 1, 112),
                                             (48, 1, 48), (40, 1, 48), (1, 2, 8)])
def test_tma_width(H, itemsize, want):
    assert layout.tma_width(H, itemsize) == want


@pytest.mark.parametrize("H,Hp", [(100, 104), (100, 112), (40, 48), (16, 16)])
def test_padding_keeps_every_gate_column_in_place(H, Hp):
    rng = np.random.default_rng(H + Hp)
    w = torch.from_numpy(rng.standard_normal((H, 4 * H)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 5, 4 * H)).astype(np.float32))
    wp, xp = layout.pad_wh(w, Hp), layout.pad_gates(x, Hp)
    assert wp.shape == (Hp, 4 * Hp) and xp.shape == (3, 5, 4 * Hp)
    for g in range(4):
        assert torch.equal(wp[:H, g * Hp:g * Hp + H], w[:, g * H:(g + 1) * H])
        assert torch.equal(xp[..., g * Hp:g * Hp + H], x[..., g * H:(g + 1) * H])
        assert not wp[:, g * Hp + H:(g + 1) * Hp].any() and not xp[..., g * Hp + H:(g + 1) * Hp].any()
    assert not wp[H:].any()
    back = layout.unpad_gates(xp, H)
    assert torch.equal(back, x) and back.is_contiguous()
    assert torch.equal(layout.pad_units(x[..., :H], Hp)[..., :H], x[..., :H])
