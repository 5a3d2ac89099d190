"""The frozen counts: the kernels' bounds at the flagship layer shapes as
PERF.md's kernel table gives them, the port's bounds.py at every shape,
and the model FLOPs of a step."""

import pytest

from portbench import counts

# (kernel, T, B, bound ms) at H = 1024: the student's L1 (6, 1280) and L2
# (5, 256), the teacher's L1 (15, 5120) and L2 (20, 256)
TABLE = [
    ("lstm_chunk_scan", 6, 1280, 0.0651), ("lstm_chunk_scan", 5, 256, 0.0109),
    ("lstm_chunk_scan", 15, 5120, 0.6514), ("lstm_chunk_scan", 20, 256, 0.0434),
    ("lstm_train_fwd", 6, 1280, 0.0761), ("lstm_train_fwd", 5, 256, 0.0149),
    ("lstm_train_fwd", 15, 5120, 0.7193), ("lstm_train_fwd", 20, 256, 0.0501),
    ("lstm_train_bwd", 6, 1280, 0.1086), ("lstm_train_bwd", 5, 256, 0.0174),
    ("lstm_train_bwd", 15, 5120, 1.2160), ("lstm_train_bwd", 20, 256, 0.0825),
    ("lstm_chunk_scan_int8", 6, 1280, 0.0326), ("lstm_chunk_scan_int8", 5, 256, 0.0058),
    ("lstm_chunk_scan_int8", 15, 5120, 0.3255), ("lstm_chunk_scan_int8", 20, 256, 0.0217),
]

FORWARD = {"towers": ["student"], "forwards": 1, "kernels": ["lstm_chunk_scan"]}
DISTILL = {"towers": ["teacher", "student"], "forwards": 3,
           "kernels": ["lstm_train_fwd", "lstm_train_bwd"]}
FINETUNE = dict(DISTILL, towers=["student"])

FLAGSHIP = {"lstm_cells": 1024, "lstm_layers": 2, "max_num_frames": 300, "every_n": 10,
            "num_inputs_L1": 5, "num_inputs_to_lstm": 20, "feature_sizes": "1024, 128",
            "num_classes": 4716, "moe_num_mixtures": 2}


@pytest.mark.parametrize("kernel,T,B,ms", TABLE)
def test_bound_matches_the_kernel_table(kernel, T, B, ms):
    assert round(counts.bound_ms(kernel, T, B, 1024), 4) == ms


@pytest.mark.parametrize("kernel", counts.KERNELS)
@pytest.mark.parametrize("T,B,H", [(6, 1280, 1024), (20, 256, 1024), (7, 40, 100), (1, 8, 16)])
def test_bound_is_the_ports(kernel, T, B, H):
    from efficientvideoclassification_youtube8m_torch.ops.kernels import bounds

    assert counts.bound_ms(kernel, T, B, H) == pytest.approx(bounds.bound(kernel, T, B, H)["ms"],
                                                             rel=1e-12)


def test_model_flops():
    # the student's forward: L1 30 row-steps x (2 x 1152 x 4096 + 2 x 1024 x
    # 4096) + 30 x 2 x 2048 x 4096, L2 5 x (2 x 5120 x 4096) + 5 x 2 x 2048
    # x 4096, the head 2 x 4096 x 4716 x 5, a video
    student = (30 * 2 * 2176 * 4096 + 30 * 2 * 2048 * 4096
               + 5 * 2 * 5120 * 4096 + 5 * 2 * 2048 * 4096 + 2 * 4096 * 4716 * 5)
    assert counts.forward_flops(FLAGSHIP, "student", 1) == student
    assert counts.step_flops(FLAGSHIP, FORWARD, 256) == 256 * student
    distill = counts.step_flops(FLAGSHIP, DISTILL, 256)
    assert 10.0e12 < distill < 10.4e12  # about 3.4 TFLOP a forward, times 3
    assert counts.step_flops(FLAGSHIP, FINETUNE, 256) == 3 * 256 * student


def test_step_kernel_calls():
    calls = counts.step_kernel_calls(FLAGSHIP, DISTILL, 256)
    assert len(calls) == 16
    assert ("lstm_train_bwd", 15, 5120, 1024) in calls
    assert counts.step_kernel_launches(FLAGSHIP, DISTILL, 256) == 2 * 2 * (15 + 20 + 6 + 5)
    assert counts.step_kernel_launches(FLAGSHIP, FORWARD, 8) == 2 * (6 + 5)
    assert [c[1:3] for c in counts.step_kernel_calls(FLAGSHIP, FORWARD, 8)] == [
        (6, 40), (6, 40), (5, 8), (5, 8)]
