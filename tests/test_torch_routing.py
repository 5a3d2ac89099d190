"""Every hidden size goes to the hand-written kernels, on the CPU.

TMA reads rows whose strides are multiples of 16 bytes, so the CUDA
kernels run at H padded to a multiple of 8 (bf16) or 16 (int8): the
wrappers zero-pad the gate columns, Wh and the state-shaped inputs
(`layout.tma_width`, `pad_gates`, `pad_wh`, `pad_units`) and slice the
outputs back. Here each kernel's plain version, run on inputs padded as
its wrapper pads them and sliced as it slices, gives what it gives at H:
the invariant the padded kernels rest on (they themselves run only on
the card, chip_smoke.py). The routing sends every width to the kernels,
as the JAX model sends lstm_cells 100 to its Pallas kernels."""

import gc

import numpy as np
import jax
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.models import get_model as jax_get_model
from efficientvideoclassification_youtube8m_tpu.serving import Predictor as JaxPredictor
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.ops import quantize
from efficientvideoclassification_youtube8m_torch.ops.kernels import (
    layout,
    lstm_scan,
    lstm_scan_int8,
    lstm_train,
)
from efficientvideoclassification_youtube8m_torch.serving import Predictor
from efficientvideoclassification_youtube8m_torch.train import step

torch.set_num_threads(1)

CUDA = torch.device("cuda")
BF16 = TrainConfig(compute_dtype="bfloat16")
T, B = 5, 6
SEQ = torch.tensor([0, 5, 3, 1, 5, 2])


def _case(H, seed):
    g = torch.Generator().manual_seed(seed)
    xp = (torch.randn(T, B, 4 * H, generator=g) * 0.5).bfloat16()
    w_h = torch.randn(H, 4 * H, generator=g) / H ** 0.5
    bias = torch.randn(4 * H, generator=g) * 0.1
    return xp, w_h, bias


def _close(got, want):
    """The plain bf16 versions sum ``h @ Wh`` in f32 over Hp terms instead
    of H, so the CPU's matmul may add them in another order: f32 results
    within 1e-5 (1.2e-7 measured), bf16 ones within one bf16 ulp of their
    largest magnitude, where such a difference crosses a rounding point."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_contiguous()
        ulp = 2.0 ** -8 * w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=ulp if w.dtype == torch.bfloat16 else 1e-5)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)


@pytest.mark.parametrize("H", [100, 40, 12])
def test_padded_scan_gives_the_scan_at_h(H):
    xp, w_h, bias = _case(H, H)
    Hp = layout.tma_width(H, 2)
    outs, c, h = lstm_scan.lstm_chunk_scan_reference(
        layout.pad_gates(xp, Hp), layout.pad_wh(w_h, Hp), layout.pad_gates(bias, Hp), SEQ)
    assert not outs[..., H:].any() and not c[:, H:].any() and not h[:, H:].any()
    _close((outs[..., :H].contiguous(), c[:, :H].contiguous(), h[:, :H].contiguous()),
           lstm_scan.lstm_chunk_scan_reference(xp, w_h, bias, SEQ))


@pytest.mark.parametrize("H", [100, 40, 12])
def test_padded_train_forward_gives_the_forward_at_h(H):
    xp, w_h, bias = _case(H, H + 1)
    Hp = layout.tma_width(H, 2)
    outs, gates, cs, c, h = lstm_train.lstm_train_fwd_reference(
        layout.pad_gates(xp, Hp), layout.pad_wh(w_h, Hp), layout.pad_gates(bias, Hp), SEQ)
    assert not cs[..., H:].any() and not h[:, H:].any()
    _close((outs[..., :H].contiguous(), layout.unpad_gates(gates, H),
            cs[..., :H].contiguous(), c[:, :H].contiguous(), h[:, :H].contiguous()),
           lstm_train.lstm_train_fwd_reference(xp, w_h, bias, SEQ))


@pytest.mark.parametrize("H", [100, 40, 12])
def test_padded_train_backward_gives_the_backward_at_h(H):
    """The padded units' residuals are zero-padded (not their true gate
    values): with zero rows of Wh and zero cotangents their dgates are 0
    all the same."""
    xp, w_h, bias = _case(H, H + 2)
    _, gates, cs, _, _ = lstm_train.lstm_train_fwd_reference(xp, w_h, bias, SEQ)
    g = torch.Generator().manual_seed(H)
    cot = (torch.randn(T, B, H, generator=g), torch.randn(B, H, generator=g),
           torch.randn(B, H, generator=g))
    Hp = layout.tma_width(H, 2)
    dgates = lstm_train.lstm_train_bwd_reference(
        layout.pad_wh(w_h, Hp), layout.pad_gates(gates, Hp),
        *(layout.pad_units(x, Hp) for x in (cs, *cot)), SEQ)
    assert not dgates.unflatten(-1, (4, Hp))[..., H:].any()
    want = lstm_train.lstm_train_bwd_reference(w_h, gates, cs, *cot, SEQ)
    _close((layout.unpad_gates(dgates, H),), (want,))


@pytest.mark.parametrize("H", [100, 40, 12])
def test_padded_int8_scan_gives_the_scan_at_h(H):
    """Bit for bit: a padded unit's h stays 0, so the row scales, the
    int8 products and every gate are those at H."""
    xp, w_h, bias = _case(H, H + 3)
    wh_q, wh_s = quantize.quantize_weight(w_h)
    Hp = layout.tma_width(H, 1)
    outs, c, h = lstm_scan_int8.lstm_chunk_scan_int8_reference(
        layout.pad_gates(xp, Hp), layout.pad_wh(wh_q, Hp), layout.pad_gates(wh_s, Hp),
        layout.pad_gates(bias, Hp), SEQ)
    assert not h[:, H:].any()
    _equal((outs[..., :H].contiguous(), c[:, :H].contiguous(), h[:, :H].contiguous()),
           lstm_scan_int8.lstm_chunk_scan_int8_reference(xp, wh_q, wh_s, bias, SEQ))


def test_the_int8_pack_is_made_once_per_weight_tensor():
    wh_q = torch.randint(-127, 128, (100, 400), dtype=torch.int8)
    packed = lstm_scan_int8.packed_wh_q(wh_q, 32, 112)
    assert torch.equal(packed, layout.pack_wh(layout.pad_wh(wh_q, 112), 32))
    assert lstm_scan_int8.packed_wh_q(wh_q, 32, 112) is packed
    # another tensor with the same values, and an in-place change, pack anew
    other = wh_q.clone()
    assert lstm_scan_int8.packed_wh_q(other, 32, 112) is not packed
    wh_q[0, 0] = -wh_q[0, 0] if wh_q[0, 0] else 1
    repacked = lstm_scan_int8.packed_wh_q(wh_q, 32, 112)
    assert repacked is not packed
    assert torch.equal(repacked, layout.pack_wh(layout.pad_wh(wh_q, 112), 32))
    key = id(wh_q)
    assert key in lstm_scan_int8._PACKED
    del wh_q, packed, repacked
    gc.collect()
    assert key not in lstm_scan_int8._PACKED  # dropped with its weight tensor


def test_quantize_rows_on_the_cpu_is_the_plain_version():
    h = torch.tanh(torch.randn(5, 48, generator=torch.Generator().manual_seed(0)))
    h[0] = 0.0
    h_q, h_scale = lstm_scan_int8.quantize_rows(h)
    want_q, want_scale = lstm_scan_int8.quantize_rows_reference(h)
    assert h_q.dtype == torch.int8 and torch.equal(h_q.float(), want_q)
    assert torch.equal(h_scale, want_scale[:, 0])
    with pytest.raises(ValueError):
        lstm_scan_int8.quantize_rows(h[:, :47])


@pytest.mark.parametrize("cells", [1024, 100, 48, 40])
def test_model_kwargs_send_every_width_to_the_kernels(cells):
    """bf16 on a CUDA device: the inference and train kernels at any
    width (decided from a device object, which needs no card)."""
    cfg = BF16.replace(lstm_cells=cells)
    assert step._model_apply_kwargs(cfg, CUDA, inference=True)["use_kernel"] is True
    assert step._model_apply_kwargs(cfg, CUDA)["use_kernel_train"] is True
    # on the CPU, and in f32, the plain scan
    assert not step._model_apply_kwargs(cfg, torch.device("cpu"), inference=True)["use_kernel"]
    assert not step._model_apply_kwargs(cfg.replace(compute_dtype="float32"), CUDA)[
        "use_kernel_train"]


ODD = TrainConfig(
    num_classes=24, batch_size=8, lstm_cells=100, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    feature_names="rgb, audio", feature_sizes="6, 2", compute_dtype="float32",
    scan_unroll=1,
)


@pytest.fixture(scope="module")
def odd_tree():
    """The JAX init at lstm_cells 100, a width the kernels pad."""
    cfg = ODD
    return jax.tree.map(np.asarray, jax_get_model(cfg.model).init(
        jax.random.PRNGKey(1), cfg.total_feature_size, cfg.num_classes,
        lstm_cells=cfg.lstm_cells, lstm_layers=cfg.lstm_layers,
        classifier=cfg.video_level_classifier_model,
        classifier_kwargs={"num_mixtures": cfg.moe_num_mixtures}))


@pytest.mark.parametrize("quantize_mode", ["none", "int8"])
def test_predictor_at_lstm_cells_100_matches_jax(odd_tree, quantize_mode):
    """7 requests at serve_batch 4 against the JAX Predictor, in f32, at
    tests/test_torch_quantize.py's bar of 1e-5 (f32 rounding; the int8
    sums are exact)."""
    rng = np.random.default_rng(5)
    feats = rng.integers(0, 256, size=(7, ODD.max_num_frames, ODD.total_feature_size),
                         dtype=np.uint8)
    nf = rng.integers(0, ODD.max_num_frames + 1, size=7).astype(np.int32)
    want = JaxPredictor(ODD, odd_tree, "student", serve_batch=4,
                        quantize=quantize_mode).predict(feats, nf)
    p = Predictor(ODD, odd_tree, "student", serve_batch=4, device="cpu",
                  quantize=quantize_mode)
    got = p.predict(feats, nf)
    assert got.shape == (7, ODD.num_classes)
    np.testing.assert_allclose(got, want, atol=1e-5)
