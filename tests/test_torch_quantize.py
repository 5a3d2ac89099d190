"""The port's int8 path against the JAX package's, on the CPU at the tiny
config of tests/test_quantize.py: the quantized weights and the int32
products bit for bit, the int8 scans, the int8 kernel's plain version
against the Pallas kernel in interpret mode, the int8 hierarchical
forward on both scan paths, the int8 Predictor, and the accuracy bar of
tests/test_quantize.py on a student the port trains."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.metrics import EvaluationMetrics
from efficientvideoclassification_youtube8m_tpu.models import get_model as jax_get_model
from efficientvideoclassification_youtube8m_tpu.ops import lstm as jlstm
from efficientvideoclassification_youtube8m_tpu.ops import quantize as jq
from efficientvideoclassification_youtube8m_tpu.ops.pallas.lstm_scan import (
    lstm_chunk_scan_pallas_int8,
)
from efficientvideoclassification_youtube8m_tpu.serving import Predictor as JaxPredictor
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.ops import quantize as tq
from efficientvideoclassification_youtube8m_torch.ops.kernels import _build
from efficientvideoclassification_youtube8m_torch.ops.kernels.lstm_scan_int8 import (
    lstm_chunk_scan_int8,
    lstm_chunk_scan_int8_reference,
)
from efficientvideoclassification_youtube8m_torch.serving import Predictor
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    init_model,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.train.step import build_finetune_step
from efficientvideoclassification_youtube8m_torch.weights import (
    load_jax_params,
    load_jax_quantized_params,
)

torch.set_num_threads(1)

TINY = TrainConfig(
    num_classes=24,
    batch_size=8,
    lstm_cells=16,
    lstm_layers=2,
    max_num_frames=40,
    num_inputs_to_lstm=4,
    num_inputs_L1=2,
    every_n=2,
    feature_names="rgb, audio",
    feature_sizes="6, 2",
    compute_dtype="float32",
    scan_unroll=1,
)
SEQ = np.r_[0, 1, 3, 7, 15, 15, 10, 2, 14, 5, 0, 9, 15, 4, 6, 11].astype(np.int32)
# The int8 paths agree with JAX's to f32 rounding: the int32 sums are
# exact, and the activation scales are true quotients here, where XLA
# multiplies a jitted division by the constant 127 by its f32 reciprocal
# (an ulp apart at most). Measured at these seeds: 1.8e-7 on the scans'
# states, 2.4e-7 on the kernel's finals, 0 on its bf16 outputs, 6e-8 on
# the predictions. A flipped rounding tie of h_q would move a gate by
# about amax|h| * amax|Wh| / 127 (~1e-3 here); none occurs at these
# seeds, and the bounds leave a margin of 40x and more over what was
# measured.
TOL_STATE = 1e-5
TOL_PRED = 1e-5


@pytest.fixture(scope="module")
def tree():
    """The JAX init of TINY, with non-zero biases so that the bias paths
    are exercised."""
    cfg = TINY
    params = jax.tree.map(np.asarray, jax_get_model(cfg.model).init(
        jax.random.PRNGKey(0), cfg.total_feature_size, cfg.num_classes,
        lstm_cells=cfg.lstm_cells, lstm_layers=cfg.lstm_layers,
        classifier=cfg.video_level_classifier_model,
        classifier_kwargs={"num_mixtures": cfg.moe_num_mixtures}))
    rng = np.random.default_rng(0)
    for cell in params["rnn_l1"] + params["rnn_l2"]:
        cell["bias"] = rng.normal(0, 0.3, cell["bias"].shape).astype(np.float32)
    b = params["classifier"]["experts"]["b"]
    params["classifier"]["experts"]["b"] = rng.normal(0, 0.3, b.shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def qtree(tree):
    """JAX's int8 parameter tree of `tree` (numpy leaves)."""
    return jax.tree.map(np.asarray, jq.quantize_hierarchical_params(
        tree, TINY.total_feature_size, TINY.lstm_cells, TINY.lstm_layers))


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for key, value in node.items():
            yield from _leaves(value, f"{prefix}{key}.")
    elif isinstance(node, list):
        for index, value in enumerate(node):
            yield from _leaves(value, f"{prefix}{index}.")
    else:
        yield prefix[:-1], node


def _assert_bit_identical(port_tree, jax_tree):
    got = {k: v.numpy() for k, v in _leaves(port_tree)}
    want = {k: np.asarray(v) for k, v in _leaves(jax_tree)}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight_bit_identical(axis):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 64)).astype(np.float32) * np.exp(
        rng.normal(size=(1, 64))).astype(np.float32)  # ranges vary 10x+
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    w[5] = 0.0
    q, s = tq.quantize_weight(torch.from_numpy(w), axis)
    want_q, want_s = jq.quantize_weight(jnp.asarray(w), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("source", ["tree", "module"])
def test_quantize_hierarchical_params_bit_identical(tree, qtree, source):
    """quantize_lstm_cell (split at the x/h boundary) and quantize_moe,
    through quantize_hierarchical_params, from the JAX tree or from the
    port's module holding the same weights; and the bridge that loads
    JAX's quantized tree."""
    cfg = TINY
    want = qtree
    params = tree if source == "tree" else load_jax_params(init_model(cfg), tree)
    got = tq.quantize_hierarchical_params(
        params, cfg.total_feature_size, cfg.lstm_cells, cfg.lstm_layers)
    _assert_bit_identical(got, want)
    assert not any(t.requires_grad for _, t in _leaves(got))
    _assert_bit_identical(load_jax_quantized_params(want), want)


def test_load_jax_quantized_params_rejects_bad_trees(qtree):
    bad = jax.tree.map(lambda a: a, qtree)
    bad["rnn_l1"][0]["wh_q"] = bad["rnn_l1"][0]["wh_q"].astype(np.float32)
    with pytest.raises(TypeError, match="wh_q"):
        load_jax_quantized_params(bad)
    bad = jax.tree.map(lambda a: a, qtree)
    del bad["classifier"]["experts_b"]
    with pytest.raises(KeyError):
        load_jax_quantized_params(bad)


@pytest.mark.parametrize("shape", [(13, 40), (2, 5, 40)])
def test_int8_dot_bit_identical(shape):
    """The int32 product bit for bit (JAX's dot_general with int32
    accumulation against torch._int_mm); the rescaled f32 result within
    1e-6 relative (the same three roundings; 0 measured)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    x[0] = 0.0  # a zero row: scale 1e-12, q 0
    w = rng.normal(size=(40, 36)).astype(np.float32)
    w_q, w_s = jq.quantize_weight(jnp.asarray(w))
    tw_q, tw_s = torch.from_numpy(np.array(w_q)), torch.from_numpy(np.array(w_s))
    x_q, x_s = tq._row_quant(torch.from_numpy(x))
    want_q, want_s = jq._row_quant(jnp.asarray(x))
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(x_s.numpy(), np.asarray(want_s))
    acc = tq.int_mm(x_q.reshape(-1, 40), tw_q)
    want_acc = jax.lax.dot_general(
        want_q, w_q, (((len(shape) - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc).reshape(-1, 36))
    got = tq.int8_dot(torch.from_numpy(x), tw_q, tw_s).numpy()
    want = np.asarray(jq.int8_dot(jnp.asarray(x), w_q, w_s))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _lstm_qparams(num_layers, D, H, seed):
    """JAX's quantized cells of a stack with a non-zero bias, and the
    same int8 tensors in the port's layout."""
    cells = jax.tree.map(np.asarray, jlstm.init_multi_lstm(
        jax.random.PRNGKey(seed), D, H, num_layers))
    rng = np.random.default_rng(seed)
    for cell in cells:
        cell["bias"] = rng.normal(0, 0.3, cell["bias"].shape).astype(np.float32)
    jqp = [jax.tree.map(np.asarray, jq.quantize_lstm_cell(c, s))
           for c, s in zip(cells, [D] + [H] * (num_layers - 1))]
    tqp = [{k: torch.from_numpy(np.array(v)) for k, v in c.items()} for c in jqp]
    return jqp, tqp


@pytest.mark.parametrize("num_layers", [1, 2])
def test_quantized_multi_lstm_scan_matches_jax(num_layers):
    """f32 carries and inter-layer outputs, zero-length rows included."""
    B, T, D, H = 16, 15, 12, 8
    jqp, tqp = _lstm_qparams(num_layers, D, H, seed=2)
    xs = np.random.default_rng(2).normal(size=(B, T, D)).astype(np.float32)
    want = np.asarray(jq.quantized_multi_lstm_scan(
        jax.tree.map(jnp.asarray, jqp), jnp.asarray(xs), jnp.asarray(SEQ)))
    got = tq.quantized_multi_lstm_scan(tqp, torch.from_numpy(xs),
                                       torch.from_numpy(SEQ)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_STATE)
    assert np.all(got[SEQ == 0] == 0.0)


@pytest.mark.parametrize("level", ["rnn_l1", "rnn_l2"])
def test_kernel_reference_matches_pallas_int8_interpret(qtree, level):
    """The int8 kernel's plain version (what the wrapper runs on CPU
    tensors) against `lstm_chunk_scan_pallas_int8` in interpret mode at an
    odd batch (one tile of 13 rows), on the same int8 weights: the model's
    second layer of each level, loaded through the quantized-tree
    bridge."""
    T, B, H = 7, 13, TINY.lstm_cells
    jqp = qtree[level][1]
    tqp = load_jax_quantized_params(qtree)[level][1]
    seq = np.r_[0, 1, 3, 7, 7, 5, 2, 6, 0, 4, 7, 1, 3].astype(np.int32)
    xp = torch.from_numpy(np.random.default_rng(3).normal(
        size=(T, B, 4 * H)).astype(np.float32)).bfloat16()
    want = lstm_chunk_scan_pallas_int8(
        jnp.asarray(xp.float().numpy(), jnp.bfloat16), jqp["wh_q"],
        jqp["wh_scale"], jqp["bias"], jnp.asarray(seq), tile_b=B,
        interpret=True)
    args = (xp, tqp["wh_q"], tqp["wh_scale"], tqp["bias"], torch.from_numpy(seq))
    got = lstm_chunk_scan_int8_reference(*args)
    outs, c_fin, h_fin = (t.float().numpy() for t in got)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    np.testing.assert_allclose(c_fin, np.asarray(want[1]), atol=TOL_STATE)
    np.testing.assert_allclose(h_fin, np.asarray(want[2]), atol=TOL_STATE)
    # bf16 outputs: at most one bf16 ulp of |h| < 1 apart
    np.testing.assert_allclose(outs, np.asarray(want[0], np.float32), atol=2 ** -8)
    for b, s in enumerate(seq):
        assert np.all(outs[s:, b] == 0.0)
    assert np.all(c_fin[seq == 0] == 0.0) and np.all(h_fin[seq == 0] == 0.0)


def test_cpu_wrapper_runs_plain_version_and_builds_nothing(monkeypatch):
    def no_build(*_):
        raise AssertionError("a CPU tensor must not build the CUDA kernel")

    monkeypatch.setattr(_build, "load_library", no_build)
    _, tqp = _lstm_qparams(1, 4, 8, seed=4)
    qp = tqp[0]
    xp = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, 5, 32)).astype(np.float32)).bfloat16()
    args = (xp, qp["wh_q"], qp["wh_scale"], qp["bias"], torch.tensor([0, 1, 2, 3, 3]))
    before = lstm_chunk_scan_int8.launches
    for g, w in zip(lstm_chunk_scan_int8(*args), lstm_chunk_scan_int8_reference(*args)):
        assert torch.equal(g, w)
    assert lstm_chunk_scan_int8.launches == before


def test_int8_wrapper_rejects_what_the_kernel_does_not_take():
    T, B, H = 2, 3, 8
    xp = torch.zeros(T, B, 4 * H, dtype=torch.bfloat16)
    wq = torch.zeros(H, 4 * H, dtype=torch.int8)
    ws, b = torch.ones(4 * H), torch.zeros(4 * H)
    seq = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(TypeError):
        lstm_chunk_scan_int8(xp, wq.float(), ws, b, seq)  # float weights
    with pytest.raises(TypeError):
        lstm_chunk_scan_int8(xp.float(), wq, ws, b, seq)
    with pytest.raises(ValueError):
        lstm_chunk_scan_int8(xp, wq, ws[:-1], b, seq)
    with pytest.raises(TypeError):
        lstm_chunk_scan_int8(xp, wq, ws.to(torch.int32), b, seq)
    with pytest.raises(RuntimeError, match="forward-only"):
        lstm_chunk_scan_int8(xp, wq, ws, b.requires_grad_(True), seq)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_fused_stack_matches_pallas_interpret(num_layers):
    """`quantized_multi_lstm_scan_fused` (the kernel per layer, its plain
    version here; bf16 inter-layer outputs) against
    `quantized_multi_lstm_scan_pallas` in interpret mode."""
    B, T, D, H = 16, 15, 12, 8
    jqp, tqp = _lstm_qparams(num_layers, D, H, seed=5)
    xs = np.random.default_rng(5).normal(size=(B, T, D)).astype(np.float32)
    want = np.asarray(jq.quantized_multi_lstm_scan_pallas(
        jax.tree.map(jnp.asarray, jqp), jnp.asarray(xs), jnp.asarray(SEQ),
        interpret=True))
    got = tq.quantized_multi_lstm_scan_fused(tqp, torch.from_numpy(xs),
                                             torch.from_numpy(SEQ)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL_STATE)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_quantized_hierarchical_forward_matches_jax(qtree, monkeypatch, use_kernel):
    """Against JAX's `quantized_hierarchical_forward`, its fused path
    swapped to interpret mode as tests/test_pallas_lstm.py does. B=8 so
    that JAX finds a tile for both levels (16 and 8 rows)."""
    cfg = TINY
    rng = np.random.default_rng(6)
    B, T = 8, cfg.max_num_frames // cfg.every_n
    xs = rng.normal(size=(B, T, cfg.total_feature_size)).astype(np.float32)
    xs /= np.linalg.norm(xs, axis=-1, keepdims=True)
    nf = rng.integers(0, T + 1, size=B).astype(np.int32)
    orig = jq.quantized_multi_lstm_scan_pallas
    monkeypatch.setattr(jq, "quantized_multi_lstm_scan_pallas",
                        lambda qp, x, s, **kw: orig(qp, x, s, interpret=True))
    want = np.asarray(jq.quantized_hierarchical_forward(
        jax.tree.map(jnp.asarray, qtree), jnp.asarray(xs), jnp.asarray(nf), cfg.num_inputs_L1,
        cfg.num_classes, cfg.moe_num_mixtures, use_pallas=use_kernel))
    got = tq.quantized_hierarchical_forward(
        load_jax_quantized_params(qtree),
        torch.from_numpy(xs), torch.from_numpy(nf), cfg.num_inputs_L1,
        cfg.num_classes, cfg.moe_num_mixtures, use_kernel=use_kernel).numpy()
    assert got.shape == (B, cfg.num_classes)
    np.testing.assert_allclose(got, want, atol=TOL_PRED)


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(n, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    return feats, rng.integers(0, cfg.max_num_frames + 1, size=n).astype(np.int32)


@pytest.mark.parametrize("tower", ["student", "teacher"])
def test_int8_predictor_matches_jax_predictor(tree, tower):
    """7 requests at serve_batch 4: two chunks, the second padded."""
    feats, nf = _requests(TINY, 7, seed=7)
    want = JaxPredictor(TINY, tree, tower, serve_batch=4,
                        quantize="int8").predict(feats, nf)
    p = Predictor(TINY, tree, tower, serve_batch=4, device="cpu", quantize="int8")
    got = p.predict(feats, nf)
    assert p.model is None and p.qparams["rnn_l1"][0]["wh_q"].dtype == torch.int8
    assert got.shape == (7, TINY.num_classes) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL_PRED)


def test_int8_predictor_guards(tree):
    for cfg in (TINY.replace(model="DbofModel"),
                TINY.replace(video_level_classifier_model="LogisticModel")):
        with pytest.raises(ValueError, match="flagship"):
            Predictor(cfg, tree, device="cpu", quantize="int8")
    with pytest.raises(ValueError, match="int8"):
        Predictor(TINY, tree, device="cpu", quantize="int4")


def _train_tiny_student(cfg, steps=220, lr=0.02, seed=0):
    """tests/test_quantize.py's learnable synthetic mapping, trained with
    the port's finetune step, so that the accuracy comparison runs on a
    model that predicts."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(cfg.num_classes, cfg.total_feature_size))
    protos = protos / np.linalg.norm(protos, axis=1, keepdims=True) * 80 + 128

    def batch(n, bseed):
        brng = np.random.default_rng(bseed)
        cls = brng.integers(cfg.num_classes, size=n)
        feats = np.clip(
            protos[cls][:, None, :]
            + brng.normal(scale=6.0, size=(n, cfg.max_num_frames,
                                           cfg.total_feature_size)),
            0, 255).astype(np.uint8)
        labels = np.zeros((n, cfg.num_classes), bool)
        labels[np.arange(n), cls] = True
        return feats, labels, np.full(n, cfg.max_num_frames, np.int32)

    cfg_t = cfg.replace(base_learning_rate=lr)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(
        init_distill_state(cfg_t, opt, torch.Generator().manual_seed(seed)), opt)
    step = build_finetune_step(cfg_t, opt, top_k=5)
    for i in range(steps):
        state, _ = step(state, *map(torch.from_numpy, batch(cfg.batch_size, 1000 + i)))
    return state.student, batch


def test_int8_epoch_metrics_within_2e3_of_float():
    """tests/test_quantize.py's bar for the port: Hit@1 and GAP of the
    int8 Predictor within +/-0.002 of the float Predictor on a held-out
    synthetic eval."""
    cfg = TINY.replace(batch_size=32)
    student, batch = _train_tiny_student(cfg)

    def epoch_metrics(quantize):
        p = Predictor(cfg, student, serve_batch=32, device="cpu", quantize=quantize)
        evl = EvaluationMetrics(cfg.num_classes, 5)
        for s in range(6):
            feats, labels, nf = batch(32, 9000 + s)
            probs = p.predict(feats, nf)
            idx = np.argsort(-probs, axis=1, kind="stable")[:, :5]
            vals = np.take_along_axis(probs, idx, axis=1)
            evl.accumulate_topk(vals, idx, labels, loss=np.zeros(32))
        return evl.get()

    base = epoch_metrics("none")
    q = epoch_metrics("int8")
    assert base["avg_hit_at_one"] > 0.9  # the comparison is meaningful
    assert abs(q["avg_hit_at_one"] - base["avg_hit_at_one"]) <= 2e-3
    assert abs(q["gap"] - base["gap"]) <= 2e-3
