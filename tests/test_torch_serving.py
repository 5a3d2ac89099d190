"""The port's Predictor against the JAX package's Predictor, both built
from the same parameter tree (JAX init, no checkpoint) at the CFG of
tests/test_serving.py."""

import numpy as np
import jax
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.models import get_model as jax_get_model
from efficientvideoclassification_youtube8m_tpu.serving import Predictor as JaxPredictor
# the port's config: the JAX functions read the same fields (test_torch_summary_flags.py)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.serving import Predictor, init_model
from efficientvideoclassification_youtube8m_torch.train.orbax_io import OrbaxFormatError
from efficientvideoclassification_youtube8m_torch.weights import to_jax_params

torch.set_num_threads(1)

CFG = TrainConfig(
    num_classes=30,
    batch_size=4,
    lstm_cells=8,
    lstm_layers=2,
    max_num_frames=40,
    num_inputs_to_lstm=4,
    num_inputs_L1=2,
    every_n=2,
    feature_names="rgb, audio",
    feature_sizes="6, 2",
    scan_unroll=1,
    compute_dtype="float32",
)
BF16 = CFG.replace(compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def tree():
    params = jax_get_model(CFG.model).init(
        jax.random.PRNGKey(0), CFG.total_feature_size, CFG.num_classes,
        lstm_cells=CFG.lstm_cells, lstm_layers=CFG.lstm_layers,
        classifier=CFG.video_level_classifier_model,
        classifier_kwargs={"num_mixtures": CFG.moe_num_mixtures})
    return jax.tree.map(np.asarray, params)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(n, CFG.max_num_frames,
                                       CFG.total_feature_size), dtype=np.uint8)
    nf = rng.integers(0, CFG.max_num_frames + 1, size=n).astype(np.int32)
    return feats, nf


@pytest.mark.parametrize("cfg", [CFG, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("tower", ["student", "teacher"])
def test_predict_matches_jax_predictor(tree, cfg, tower):
    """7 requests at serve_batch 4: two chunks, the second padded."""
    feats, nf = _batch(7, seed=1)
    want = JaxPredictor(cfg, tree, tower, serve_batch=4).predict(feats, nf)
    got = Predictor(cfg, tree, tower, serve_batch=4, device="cpu").predict(
        feats, nf)
    assert got.shape == (7, CFG.num_classes) and got.dtype == np.float32
    # f32: other summation order; bf16: the same bf16 roundings with f32
    # sums (tests/test_torch_models.py measured both below 2e-7)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_padding_does_not_leak_into_results(tree):
    p = Predictor(CFG, tree, serve_batch=4, device="cpu")
    feats, nf = _batch(7, seed=2)
    probs = p.predict(feats, nf)
    np.testing.assert_allclose(p.predict(feats[3:4], nf[3:4]), probs[3:4],
                               rtol=1e-5, atol=1e-6)
    assert p.predict(feats[:0], nf[:0]).shape == (0, CFG.num_classes)


@pytest.mark.parametrize("depth", [1, 2, 8])
def test_ring_depths_keep_chunk_order(tree, depth):
    """10 requests, 3 chunks of 4: the lag-N ring drains FIFO at every
    depth, including depth > #chunks (all drained in the tail loop)."""
    feats, nf = _batch(10, seed=4)
    want = Predictor(CFG, tree, serve_batch=10, device="cpu").predict(feats, nf)
    p = Predictor(CFG, tree, serve_batch=4, device="cpu", fetch_depth=depth)
    np.testing.assert_allclose(p.predict(feats, nf), want, rtol=1e-5,
                               atol=1e-6)


def test_topk_matches_jax_predictor(tree):
    feats, nf = _batch(4, seed=3)
    want_vals, want_idx = JaxPredictor(CFG, tree, serve_batch=4).predict_topk(
        feats, nf, k=5)
    vals, idx = Predictor(CFG, tree, serve_batch=4,
                          device="cpu").predict_topk(feats, nf, k=5)
    assert np.all(np.diff(vals, axis=1) <= 0)  # sorted, descending
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(vals, want_vals, atol=1e-5)


def test_module_from_seeded_init(tree):
    """A Predictor takes an nn.Module too; the seeded init is
    reproducible and has the JAX tree's layout."""
    feats, nf = _batch(3, seed=5)
    a = init_model(CFG, prng.prng_key(7))
    b = init_model(CFG, prng.prng_key(7))
    pa = Predictor(CFG, a, serve_batch=4, device="cpu").predict(feats, nf)
    pb = Predictor(CFG, b, serve_batch=4, device="cpu").predict(feats, nf)
    np.testing.assert_array_equal(pa, pb)
    assert np.all(np.isfinite(pa)) and np.all((pa >= 0) & (pa <= 1))
    assert (jax.tree.map(np.shape, to_jax_params(a))
            == jax.tree.map(np.shape, tree))


def test_unsupported_options_raise(tree, tmp_path):
    # the JAX Predictor's refusals over a mesh (serving.py:147-149, :208-211)
    with pytest.raises(ValueError, match="int8.*sequence_parallel"):
        Predictor(CFG, tree, device="cpu", quantize="int8", sequence_parallel=True)
    with pytest.raises(ValueError, match="requires HierarchicalLstmModel"):
        Predictor(CFG.replace(model="DbofModel"), tree, device="cpu",
                  sequence_parallel=True)
    # a directory named as an orbax checkpoint, without orbax's metadata:
    # the orbax reader's own error
    (tmp_path / "model.ckpt-5").mkdir()
    with pytest.raises(OrbaxFormatError, match="not an orbax checkpoint"):
        Predictor.from_checkpoint(str(tmp_path), CFG, device="cpu")
    with pytest.raises(ValueError):
        Predictor(CFG, tree, tower="both", device="cpu")
    with pytest.raises(ValueError):
        Predictor(CFG, tree, quantize="fp8", device="cpu")
