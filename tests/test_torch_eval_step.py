"""The port's eval, int8 eval and validate steps against the JAX
package's, on the CPU at a tiny config, from the same JAX init and the
same uint8 batch; and the packed host bundle read back by the JAX
package's `parallel.distributed.unpack_host_pack`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.models import get_model as jax_get_model
from efficientvideoclassification_youtube8m_tpu.ops import quantize as jq
from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
    host_subsample as jax_host_subsample,
)
from efficientvideoclassification_youtube8m_tpu.parallel.distributed import (
    unpack_host_pack,
)
from efficientvideoclassification_youtube8m_tpu.train import step as jstep
# the port's config: the JAX functions read the same fields (test_torch_summary_flags.py)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.state import init_model
from efficientvideoclassification_youtube8m_torch.weights import (
    load_jax_params,
    load_jax_quantized_params,
)

torch.set_num_threads(1)

TINY = TrainConfig(
    num_classes=30, batch_size=8, lstm_cells=8, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
    compute_dtype="float32",
)
TOP_K = 5
# f32 math in another summation order (and, on the int8 path, activation
# scales an ulp apart where XLA multiplies by the reciprocal of 127):
# 3.0e-8 measured on the predictions and top-k values, 1.9e-6 on the
# per-example CE (a sum of 30 log terms, about 14), 0 on PERR; the
# validate step's loss scalars 9.5e-7 (label losses, 1e-7 relative) and
# 3.8e-7 (L_PRED, a batch sum of nearly cancelling terms).
TOL = 1e-5
OUT_KEYS = ("predictions", "per_example_loss", "topk_val", "perr_precision")


@pytest.fixture(scope="module")
def tree():
    cfg = TINY
    return jax.tree.map(np.asarray, jax_get_model(cfg.model).init(
        jax.random.PRNGKey(0), cfg.total_feature_size, cfg.num_classes,
        lstm_cells=cfg.lstm_cells, lstm_layers=cfg.lstm_layers,
        classifier=cfg.video_level_classifier_model,
        classifier_kwargs={"num_mixtures": cfg.moe_num_mixtures}))


@pytest.fixture(scope="module")
def batch():
    cfg = TINY
    rng = np.random.default_rng(0)
    B = cfg.batch_size
    feats = rng.integers(0, 256, size=(B, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    labels = np.zeros((B, cfg.num_classes), bool)
    for i in range(B):
        labels[i, rng.choice(cfg.num_classes, 1 + i % 4, replace=False)] = True
    labels[-1] = False  # a row without labels: PERR 0
    nf = rng.integers(0, cfg.max_num_frames + 1, size=B).astype(np.int32)
    return feats, labels, nf


def _compare(got, want):
    """The port's outputs against the JAX step's; the port's host pack
    read back by JAX's reader gives the port's own top-k, CE and PERR."""
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["topk_idx"], want["topk_idx"])
    for key in OUT_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL,
                                   err_msg=key)
    assert got["host_pack"].shape == want["host_pack"].shape
    read = unpack_host_pack(got["host_pack"], None)
    np.testing.assert_array_equal(read["topk_idx"], got["topk_idx"])
    for key in ("topk_val", "per_example_loss", "perr_precision"):
        np.testing.assert_array_equal(read[key], got[key])


@pytest.mark.parametrize("host_subsampled", [False, True])
def test_eval_step_matches_jax(tree, batch, host_subsampled):
    feats, labels, nf = batch
    if host_subsampled:
        feats = np.asarray(jax_host_subsample(feats, TINY.every_n))
    want = jax.jit(jstep.build_eval_step(
        TINY, TOP_K, host_subsampled=host_subsampled))(
        tree, *map(jnp.asarray, (feats, labels, nf)))
    student = load_jax_params(init_model(TINY), tree)
    got = tstep.build_eval_step(TINY, TOP_K, host_subsampled=host_subsampled)(
        student, *map(torch.from_numpy, (feats, labels, nf)))
    _compare(got, want)


def test_eval_step_kernel_override(tree, batch):
    """`kernel_override=True` forces the forward-only kernel path (its
    plain bf16 version on the CPU), as `pallas_override=True` forces the
    Pallas path; at bf16 it agrees with the plain bf16 scan."""
    cfg = TINY.replace(compute_dtype="bfloat16")
    student = load_jax_params(init_model(cfg), tree)
    args = tuple(map(torch.from_numpy, batch))
    forced = tstep.build_eval_step(cfg, TOP_K, kernel_override=True)(student, *args)
    plain = tstep.build_eval_step(cfg, TOP_K)(student, *args)
    np.testing.assert_allclose(forced["predictions"].numpy(),
                               plain["predictions"].numpy(), atol=TOL)


def test_quantized_eval_step_matches_jax(tree, batch):
    qtree = jax.tree.map(np.asarray, jq.quantize_hierarchical_params(
        tree, TINY.total_feature_size, TINY.lstm_cells, TINY.lstm_layers))
    want = jax.jit(jstep.build_quantized_eval_step(TINY, TOP_K))(
        jax.tree.map(jnp.asarray, qtree), *map(jnp.asarray, batch))
    got = tstep.build_quantized_eval_step(TINY, TOP_K)(
        load_jax_quantized_params(qtree), *map(torch.from_numpy, batch))
    _compare(got, want)


def test_validate_step_matches_jax(tree, batch):
    """Both towers forward-only from the same weights (the teacher's tree
    serves as the student's too): the eight loss scalars and the
    student's eval outputs."""
    want = jax.jit(jstep.build_validate_step(TINY, TOP_K))(
        tree, tree, *map(jnp.asarray, batch))
    model = load_jax_params(init_model(TINY), tree)
    got = tstep.build_validate_step(TINY, TOP_K)(
        model, model, *map(torch.from_numpy, batch))
    losses = [k for k in got if k not in want or np.ndim(want[k]) == 0]
    assert len(losses) == 8
    for key in losses:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=TOL, atol=1e-6, err_msg=key)
    _compare({k: got[k] for k in (*OUT_KEYS, "topk_idx", "host_pack")}, want)


@pytest.mark.parametrize("num_classes,k", [
    (tstep.PACKED_IDX_MAX + 1, 5),  # paired layout, odd k (one pad lane)
    (tstep.PACKED_IDX_MAX + 1, 20),  # paired, even k
    (tstep.PACKED_IDX_MAX + 2, 5),  # wide: num_classes - 1 above the cap
])
def test_host_pack_matches_jax_and_reads_back(num_classes, k):
    """The port's pack is the JAX pack bit for bit, in both layouts, and
    `unpack_host_pack` reads it back to the same top-k, CE and PERR;
    boundary ids 0 and num_classes - 1 included."""
    rng = np.random.default_rng(k)
    B = 6
    vals = np.sort(rng.random((B, k)).astype(np.float32), axis=1)[:, ::-1].copy()
    idx = rng.integers(0, num_classes, size=(B, k)).astype(np.int32)
    idx[0, 0], idx[-1, -1] = 0, num_classes - 1
    loss = rng.random(B).astype(np.float32) * 50
    perr = rng.random(B).astype(np.float32)
    got = tstep._pack_host_outputs(*map(torch.from_numpy, (vals, idx, loss, perr)),
                                   num_classes=num_classes).numpy()
    want = np.asarray(jstep._pack_host_outputs(
        *map(jnp.asarray, (vals, idx, loss, perr)), num_classes=num_classes))
    paired = num_classes - 1 <= tstep.PACKED_IDX_MAX
    assert got.shape == (B, k + (k + 1) // 2 + 2 if paired else 2 * k + 2)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    read = unpack_host_pack(got, None)
    np.testing.assert_array_equal(read["topk_idx"], idx)
    np.testing.assert_array_equal(read["topk_val"], vals)
    np.testing.assert_array_equal(read["per_example_loss"], loss)
    np.testing.assert_array_equal(read["perr_precision"], perr)


def test_eval_step_guards():
    with pytest.raises(ValueError, match="flagship"):
        tstep.build_quantized_eval_step(TINY.replace(model="DbofModel"))
    with pytest.raises(ValueError, match="flagship"):
        tstep.build_quantized_eval_step(
            TINY.replace(video_level_classifier_model="LogisticModel"))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the model zoo and losses"):
        tstep.build_eval_step(TINY, aggregated=True)
    dbof = TINY.replace(model="DbofModel")
    with pytest.raises(NotImplementedError, match="DbofModel"):
        tstep.build_eval_step(dbof)
    with pytest.raises(NotImplementedError, match="DbofModel"):
        tstep.build_validate_step(dbof)
