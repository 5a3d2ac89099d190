"""The PyTorch port's preprocessing against the JAX package's, on the
same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.ops import preprocess as jpre
from efficientvideoclassification_youtube8m_tpu.train.step import (
    preprocess_batch as jax_preprocess_batch,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.ops import preprocess as tpre
from efficientvideoclassification_youtube8m_torch.train.step import (
    preprocess_batch,
)

torch.set_num_threads(1)

CFG = TrainConfig(feature_sizes="6, 2", max_num_frames=12)


def test_dequantize_and_l2_normalize_match_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (3, 7, 10), dtype=np.uint8)
    want = np.asarray(jpre.l2_normalize(jpre.dequantize(jnp.asarray(u8)),
                                        axis=2))
    deq = tpre.dequantize(torch.from_numpy(u8))
    np.testing.assert_array_equal(  # same f32 formula: exact
        deq.numpy(), np.asarray(jpre.dequantize(jnp.asarray(u8))))
    # rsqrt may differ by an ulp between the two libraries
    np.testing.assert_allclose(tpre.l2_normalize(deq, dim=2).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    zeros = torch.zeros(2, 4)  # the epsilon keeps an all-zero row finite
    assert torch.equal(tpre.l2_normalize(zeros), zeros)
    with pytest.raises(ValueError):
        tpre.dequantize(torch.zeros(1), 1.0, 1.0)


@pytest.mark.parametrize("every_n", [2, 3, 10])
def test_student_num_frames_bit_equal_to_jax(every_n):
    nf = np.arange(0, 301, dtype=np.int32)
    want = np.asarray(jpre.student_num_frames(jnp.asarray(nf), every_n))
    got = tpre.student_num_frames(torch.from_numpy(nf), every_n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # counts above max_frames are capped like the JAX table lookup
    over = tpre.student_num_frames(torch.tensor([301, 1000]), every_n)
    np.testing.assert_array_equal(over.numpy(), [want[-1]] * 2)


def test_subsample_and_resize_axis_match_jax():
    x = np.random.default_rng(1).normal(size=(2, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tpre.uniform_subsample(torch.from_numpy(x), 4).numpy(),
        np.asarray(jpre.uniform_subsample(jnp.asarray(x), 4)))
    u8 = (np.arange(2 * 9 * 3) % 256).astype(np.uint8).reshape(2, 9, 3)
    strided = tpre.host_subsample(u8, 3)
    assert strided.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(strided, jpre.host_subsample(u8, 3))
    for size in (4, 9, 13):
        np.testing.assert_array_equal(
            tpre.resize_axis(torch.from_numpy(x), 1, size, 7.0).numpy(),
            np.asarray(jpre.resize_axis(jnp.asarray(x), 1, size, 7.0)))


def test_preprocess_batch_zeroes_padding_exactly():
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (4, CFG.max_num_frames, 8), dtype=np.uint8)
    nf = np.array([0, 3, 12, 7], np.int32)
    want = np.asarray(jax_preprocess_batch(CFG, jnp.asarray(u8),
                                           jnp.asarray(nf)))
    got = preprocess_batch(CFG, torch.from_numpy(u8),
                           torch.from_numpy(nf)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for b, n in enumerate(nf):
        assert np.all(got[b, n:] == 0.0)
        assert np.all(np.abs(got[b, :n]).sum(-1) > 0)
