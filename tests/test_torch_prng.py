"""The port's threefry PRNG (ops/prng.py) and the initial weights it
draws, against `jax.random` and the JAX package's inits on the CPU: keys,
splits, folds, uniform and Bernoulli draws bit for bit (with keys folded
from a tensor too), normal draws within 3 ulp (bit for bit on about
99.5%: XLA's ErfInv polynomial is reproduced, the rounding of its `log`
is not), and the distill state (teacher and student) and the finetune
student that a seed gives, bit for bit."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.ops import lstm as jlstm
from efficientvideoclassification_youtube8m_tpu.train import optimizer as joptimizer
from efficientvideoclassification_youtube8m_tpu.train import state as jstate
from efficientvideoclassification_youtube8m_torch.ops import lstm as tlstm
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.weights import to_jax_params

torch.set_num_threads(1)

TINY = TrainConfig(
    num_classes=40, batch_size=8, lstm_cells=8, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
)
SEEDS = [0, 1, 3, 123456789, 2 ** 31 - 1]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_trees_bit_equal(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_trees_bit_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_bit_equal(g, w, f"{where}/{i}")
    else:
        assert np.shape(got) == np.shape(want), where
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=where)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split(seed):
    key = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == tuple(int(v) for v in np.asarray(key))
    for num in (1, 2, 3, 7):
        want = [tuple(int(v) for v in row)
                for row in np.asarray(jax.random.split(key, num))]
        assert prng.split(prng.prng_key(seed), num) == want


def test_key_rejects_seeds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.prng_key(2 ** 31)


@pytest.mark.parametrize("shape,lo,hi", [
    ((1,), 0.0, 1.0),
    ((3, 5), -0.3, 0.3),
    ((17,), -1.0, 2.5),
    ((1000, 33), -0.01, 0.01),
    ((200, 4, 50), -math.sqrt(6 / 1400), math.sqrt(6 / 1400)),
])
@pytest.mark.parametrize("seed", [0, 5])
def test_uniform_is_jax_uniform(shape, lo, hi, seed):
    """Every draw's bits, the fused-multiply-add rounding of the scale
    and shift included (half the values differ by an ulp without it)."""
    want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32,
                              minval=lo, maxval=hi)
    got = prng.uniform(prng.prng_key(seed), shape, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_uniform_chunks_join_seamlessly(monkeypatch):
    """A draw longer than one chunk of the hash is the same draw."""
    whole = prng.uniform((4, 9), (37, 11), -1.0, 1.0)
    monkeypatch.setattr(prng, "_CHUNK", 50)
    np.testing.assert_array_equal(
        prng.uniform((4, 9), (37, 11), -1.0, 1.0).numpy(), whole.numpy())


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_multi_lstm_init_is_jax_init(num_layers):
    key = jax.random.PRNGKey(num_layers)
    want = jax.tree.map(np.asarray, jlstm.init_multi_lstm(key, 12, 8, num_layers))
    got = to_jax_params(tlstm.init_multi_lstm(prng.prng_key(num_layers), 12, 8,
                                              num_layers))
    _assert_trees_bit_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_distill_state_init_is_jax_init(seed):
    """A seed gives both packages the same teacher and student weights:
    the gate's runs start where the JAX package's do."""
    cfg = TINY.replace(seed=seed)
    want = jstate.init_distill_state(cfg, joptimizer.make_optimizer(cfg.optimizer))
    got = init_distill_state(cfg, make_optimizer(cfg.optimizer))
    _assert_trees_bit_equal(to_jax_params(got.teacher),
                            jax.tree.map(np.asarray, want.params_teacher), "teacher")
    _assert_trees_bit_equal(to_jax_params(got.student),
                            jax.tree.map(np.asarray, want.params_student), "student")
    # the two towers differ
    assert not np.array_equal(to_jax_params(got.teacher)["rnn_l1"][0]["kernel"],
                              to_jax_params(got.student)["rnn_l1"][0]["kernel"])


def test_finetune_student_key_is_the_distill_students():
    """cli.finetune --start_new_model draws the student of a fresh distill
    state, as the JAX finetune does."""
    cfg = TINY.replace(seed=9)
    want = jstate.init_distill_state(cfg, joptimizer.make_optimizer(cfg.optimizer))
    got = init_model(cfg, prng.split(prng.prng_key(cfg.seed))[1])
    _assert_trees_bit_equal(to_jax_params(got),
                            jax.tree.map(np.asarray, want.params_student))


def _key_ints(key):
    return tuple(int(v) for v in key)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_fold_in_is_jax_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 5, 123456, 2 ** 31 - 1):
        want = _key_ints(np.asarray(jax.random.fold_in(key, data)))
        assert prng.fold_in(prng.prng_key(seed), data) == want
        # a device value (the eval rngs fold in sum(num_frames)) gives a
        # tensor key with the same words, and its split and draws follow
        folded = prng.fold_in(prng.prng_key(seed), torch.tensor(data, dtype=torch.int32))
        assert all(isinstance(w, torch.Tensor) for w in folded)
        assert _key_ints(folded) == want
        jsplit = np.asarray(jax.random.split(jax.random.fold_in(key, data), 3))
        assert [_key_ints(k) for k in prng.split(folded, 3)] == [_key_ints(r) for r in jsplit]
    assert prng.fold_in(prng.prng_key(seed), -3) == _key_ints(
        np.asarray(jax.random.fold_in(key, jnp.int32(-3))))
    # fold_in(k, i) is key i of a partitionable split
    assert prng.fold_in(prng.prng_key(seed), 2) == prng.split(prng.prng_key(seed), 3)[2]


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 0.9, 1.0])
def test_bernoulli_is_jax_bernoulli(p):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.bernoulli(key, jnp.float32(p), (7, 45)))
    for tkey in (prng.fold_in(prng.prng_key(3), 11),
                 prng.fold_in(prng.prng_key(3), torch.tensor(11))):
        got = prng.bernoulli(tkey, torch.tensor(p), (7, 45))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,shape", [(0, (200000,)), (4, (33, 17)), (9, (1,))])
def test_normal_is_jax_normal_within_3_ulp(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    assert ulps.max() <= 3
    if want.size > 1000:
        assert np.mean(ulps == 0) > 0.99


def test_erf_inv_edges_are_xla_edges():
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.array([lo, -0.5, 0.0, 1e-30, 0.5, 0.999, 1.0, -1.0], np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    ulps = np.abs(got[finite].view(np.int32).astype(np.int64)
                  - want[finite].view(np.int32))
    assert ulps.max() <= 2
