"""The port's losses against the JAX package's: the label loss and the
two distillation losses, values and gradients, on the same numpy
inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu import losses as jlosses
from efficientvideoclassification_youtube8m_torch import losses as tlosses

B, V = 6, 30


def _preds(seed):
    rng = np.random.default_rng(seed)
    p = (1.0 / (1.0 + np.exp(-rng.normal(0, 2, size=(B, V))))).astype(np.float32)
    labels = rng.random((B, V)) < 0.1
    return p, labels


def test_cross_entropy_matches_jax():
    p, labels = _preds(0)
    want_v, want_g = jax.value_and_grad(jlosses.cross_entropy_loss)(
        jnp.asarray(p), jnp.asarray(labels))
    x = torch.from_numpy(p).requires_grad_(True)
    got = tlosses.get_loss("CrossEntropyLoss")(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(got, x)
    # the same f32 elementwise math; the sums differ in order only
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-9)


def test_representation_loss_matches_jax_and_detaches_the_teacher():
    rng = np.random.default_rng(1)
    t, s = (rng.normal(size=(B, 16)).astype(np.float32) for _ in range(2))
    want_v, (want_gt, want_gs) = jax.value_and_grad(
        jlosses.representation_loss, argnums=(0, 1))(jnp.asarray(t), jnp.asarray(s))
    tt, ts = (torch.from_numpy(a).requires_grad_(True) for a in (t, s))
    got = tlosses.representation_loss(tt, ts)
    gt, gs = torch.autograd.grad(got, (tt, ts), allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-6)
    np.testing.assert_allclose(gs.numpy(), np.asarray(want_gs), rtol=1e-6)
    assert gt is None and not np.any(np.asarray(want_gt))


@pytest.mark.parametrize("zero_row", [False, True])
def test_prediction_kl_matches_jax(zero_row):
    """A batch SUM of the KL. With an all-zero row on either side (every
    class underflowed) the epsilon guards keep the loss finite, as in
    JAX; the gradient of an all-zero STUDENT row is not finite on either
    side (1/epsilon twice overflows f32), the other rows' agree."""
    t, _ = _preds(2)
    s, _ = _preds(3)
    if zero_row:
        s[2] = 0.0
        t[4] = 0.0
    want_v, want_g = jax.value_and_grad(jlosses.prediction_kl_loss, argnums=1)(
        jnp.asarray(t), jnp.asarray(s))
    want_g = np.asarray(want_g)
    ts = torch.from_numpy(s).requires_grad_(True)
    got = tlosses.prediction_kl_loss(torch.from_numpy(t), ts)
    (g,) = torch.autograd.grad(got, ts)
    g = g.numpy()
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-5)
    finite = np.isfinite(want_g).all(axis=1)
    assert np.array_equal(np.isfinite(g).all(axis=1), finite)
    assert finite.sum() == B - int(zero_row)
    np.testing.assert_allclose(g[finite], want_g[finite], rtol=1e-5, atol=1e-6)


def test_prediction_kl_is_a_batch_sum():
    t, _ = _preds(4)
    s, _ = _preds(5)
    whole = tlosses.prediction_kl_loss(torch.from_numpy(t), torch.from_numpy(s))
    rows = sum(tlosses.prediction_kl_loss(torch.from_numpy(t[i:i + 1]),
                                          torch.from_numpy(s[i:i + 1]))
               for i in range(B))
    np.testing.assert_allclose(whole.item(), rows.item(), rtol=1e-6)


@pytest.mark.parametrize("name", [
    "CrossEntropyLossWithSparsity", "CrossEntropyLossTop50", "PWELoss",
    "CrossEntropyLossClassImbalance", "CrossEntropyLossPositives", "NewLoss",
    "HingeLoss", "SoftmaxLoss"])
def test_unported_losses_raise(name):
    assert name in jlosses.LOSS_REGISTRY
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the model zoo and losses"):
        tlosses.get_loss(name)


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        tlosses.get_loss("BogusLoss")
