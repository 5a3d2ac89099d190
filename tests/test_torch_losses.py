"""The port's losses against the JAX package's: the nine label losses and
the two distillation losses, values and gradients, on the same numpy
inputs. The label losses agree within 1e-5 relative (1.2e-7 measured),
gradients within 1e-5 of their largest element (2.0e-7 measured): f32
sums in another order."""

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
    """The eight losses that raised before the zoo was ported now resolve
    to the port's own functions (their parity is test_label_loss_matches_jax)."""
    assert name in jlosses.LOSS_REGISTRY
    assert tlosses.get_loss(name) is tlosses.LOSS_REGISTRY[name]


V_TOP = 60  # CrossEntropyLossTop50 takes the top 50 of each row
COUNTS = np.arange(1, V_TOP + 1) * 1000


def _top50_preds(seed):
    """Rows with ties at the 50th value, so the `>=` mask keeps more."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.01, 0.99, size=(B, V_TOP)).astype(np.float32)
    p[:, 5:15] = p[:, 5:6]  # ten equal values somewhere in the row
    p[0] = np.sort(p[0])
    p[0, 9:12] = p[0, 10]  # a tie across the 50th position (index 10 of 60)
    labels = rng.random((B, V_TOP)) < 0.1
    return p, labels


@pytest.mark.parametrize("name,kw", [
    ("CrossEntropyLoss", {}),
    ("CrossEntropyLossWithSparsity", {}),
    ("CrossEntropyLossTop50", {}),
    ("PWELoss", {}),
    ("CrossEntropyLossClassImbalance", {"class_counts": list(COUNTS)}),
    ("CrossEntropyLossPositives", {}),
    ("NewLoss", {}),
    ("HingeLoss", {}),
    ("SoftmaxLoss", {}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_label_loss_matches_jax(name, kw, seed):
    p, labels = _top50_preds(seed)
    if name == "SoftmaxLoss":
        labels[1] = False  # a row without labels: the 10e-8 row-sum floor
    want_v, want_g = jax.value_and_grad(jlosses.get_loss(name))(
        jnp.asarray(p), jnp.asarray(labels), **kw)
    x = torch.from_numpy(p).requires_grad_(True)
    got = tlosses.get_loss(name)(x, torch.from_numpy(labels), **kw)
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want_v), rtol=1e-5)
    want_g = np.asarray(want_g)
    assert np.max(np.abs(g.numpy() - want_g)) <= 1e-5 * np.max(np.abs(want_g))


def test_new_loss_takes_the_batch_minimum():
    """The negatives' threshold is the least positive probability of the
    WHOLE batch: a row's loss depends on the other rows."""
    p, labels = _top50_preds(3)
    labels[:, 0] = True
    loss = tlosses.get_loss("NewLoss")
    whole = loss(torch.from_numpy(p), torch.from_numpy(labels))
    p2 = p.copy()
    p2[B - 1, 0] = 0.3  # a low positive in the last row only
    moved = loss(torch.from_numpy(p2[:-1]), torch.from_numpy(labels[:-1]))
    together = loss(torch.from_numpy(p2), torch.from_numpy(labels))
    want = jlosses.get_loss("NewLoss")(jnp.asarray(p2), jnp.asarray(labels))
    np.testing.assert_allclose(together.item(), float(want), rtol=1e-5)
    assert together.item() != whole.item() and moved.item() != together.item()


def test_pwe_faithful_batch_contract():
    """Under faithful_quirks the reshape to 128 rows is kept: batch 128
    agrees with JAX's, any other batch raises in both packages."""
    rng = np.random.default_rng(4)
    p = rng.uniform(0.05, 0.95, size=(128, 12)).astype(np.float32)
    labels = rng.random((128, 12)) < 0.2
    want = jlosses.pwe_loss(jnp.asarray(p), jnp.asarray(labels), faithful_quirks=True)
    got = tlosses.pwe_loss(torch.from_numpy(p), torch.from_numpy(labels),
                           faithful_quirks=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(TypeError):
        jlosses.pwe_loss(jnp.asarray(p[:8]), jnp.asarray(labels[:8]), faithful_quirks=True)
    with pytest.raises(ValueError, match="128"):
        tlosses.pwe_loss(torch.from_numpy(p[:8]), torch.from_numpy(labels[:8]),
                         faithful_quirks=True)


def test_class_imbalance_needs_counts():
    p, labels = _top50_preds(5)
    with pytest.raises(ValueError, match="class_counts"):
        tlosses.get_loss("CrossEntropyLossClassImbalance")(
            torch.from_numpy(p), torch.from_numpy(labels))


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        tlosses.get_loss("BogusLoss")
