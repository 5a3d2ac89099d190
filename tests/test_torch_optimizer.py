"""The port's TF-semantics optimizers and schedule against the JAX
package's: the staircase decay, the per-variable clip, and two updates of
each optimizer on the same parameters and gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.train import optimizer as jopt
from efficientvideoclassification_youtube8m_torch.train import optimizer as topt


def test_exponential_decay_staircase():
    """tests/test_train.py:62-69 for the port."""
    sched = topt.exponential_decay(0.01, 256, 1000000, 0.95)
    np.testing.assert_allclose(float(sched(0)), 0.01)
    np.testing.assert_allclose(float(sched(3906)), 0.01)
    np.testing.assert_allclose(float(sched(3907)), 0.0095)
    np.testing.assert_allclose(float(sched(2 * 3907)), 0.01 * 0.95 ** 2)
    assert sched(3907).dtype == torch.float32


@pytest.mark.parametrize("step", [0, 7, 3906, 3907, 123456])
def test_exponential_decay_matches_jax(step):
    args = (0.001, 256, 4000000.0, 0.95)
    want = float(jopt.exponential_decay(*args)(jnp.asarray(step, jnp.int32)))
    assert float(topt.exponential_decay(*args)(step)) == want


def test_per_variable_clip():
    grads = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.3, 0.4]),
             "z": torch.zeros(3)}
    clipped = topt.clip_grads_per_variable(grads, 1.0)
    np.testing.assert_allclose(clipped["a"].numpy(), [0.6, 0.8], rtol=1e-6)
    np.testing.assert_allclose(clipped["b"].numpy(), [0.3, 0.4], rtol=1e-6)
    assert torch.equal(clipped["z"], torch.zeros(3))  # norm floored, no NaN


OPTIMIZERS = ["AdamOptimizer", "GradientDescentOptimizer", "MomentumOptimizer",
              "RMSPropOptimizer", "AdagradOptimizer"]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_two_updates_match_jax(name):
    """Two clipped updates at two learning rates; one gradient tensor is
    large enough to be clipped, one is not."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{"w": rng.normal(0, 3, size=(4, 5)).astype(np.float32),
              "b": rng.normal(0, 0.05, size=(5,)).astype(np.float32)}
             for _ in range(2)]
    lrs = [0.01, 0.005]

    jo = jopt.make_optimizer(name, clip_gradient_norm=1.0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    for g, lr in zip(grads, lrs):
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp,
                           jnp.asarray(lr, jnp.float32))

    to = topt.make_optimizer(name, clip_gradient_norm=1.0)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    ts = to.init(tp)
    for g, lr in zip(grads, lrs):
        ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                       torch.tensor(lr))
    # the same f32 elementwise math in the same order (FMA contraction
    # may differ by an ulp)
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    if name == "AdamOptimizer":
        assert ts["count"] == int(js.count) == 2
        for k in params:
            np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js.mu[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js.nu[k]),
                                       rtol=1e-6)


def test_tf_adam_keeps_epsilon_outside_the_bias_correction():
    """One Adam step on a scalar: lr*sqrt(1-b2)/(1-b1) * m/(sqrt(v)+eps);
    torch.optim.Adam would give lr * m_hat/(sqrt(v_hat)+eps)."""
    opt = topt.make_optimizer("AdamOptimizer", clip_gradient_norm=0.0)
    w = torch.tensor(1.0, requires_grad=True)
    state = opt.init({"w": w})
    g = 1e-6  # small enough that the epsilon placement shows
    opt.update({"w": torch.tensor(g)}, state, {"w": w}, 0.01)
    b1, b2, eps = 0.9, 0.999, 1e-8
    m, v = (1 - b1) * g, (1 - b2) * g * g
    want = 1.0 - 0.01 * np.sqrt(1 - b2) / (1 - b1) * m / (np.sqrt(v) + eps)
    np.testing.assert_allclose(w.item(), want, rtol=1e-7)
    assert not w.requires_grad or w.grad is None


def test_rmsprop_starts_ms_at_ones():
    state = topt.make_optimizer("RMSPropOptimizer").init({"w": torch.zeros(3)})
    assert torch.equal(state["ms"]["w"], torch.ones(3))


def test_unknown_optimizer():
    with pytest.raises(ValueError):
        topt.make_optimizer("BogusOptimizer")
