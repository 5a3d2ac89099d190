"""The port's HierarchicalLstmModel + MoeModel forward against the JAX
`apply` on the same weights (JAX init, numpy bridge) and inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.models import get_model as jax_get_model
from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params

torch.set_num_threads(1)

D, V, H, K = 8, 30, 8, 2


@pytest.fixture(scope="module")
def models():
    kw = dict(lstm_cells=H, lstm_layers=2, classifier="MoeModel",
              classifier_kwargs={"num_mixtures": K})
    jparams = jax_get_model("HierarchicalLstmModel").init(
        jax.random.PRNGKey(0), D, V, **kw)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    for level in ("rnn_l1", "rnn_l2"):  # non-zero biases
        for layer in tree[level]:
            layer["bias"] = rng.normal(0, 0.3, layer["bias"].shape).astype(np.float32)
    tree["classifier"]["experts"]["b"] = rng.normal(
        0, 0.3, (K, V)).astype(np.float32)
    tmodel = load_jax_params(get_model("HierarchicalLstmModel")(D, V, **kw), tree)
    return jax.tree.map(jnp.asarray, tree), tmodel


# (tower, frames, chunks): the student at num_inputs_L1=2, the teacher at
# num_inputs_to_lstm=4
TOWERS = [("student", 10, 2), ("teacher", 20, 4)]


def _inputs(T, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, T, D)).astype(np.float32)
    nf = np.array([0, 1, T // 2, T - 1, T, 3], np.int32)
    return x, nf


def _forward(models, x, nf, chunks, dtype, use_kernel=False):
    jparams, tmodel = models
    want = jax_get_model("HierarchicalLstmModel").apply(
        jparams, jnp.asarray(x), V, jnp.asarray(nf), num_chunks=chunks,
        compute_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32,
        num_mixtures=K)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(nf),
                     num_chunks=chunks, classifier="MoeModel",
                     compute_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
                     use_kernel=use_kernel, num_mixtures=K)
    return got, want


@pytest.mark.parametrize("tower,T,chunks", TOWERS)
def test_forward_matches_jax_f32(models, tower, T, chunks):
    x, nf = _inputs(T, seed=1)
    got, want = _forward(models, x, nf, chunks, "f32")
    for key in ("state", "predictions"):
        assert got[key].dtype == torch.float32
        # same f32 math, other summation order
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)
    np.testing.assert_allclose(float(got["regularization_loss"]),
                               float(want["regularization_loss"]), rtol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("tower,T,chunks", TOWERS)
def test_forward_matches_jax_bf16(models, tower, T, chunks, use_kernel):
    """bf16 through the plain scan and through the kernel's wrapper (its
    plain version, since the tensors lie on the CPU). The JAX side runs
    its bf16 XLA scan, which the Pallas kernel matches bit for bit."""
    x, nf = _inputs(T, seed=2)
    got, want = _forward(models, x, nf, chunks, "bf16", use_kernel)
    # bf16 operands rounded at the same places and f32 sums on both
    # sides: agreement to f32 summation order (1.2e-7 measured)
    for key in ("state", "predictions"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5)


def test_forward_rejects_a_chunking_that_does_not_divide(models):
    _, tmodel = models
    with pytest.raises(ValueError):
        tmodel(torch.zeros(2, 9, D), torch.ones(2), num_chunks=2)
    with pytest.raises(ValueError):
        tmodel(torch.zeros(2, 10, D), torch.ones(2), num_chunks=2,
               classifier="LogisticModel")
