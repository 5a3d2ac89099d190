"""The numpy parameter bridge between the JAX pytree and the port's
modules: a name map with no transposes, exact both ways, and checked."""

import numpy as np
import jax
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.models import get_model as jax_get_model
from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.weights import (
    load_jax_params,
    to_jax_params,
)

torch.set_num_threads(1)

KW = dict(lstm_cells=8, lstm_layers=2, classifier="MoeModel",
          classifier_kwargs={"num_mixtures": 2})


def _tree(seed=0):
    return jax.tree.map(np.asarray, jax_get_model("HierarchicalLstmModel").init(
        jax.random.PRNGKey(seed), 8, 30, **KW))


def _module():
    return get_model("HierarchicalLstmModel")(8, 30, **KW)


def test_round_trip_is_exact():
    tree = _tree()
    model = load_jax_params(_module(), tree)
    assert torch.equal(model.rnn_l2[1].kernel,
                       torch.from_numpy(np.array(tree["rnn_l2"][1]["kernel"])))
    assert torch.equal(model.classifier.gates.w,
                       torch.from_numpy(np.array(tree["classifier"]["gates"]["w"])))
    back = to_jax_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_float64_tree_loads_bit_exactly_into_a_float64_module():
    from efficientvideoclassification_youtube8m_torch.ops.lstm import init_multi_lstm

    rng = np.random.default_rng(0)
    tree = [{"kernel": rng.normal(size=(13, 20)), "bias": rng.normal(size=20)}]
    model = load_jax_params(init_multi_lstm(None, 8, 5, 1, dtype=torch.float64),
                            tree)
    assert model[0].kernel.dtype == torch.float64
    assert torch.equal(model[0].kernel, torch.from_numpy(tree[0]["kernel"]))
    assert torch.equal(model[0].bias, torch.from_numpy(tree[0]["bias"]))


def test_mismatches_raise_before_anything_is_copied():
    model = _module()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tree = _tree()
    tree["classifier"]["experts"]["b"] = np.zeros((3, 30), np.float32)
    with pytest.raises(ValueError, match="experts.b"):
        load_jax_params(model, tree)
    tree = _tree()
    del tree["rnn_l1"][1]
    with pytest.raises(KeyError, match="rnn_l1.1.kernel"):
        load_jax_params(model, tree)
    tree = _tree()
    tree["extra"] = {"w": np.zeros(2, np.float32)}
    with pytest.raises(KeyError, match="extra.w"):
        load_jax_params(model, tree)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
