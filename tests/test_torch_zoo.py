"""The port's model zoo against the JAX package's on the CPU: every model
and head of the JAX registry (tests/test_models.py's models), its init
from a key, its forward, its loss and its gradients on weights carried
across by `weights.load_jax_params`, the frame samplers and dropout masks
bit for bit, and DBoF's batch-norm statistics.

Tolerances, f32 on both sides (sums in another order): predictions and
losses within 1e-5 relative (3.1e-6 measured, the summed matrix loss of
LinearRegressionWeightedMeanEnsembleDifferenceLoss); each gradient
tensor within 1e-5 of its largest element (5.6e-6 measured, the scalar
alpha_logit) plus 1e-6 of the model's largest (GRAD_FLOOR; DBoF's
input_bn.offset, whose gradient cancels, used 8.6e-8); batch-norm moving
statistics within 1e-6 absolute (2.3e-10 measured). Inits drawn with
`jax.random.normal` (DBoF, NetVLAD, NeXtVLAD) agree to
3 ulp (tests/test_torch_prng.py), the others bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu import losses as jlosses
from efficientvideoclassification_youtube8m_tpu.models import MODEL_REGISTRY as JAX_MODELS
from efficientvideoclassification_youtube8m_tpu.models import frame_level as jframe
from efficientvideoclassification_youtube8m_tpu.models import get_model as jget
from efficientvideoclassification_youtube8m_tpu.models.base import dropout as jdropout
from efficientvideoclassification_youtube8m_tpu.train import step as jstep
from efficientvideoclassification_youtube8m_torch import losses as tlosses
from efficientvideoclassification_youtube8m_torch.models import get_model as tget
from efficientvideoclassification_youtube8m_torch.models import frame_level as tframe
from efficientvideoclassification_youtube8m_torch.models.base import dropout as tdropout
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.state import init_model
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params, to_jax_params

torch.set_num_threads(1)

B, T, D, V, K = 6, 12, 16, 24, 3
REL = 1e-5  # predictions, losses; gradients: of each tensor's largest element
# plus this much of the model's largest gradient element, for a tensor
# whose gradient cancels to ~0 (DBoF's input_bn.offset, which the cluster
# BN's centering cancels: 2e-8 against 0.3 elsewhere)
GRAD_FLOOR = 1e-6
BN_ATOL = 1e-6
NF = np.array([12, 5, 1, 8, 12, 3], np.int32)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    labels = rng.random((shape[0], V)) < 0.2
    labels[:, 0] = True
    old = rng.uniform(0.0, 1.0, size=(shape[0], K, V)).astype(np.float32)
    old[old < 0.2] = 0.0  # IndependentClassEnsemble masks the zeros
    return x, labels, old


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _close(got, want, what, rel=REL, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale + atol, f"{what}: max|diff| {err:.3g} over max {scale:.3g}"


def _squared_error(predictions, labels):
    """A loss without CE's 1/epsilon slope at predictions of exactly 0 or
    1, which ScaledSingleHiddenLayerModel's min-max rescale makes (there
    CE multiplies the rounding of the rescale by 1e5)."""
    return (predictions - labels.astype(predictions.dtype)) ** 2 if isinstance(
        predictions, jax.Array) else (predictions - labels.to(predictions.dtype)) ** 2


def _run_both(name, init_kw, input_size, x, labels, jax_kw, port_kw,
              frame_inputs=None, vocab=V, key=1, squared_error=False):
    """JAX init -> numpy -> port module; the training loss (the model's
    own, summed when matrix-valued, else CE, or the summed squared error)
    plus the regularization, forward and gradients through both."""
    jax_ce = (lambda p, l: jnp.sum(_squared_error(p, l))) if squared_error else \
        jlosses.cross_entropy_loss
    port_ce = (lambda p, l: torch.sum(_squared_error(p, l))) if squared_error else \
        tlosses.cross_entropy_loss
    jp = jget(name).init(jax.random.PRNGKey(key), input_size, vocab, **init_kw)
    module = tget(name)(input_size, vocab, **init_kw)
    load_jax_params(module, jax.tree.map(np.asarray, jp))
    xj = jnp.asarray(x)
    nf_kw_j = {} if frame_inputs is None else {"num_frames": jnp.asarray(frame_inputs)}
    nf_args_t = () if frame_inputs is None else (torch.from_numpy(frame_inputs),)

    def jloss(p):
        out = jget(name).apply(p, xj, vocab_size=vocab, labels=jnp.asarray(labels),
                               **nf_kw_j, **jax_kw)
        return jstep._video_level_label_loss(out, jnp.asarray(labels), jax_ce) + \
            out["regularization_loss"], out

    (jval, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    tout = module(torch.from_numpy(x), *nf_args_t, labels=torch.from_numpy(labels),
                  **port_kw)
    tval = (tstep.model_label_loss(tout, torch.from_numpy(labels), port_ce)
            + tout["regularization_loss"])
    (tgrad,) = tstep.param_grads(tval, module)
    _close(tout["predictions"].detach().numpy(), jout["predictions"], f"{name} predictions")
    _close(tval.item(), float(jval), f"{name} loss")
    _close(tout["regularization_loss"].item(), float(jout["regularization_loss"]),
           f"{name} regularization")
    want = _leaves(jgrad)
    assert sorted(want) == sorted(tgrad), name
    largest = max(float(np.max(np.abs(v))) for v in want.values())
    for leaf, g in tgrad.items():
        _close(g.numpy(), want[leaf], f"{name} d/d{leaf}", atol=GRAD_FLOOR * largest)
    return jout, tout


def test_registry_resolves_every_jax_model_and_loss():
    for name in JAX_MODELS:
        assert tget(name).name == name
    for name in jlosses.LOSS_REGISTRY:
        assert tlosses.get_loss(name) is tlosses.LOSS_REGISTRY[name]
    assert sorted(tlosses.LOSS_REGISTRY) == sorted(jlosses.LOSS_REGISTRY)


KEEP = jnp.float32(0.5)
VIDEO_HEADS = [
    ("MoeModel", {"num_mixtures": 2}, {}, {}),
    ("LogisticModel", {}, {}, {}),
    ("SingleHiddenLayerModel", {"num_hidden_units": 8}, {}, {}),
    ("SingleHiddenLayerModelDropout", {"num_hidden_units": 8},
     {"dropout_keep_prob": KEEP, "rng": jax.random.PRNGKey(3)},
     {"dropout_keep_prob": 0.5, "rng": prng.prng_key(3)}),
    ("SingleHiddenLayerModelDropout", {"num_hidden_units": 8}, {}, {}),
    ("DoubleHiddenLayerModelDropout", {},
     {"dropout_keep_prob": KEEP, "rng": jax.random.PRNGKey(4)},
     {"dropout_keep_prob": 0.5, "rng": prng.prng_key(4)}),
    ("ScaledSingleHiddenLayerModel", {"num_hidden_units": 8}, {}, {}),
]


@pytest.mark.parametrize("name,init_kw,jax_kw,port_kw", VIDEO_HEADS)
def test_video_level_head_matches_jax(name, init_kw, jax_kw, port_kw):
    x, labels, _ = _inputs(0, (B, D))
    _run_both(name, init_kw, D, x, labels, jax_kw, port_kw,
              squared_error=name.startswith("Scaled"))


def test_split_single_hidden_layer_model_loss_matches_jax():
    """Its own band-weighted CE (the flag loss is not used), 4716 classes."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, D)).astype(np.float32)
    labels = rng.random((4, 4716)) < 0.002
    jp = jget("SplitSingleHiddenLayerModel").init(jax.random.PRNGKey(2), D, 4716)
    module = tget("SplitSingleHiddenLayerModel")(D, 4716)
    load_jax_params(module, jax.tree.map(np.asarray, jp))

    def jloss(p):
        out = jget("SplitSingleHiddenLayerModel").apply(
            p, jnp.asarray(x), 4716, labels=jnp.asarray(labels))
        return out["loss"] + out["regularization_loss"], out

    (jval, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    tout = module(torch.from_numpy(x), labels=torch.from_numpy(labels))
    tval = tout["loss"] + tout["regularization_loss"]
    (tgrad,) = tstep.param_grads(tval, module)
    _close(tout["predictions"].detach().numpy(), jout["predictions"], "predictions")
    _close(tval.item(), float(jval), "loss")
    want = _leaves(jgrad)
    for leaf, g in tgrad.items():
        _close(g.numpy(), want[leaf], leaf)
    assert "loss" not in module(torch.from_numpy(x))
    with pytest.raises(ValueError, match="4716"):
        tget("SplitSingleHiddenLayerModel")(D, V)


def test_residual_model_matches_jax():
    """Input [features 6400 | V logit-space old predictions]."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 6400 + V)).astype(np.float32)
    labels = _inputs(2, (B, D))[1]
    _run_both("SingleHiddenLayerResidualModel", {"num_hidden_units": 8}, 6400 + V,
              x, labels, {"dropout_keep_prob": KEEP, "rng": jax.random.PRNGKey(6)},
              {"dropout_keep_prob": 0.5, "rng": prng.prng_key(6)})


@pytest.mark.parametrize("name", [
    "LinearRegressionEnsemble", "LinearRegressionWeightedMeanEnsemble",
    "LinearRegressionWeightedMeanEnsembleDifferenceLoss",
    "IndependentClassEnsemble", "SingleHiddenLayerEnsemble"])
def test_ensemble_head_matches_jax(name):
    """Sized by K; old_predictions [B + 2, K, V] (the extra rows are cut,
    as the reference's padded batches are)."""
    x, labels, old = _inputs(3, (B + 2, D))
    x, labels = x[:B], labels[:B]
    jout, tout = _run_both(
        name, {"num_classes": V}, D, x, labels, {"old_predictions": jnp.asarray(old)},
        {"old_predictions": torch.from_numpy(old)}, vocab=K)
    assert tout["predictions"].shape == (B, V)
    if name.endswith("DifferenceLoss"):
        _close(tout["loss"].detach().numpy(), jout["loss"], "matrix loss")


FRAME_MODELS = [
    ("FrameLevelLogisticModel", {}, {}),
    ("DbofModel", {"cluster_size": 32, "hidden_size": 16},
     {"iterations": 6, "is_training": True}),
    ("DbofModel", {"cluster_size": 32, "hidden_size": 16, "add_batch_norm": False},
     {"iterations": 6, "is_training": True, "add_batch_norm": False}),
    ("DbofModel", {"cluster_size": 32, "hidden_size": 16},
     {"iterations": 5, "is_training": True, "sample_random": False,
      "pooling_method": "average"}),
    ("DbofModel", {"cluster_size": 32, "hidden_size": 16,
                   "classifier": "SingleHiddenLayerModelDropout",
                   "classifier_kwargs": {"num_hidden_units": 8}},
     {"iterations": 6, "is_training": True, "dropout_keep_prob": 0.5,
      "classifier": "SingleHiddenLayerModelDropout"}),
    ("NetVLADModel", {"vlad_clusters": 4, "hidden_size": 16}, {}),
    ("NeXtVLADModel", {"vlad_clusters": 4, "hidden_size": 16, "groups": 4},
     {"groups": 4}),
    ("NeXtVLADModel", {"vlad_clusters": 3, "hidden_size": 8, "expansion": 1,
                       "groups": 2, "classifier": "LogisticModel"},
     {"groups": 2, "classifier": "LogisticModel"}),
]


@pytest.mark.parametrize("name,init_kw,kw", FRAME_MODELS)
def test_frame_model_matches_jax(name, init_kw, kw):
    """Training forward with a key (DBoF samples frames from it and gives
    its head `fold_in(key, 1)`), the loss and every gradient; DBoF's
    moving statistics after the batch."""
    x, labels, _ = _inputs(4, (B, T, D))
    jax_kw = dict(kw, rng=jax.random.PRNGKey(5))
    if "dropout_keep_prob" in kw:
        jax_kw["dropout_keep_prob"] = jnp.float32(kw["dropout_keep_prob"])
    jout, tout = _run_both(name, init_kw, D, x, labels, jax_kw,
                           dict(kw, rng=prng.prng_key(5)), frame_inputs=NF)
    if init_kw.get("add_batch_norm", True) and name == "DbofModel":
        stats = tout["updated_stats"]
        assert len(stats) == 6
        for path, value in stats.items():
            bn, stat = path.split(".")
            _close(value.numpy(), jout["updated_params"][bn][stat], path, atol=BN_ATOL)
    else:
        assert "updated_stats" not in tout


def test_dbof_eval_and_faithful_eval_keys_match_jax():
    """At eval DBoF normalizes with the moving statistics: evenly spaced
    frames without a key, random ones under a key folded with the
    device's sum(num_frames) (`_faithful_eval_rngs`, bit-equal keys)."""
    cfg = TrainConfig(model="DbofModel", num_classes=V, feature_sizes="12, 4",
                      dbof_cluster_size=32, dbof_hidden_size=16, iterations=6)
    jp = jget("DbofModel").init(jax.random.PRNGKey(7), D, V, cluster_size=32,
                                hidden_size=16)
    jp["input_bn"]["moving_mean"] = jnp.full((D,), 0.1)
    jp["input_bn"]["moving_var"] = jnp.full((D,), 2.0)
    module = init_model(cfg)
    load_jax_params(module, jax.tree.map(np.asarray, jp))
    x = _inputs(5, (B, T, D))[0]
    nf = torch.from_numpy(NF)
    jkeys = jstep._faithful_eval_rngs(cfg, jnp.asarray(NF))
    tkeys = tstep._faithful_eval_rngs(cfg, nf)
    for jk, tk in zip(jkeys, tkeys):
        assert tuple(int(v) for v in tk) == tuple(int(v) for v in np.asarray(jk))
    assert tstep._faithful_eval_rngs(cfg.replace(faithful_quirks=False), nf) == (None, None)
    for jrng, trng in ((None, None), (jkeys[1], tkeys[1])):
        want = jget("DbofModel").apply(jp, jnp.asarray(x), V, num_frames=jnp.asarray(NF),
                                       iterations=6, is_training=False, rng=jrng)
        with torch.no_grad():
            got = module(torch.from_numpy(x), nf, iterations=6, is_training=False,
                         rng=trng)
        _close(got["predictions"].numpy(), want["predictions"], "eval predictions")
        assert "updated_stats" not in got


@pytest.mark.parametrize("head,head_kw,jax_kw,port_kw", [
    ("LogisticModel", {}, {}, {}),
    ("SingleHiddenLayerModelDropout", {"num_hidden_units": 8},
     {"dropout_keep_prob": KEEP, "rng": jax.random.PRNGKey(8)},
     {"dropout_keep_prob": 0.5, "rng": prng.prng_key(8)}),
])
def test_hierarchical_lstm_with_other_heads_matches_jax(head, head_kw, jax_kw, port_kw):
    """The flagship tower hands labels, the keep-prob and the key to any
    head (JAX frame_level.py:157-171)."""
    x, labels, _ = _inputs(6, (B, T, D))
    common = {"classifier": head, "num_chunks": 3}
    _run_both("HierarchicalLstmModel",
              {"lstm_cells": 4, "lstm_layers": 2, "classifier": head,
               "classifier_kwargs": head_kw},
              D, x, labels, dict(common, **jax_kw), dict(common, **port_kw),
              frame_inputs=NF)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_samplers_pick_the_jax_frames(seed):
    # frames whose values are their index, to read the samplers' picks
    x = np.broadcast_to(np.arange(T, dtype=np.float32)[None, :, None], (B, T, 2)).copy()
    n = 7
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    nfj, nft = jnp.asarray(NF), torch.from_numpy(NF)
    picks = {
        "random": (jframe.sample_random_frames(xj, nfj, n, jax.random.PRNGKey(seed)),
                   tframe.sample_random_frames(xt, nft, n, prng.prng_key(seed))),
        "sequence": (jframe.sample_random_sequence(xj, nfj, n, jax.random.PRNGKey(seed)),
                     tframe.sample_random_sequence(xt, nft, n, prng.prng_key(seed))),
        "even": (jframe.sample_even_frames(xj, nfj, n),
                 tframe.sample_even_frames(xt, nft, n)),
    }
    for kind, (want, got) in picks.items():
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=kind)
        assert np.all(got.numpy()[:, :, 0] < NF[:, None]), kind


@pytest.mark.parametrize("method", ["average", "max", "none"])
def test_frame_pooling_matches_jax(method):
    x = _inputs(7, (B, T, D))[0]
    x[:, 3] = x[:, 4]  # ties for max
    want, vjp = jax.vjp(lambda v: jframe.frame_pooling(v, method), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tframe.frame_pooling(xt, method)
    cot = np.random.default_rng(1).normal(size=np.shape(want)).astype(np.float32)
    (g,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    _close(got.detach().numpy(), want, method)
    _close(g.numpy(), vjp(jnp.asarray(cot))[0], f"{method} gradient")
    with pytest.raises(ValueError):
        tframe.frame_pooling(xt, "median")


@pytest.mark.parametrize("keep", [0.5, 0.9, 1.0])
def test_dropout_masks_are_jax_masks(keep):
    x = np.ones((5, 33), np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(11), 4)
    want = np.asarray(jdropout(jnp.asarray(x), jnp.float32(keep), key))
    got = tdropout(torch.from_numpy(x), keep, prng.fold_in(prng.prng_key(11), 4))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


ZOO_INITS = [
    ("DbofModel", {"cluster_size": 32, "hidden_size": 16}),
    ("DbofModel", {"cluster_size": 32, "hidden_size": 16, "add_batch_norm": False}),
    ("NetVLADModel", {"vlad_clusters": 4, "hidden_size": 16}),
    ("NeXtVLADModel", {"vlad_clusters": 4, "hidden_size": 16, "groups": 4}),
    ("FrameLevelLogisticModel", {}),
    ("SplitSingleHiddenLayerModel", {}),
    ("LinearRegressionWeightedMeanEnsemble", {}),
    ("IndependentClassEnsemble", {"num_classes": 7}),
    ("DoubleHiddenLayerModelDropout", {}),
]


@pytest.mark.parametrize("name,kw", ZOO_INITS)
def test_init_from_a_key_is_the_jax_init(name, kw):
    """The same key gives the same weights (normal draws to 3 ulp), and the
    parameter tree round-trips through the bridge, batch-norm statistics,
    bare leaves (`centers`) and 0-d leaves (`alpha_logit`) included."""
    vocab = 4716 if name.startswith("Split") else V
    want = _leaves(jax.tree.map(np.asarray, jget(name).init(
        jax.random.PRNGKey(9), D, vocab, **kw)))
    module = tget(name)(D, vocab, key=prng.prng_key(9), **kw)
    got = _leaves(to_jax_params(module))
    assert sorted(got) == sorted(want)
    for leaf, value in want.items():
        assert got[leaf].shape == value.shape, leaf
        ulps = np.abs(got[leaf].view(np.int32).astype(np.int64)
                      - value.astype(np.float32).view(np.int32))
        assert ulps.max(initial=0) <= 3, leaf
    tree = jax.tree.map(np.asarray, jget(name).init(jax.random.PRNGKey(10), D, vocab, **kw))
    back = _leaves(to_jax_params(load_jax_params(module, tree)))
    for leaf, value in _leaves(tree).items():
        np.testing.assert_array_equal(back[leaf], value, err_msg=leaf)


def test_init_model_sizes_as_init_distill_state():
    """`init_model`'s sizing (head width, the flattened keywords of a
    video-level --model, DBoF's flags) gives the JAX tree's shapes."""
    from efficientvideoclassification_youtube8m_tpu.train import state as jstate
    from efficientvideoclassification_youtube8m_tpu.train.optimizer import make_optimizer

    base = TrainConfig(num_classes=V, feature_sizes="12, 4", lstm_cells=4,
                       num_hidden_units=6, dbof_cluster_size=20, dbof_hidden_size=10,
                       moe_num_mixtures=3)
    for cfg in (base.replace(video_level_classifier_model="SingleHiddenLayerModel"),
                base.replace(model="MoeModel"), base.replace(model="SingleHiddenLayerModel"),
                base.replace(model="DbofModel", dbof_add_batch_norm=False),
                base.replace(model="DbofModel")):
        want = jstate.init_distill_state(cfg, make_optimizer("AdamOptimizer")).params_student
        got = _leaves(to_jax_params(init_model(cfg, prng.split(prng.prng_key(cfg.seed))[1])))
        want = _leaves(jax.tree.map(np.asarray, want))
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_frame_level_model_rejected_on_aggregated_input():
    cfg = TrainConfig(model="DbofModel", num_classes=V, feature_sizes="12, 4")
    with pytest.raises(ValueError, match="frame-level model"):
        tstep.forward_video_level(cfg, None, torch.zeros(2, D))


def test_frame_level_logistic_with_no_frames_is_nan_as_in_jax():
    """The reference divides the frame sum by num_frames
    (frame_level_models.py:50-83): a student video below every_n frames
    has 0 and a NaN prediction, in the JAX package and the port alike."""
    x = _inputs(8, (2, T, D))[0]
    nf = np.array([0, 4], np.int32)
    jp = jget("FrameLevelLogisticModel").init(jax.random.PRNGKey(0), D, V)
    module = tget("FrameLevelLogisticModel")(D, V)
    load_jax_params(module, jax.tree.map(np.asarray, jp))
    want = np.asarray(jget("FrameLevelLogisticModel").apply(
        jp, jnp.asarray(x), V, num_frames=jnp.asarray(nf))["predictions"])
    got = module(torch.from_numpy(x), torch.from_numpy(nf))["predictions"].detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).all() and np.isfinite(got[1]).all()
    _close(got[1], want[1], "the video with frames")
