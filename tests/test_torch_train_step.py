"""The port's distill and finetune steps against the JAX package's, at a
tiny config (tests/test_train.py's, at batch 8: at batch 4 the JAX
`train_tile_for` finds no tile for L2 and takes the XLA scan). Both start
from the JAX init through the numpy bridge and see the same uint8
batches. The JAX side runs once per module."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu import train as jtrain
from efficientvideoclassification_youtube8m_tpu.metrics.eval_util import (
    perr_precision_on_device as jax_perr,
)
from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
    student_num_frames as jax_student_num_frames,
    uniform_subsample as jax_uniform_subsample,
)
from efficientvideoclassification_youtube8m_tpu.train import step as jstep
# the port's config: the JAX functions read the same fields (test_torch_summary_flags.py)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.metrics.eval_util import (
    topk_and_perr_on_device,
)
from efficientvideoclassification_youtube8m_torch.ops.preprocess import host_subsample
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    params_of,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params

torch.set_num_threads(1)

TINY = TrainConfig(
    num_classes=30, batch_size=8, lstm_cells=8, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    base_learning_rate=0.01, learning_rate_decay_examples=1000,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
)
TOP_K = 5
# f32 sums in another order: 1e-5 relative; L_PRED (~1e-3) is a sum of
# ~240 nearly cancelling terms of ~0.1, so it is also held to 2e-6 absolute
# (5e-7 measured)
LOSS_ATOL = 2e-6
# TF-Adam's normalized step magnifies the relative error of a gradient
# element that is near zero by cancellation: a rare element's 0.01 step
# moves by up to ~1e-3 of itself (1.0e-5 measured); every other element
# agrees to 1e-5 relative
PARAM_ATOL = 2e-5
LOSS_KEYS = ("teacher_label_loss", "teacher_final_loss", "teacher_reg_loss",
             "student_loss_state", "pred_loss", "student_label_loss",
             "student_reg_loss", "total_student_loss")


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    B = cfg.batch_size
    feats = rng.integers(0, 256, size=(B, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    labels = np.zeros((B, cfg.num_classes), bool)
    for i in range(B):
        labels[i, rng.choice(cfg.num_classes, 3, replace=False)] = True
    nf = rng.integers(5, cfg.max_num_frames + 1, size=B).astype(np.int32)
    return feats, labels, nf


def _named(tree):
    """A JAX tree as {"rnn_l1.0.kernel": array, ...}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in leaves}


def _port_state(cfg, jstate):
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    load_jax_params(state.teacher, jax.tree.map(np.asarray, jstate.params_teacher))
    load_jax_params(state.student, jax.tree.map(np.asarray, jstate.params_student))
    return opt, state


def _jax_loss_and_grads(cfg, jstate, batch, pallas_train_mode):
    """The JAX distill step's loss_fn (train/step.py:400-420) and its
    gradients, from the package's own functions."""
    feats, labels, nf = map(jnp.asarray, batch)
    label_loss_fn = jstep.resolve_label_loss(cfg)

    def loss(pt, ps):
        x = jstep.preprocess_batch(cfg, feats, nf)
        xs = jax_uniform_subsample(x, cfg.every_n)
        nfs = jax_student_num_frames(nf, cfg.every_n, cfg.max_num_frames)
        out_t = jstep.forward_teacher(cfg, pt, x, nf, labels,
                                      pallas_train_mode=pallas_train_mode)
        out_s = jstep.forward_student(cfg, ps, xs, nfs, labels,
                                      pallas_train_mode=pallas_train_mode)
        ls = jstep._distill_losses(cfg, out_t, out_s, labels, label_loss_fn)
        return ls["teacher_final_loss"] + ls["total_student_loss"], ls

    (_, ls), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                has_aux=True))(
        jstate.params_teacher, jstate.params_student)
    return ({k: float(v) for k, v in ls.items()}, _named(grads[0]),
            _named(grads[1]))


def _t(batch):
    return tuple(torch.from_numpy(a) for a in batch)


@pytest.fixture(scope="module")
def jax_distill():
    """Two JAX distill steps in f32, and the step-1 losses and gradients."""
    cfg = TINY
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state0 = jtrain.init_distill_state(cfg, jo)
    batches = [_batch(cfg, 0), _batch(cfg, 1)]
    step = jax.jit(jtrain.build_distill_train_step(cfg, jo, top_k=TOP_K))
    s1, m1 = step(state0, *map(jnp.asarray, batches[0]))
    s2, m2 = step(s1, *map(jnp.asarray, batches[1]))
    return dict(state0=state0, batches=batches, s1=s1, s2=s2,
                metrics=[jax.tree.map(np.asarray, m) for m in (m1, m2)],
                step1=_jax_loss_and_grads(cfg, state0, batches[0], "off"))


@pytest.fixture(scope="module")
def port_distill(jax_distill):
    """The same two steps in the port, plain scan (f32)."""
    cfg = TINY
    opt, state = _port_state(cfg, jax_distill["state0"])
    b0, b1 = (_t(b) for b in jax_distill["batches"])
    step1 = tstep.distill_loss_and_grads(cfg, state, *b0, kernel_train_mode="off")
    step = tstep.build_distill_train_step(cfg, opt, top_k=TOP_K,
                                          kernel_train_mode="off")
    state, m1 = step(state, *b0)
    mu1 = {k: v.clone() for k, v in state.opt_student["mu"].items()}
    state, m2 = step(state, *b1)
    return dict(state=state, metrics=[m1, m2], step1=step1, mu1=mu1)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_distill_step1_losses_match_jax(jax_distill, port_distill):
    want, _, _ = jax_distill["step1"]
    got = port_distill["step1"][0]
    assert sorted(got) == sorted(LOSS_KEYS)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k].item(), want[k], rtol=1e-5,
                                   atol=LOSS_ATOL, err_msg=k)


@pytest.mark.parametrize("tower", ["teacher", "student"])
def test_distill_step1_gradients_match_jax(jax_distill, port_distill, tower):
    _, want_t, want_s = jax_distill["step1"]
    want = want_t if tower == "teacher" else want_s
    got = port_distill["step1"][2 if tower == "teacher" else 3]
    assert sorted(got) == sorted(want)
    for name in want:
        # f32 on both sides; summation order of the matmuls and the scan's
        # reverse accumulation differ (5.8e-7 of the max measured)
        assert _rel(got[name].numpy(), want[name]) < 1e-5, name


@pytest.mark.parametrize("index", [0, 1])
def test_distill_step_metrics_match_jax(jax_distill, port_distill, index):
    want = jax_distill["metrics"][index]
    got = port_distill["metrics"][index]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=LOSS_ATOL, err_msg=k)
    assert got["global_step"] == int(want["global_step"]) == 2 * (index + 1)
    assert got["learning_rate"].item() == float(want["learning_rate"])
    np.testing.assert_allclose(got["topk_val"].numpy(), want["topk_val"], rtol=1e-5)
    np.testing.assert_array_equal(got["topk_idx"].numpy(), want["topk_idx"])
    np.testing.assert_allclose(got["perr_precision"].numpy(),
                               want["perr_precision"], atol=1e-6)


@pytest.mark.parametrize("tower", ["teacher", "student"])
def test_distill_params_after_two_steps_match_jax(jax_distill, port_distill,
                                                  tower):
    state = port_distill["state"]
    want = _named(getattr(jax_distill["s2"], f"params_{tower}"))
    got = params_of(getattr(state, tower))
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name],
                                   rtol=1e-5, atol=PARAM_ATOL, err_msg=name)
    assert state.global_step == int(jax_distill["s2"].global_step) == 4


def test_distill_adam_moments_after_step1_match_jax(jax_distill, port_distill):
    want = _named(jax_distill["s1"].opt_student.mu)
    for name, mu in port_distill["mu1"].items():
        assert _rel(mu.numpy(), want[name]) < 1e-4, name


@pytest.fixture(scope="module")
def bf16_step():
    """One bf16 distill step: JAX with the Pallas train kernels in
    interpret mode, the port with its train kernels (their plain versions
    on the CPU)."""
    cfg = TINY.replace(compute_dtype="bfloat16")
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state0 = jtrain.init_distill_state(cfg, jo)
    batch = _batch(cfg, 2)
    want_ls, want_gt, want_gs = _jax_loss_and_grads(cfg, state0, batch,
                                                    "interpret")
    step = jax.jit(jtrain.build_distill_train_step(
        cfg, jo, top_k=TOP_K, pallas_train_mode="interpret"))
    s1, m1 = step(state0, *map(jnp.asarray, batch))
    opt, state = _port_state(cfg, state0)
    got_ls, _, got_gt, got_gs = tstep.distill_loss_and_grads(
        cfg, state, *_t(batch), kernel_train_mode="on")
    tstep_fn = tstep.build_distill_train_step(cfg, opt, top_k=TOP_K,
                                              kernel_train_mode="on")
    state, got_m1 = tstep_fn(state, *_t(batch))
    return dict(want=(want_ls, want_gt, want_gs, s1, jax.tree.map(np.asarray, m1)),
                got=(got_ls, got_gt, got_gs, state, got_m1))


def test_bf16_kernel_step_losses_match_jax_interpret(bf16_step):
    want_ls, *_, want_m = bf16_step["want"]
    got_ls, _, _, state, got_m = bf16_step["got"]
    for k in LOSS_KEYS:
        # bf16 operands rounded at the same places, f32 sums on both sides
        np.testing.assert_allclose(got_ls[k].item(), want_ls[k], rtol=1e-4,
                                   atol=LOSS_ATOL, err_msg=k)
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=1e-4,
                                   atol=LOSS_ATOL, err_msg=k)
    assert state.global_step == int(want_m["global_step"]) == 2
    assert got_m["learning_rate"].item() == float(want_m["learning_rate"])


@pytest.mark.parametrize("tower", ["teacher", "student"])
def test_bf16_kernel_gradients_match_jax_interpret(bf16_step, tower):
    _, want_gt, want_gs, _, _ = bf16_step["want"]
    _, got_gt, got_gs, _, _ = bf16_step["got"]
    want, got = (want_gt, got_gt) if tower == "teacher" else (want_gs, got_gs)
    for name in want:
        # the same kernels' math on both sides, but a bf16 value (x @ Wx,
        # a layer output, a dgates element) may round one ulp apart after
        # an f32 sum ran in another order, and the bf16 backward carries
        # it on (5.2e-3 of the max measured); tests/test_pallas_lstm.py's
        # bar for bf16 train gradients
        assert _rel(got[name].numpy(), want[name]) < 3e-2, name


def test_teacher_update_is_unchanged_by_the_student_terms(jax_distill):
    """tests/test_train.py:202-234 for the port: the distill step's
    teacher update equals an update from the teacher's own loss."""
    cfg = TINY
    opt, state = _port_state(cfg, jax_distill["state0"])
    feats, labels, nf = _t(_batch(cfg, 2))
    teacher0 = copy.deepcopy(state.teacher)
    step = tstep.build_distill_train_step(cfg, opt, top_k=TOP_K,
                                          kernel_train_mode="off")
    state, _ = step(state, feats, labels, nf)

    out = tstep.forward_teacher(cfg, teacher0, tstep.preprocess_batch(cfg, feats, nf),
                                nf, kernel_train_mode="off")
    loss = (tstep.resolve_label_loss(cfg)(out["predictions"], labels)
            + cfg.regularization_penalty * out["regularization_loss"])
    params = params_of(teacher0)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    lr = tstep.exponential_decay(cfg.base_learning_rate, cfg.batch_size,
                                 cfg.learning_rate_decay_examples,
                                 cfg.learning_rate_decay)(0)
    opt.update(grads, opt.init(params), params, lr)
    for name, p in params_of(state.teacher).items():
        np.testing.assert_allclose(p.detach().numpy(), params[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("host_subsampled", [False, True])
def test_finetune_step_matches_jax(host_subsampled):
    cfg = TINY
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    jstate = jtrain.student_state_from_distill(
        jtrain.init_distill_state(cfg, jo), jo)
    feats, labels, nf = _batch(cfg, 3)
    if host_subsampled:
        feats = host_subsample(feats, cfg.every_n)
    js1, jm = jax.jit(jtrain.build_finetune_step(
        cfg, jo, top_k=TOP_K, host_subsampled=host_subsampled))(
            jstate, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(nf))
    jm = jax.tree.map(np.asarray, jm)

    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(cfg, opt), opt)
    load_jax_params(state.student, jax.tree.map(np.asarray, jstate.params_student))
    state, m = tstep.build_finetune_step(
        cfg, opt, top_k=TOP_K, host_subsampled=host_subsampled,
        kernel_train_mode="off")(state, *_t((feats, labels, nf)))
    for k in ("student_label_loss", "student_reg_loss"):
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5,
                                   atol=LOSS_ATOL, err_msg=k)
    assert state.global_step == int(jm["global_step"]) == 1
    assert m["learning_rate"].item() == float(jm["learning_rate"])
    np.testing.assert_array_equal(m["topk_idx"].numpy(), jm["topk_idx"])
    np.testing.assert_allclose(m["perr_precision"].numpy(), jm["perr_precision"],
                               atol=1e-6)
    want = _named(js1.params_student)
    for name, p in params_of(state.student).items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5,
                                   atol=PARAM_ATOL, err_msg=name)


def test_finetune_aggregated_branch_raises():
    opt = make_optimizer(TINY.optimizer)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, the model zoo and losses"):
        tstep.build_finetune_step(TINY, opt, aggregated=True)


def test_unported_label_loss_fails_at_build():
    opt = make_optimizer(TINY.optimizer)
    with pytest.raises(NotImplementedError):
        tstep.build_distill_train_step(TINY.replace(label_loss="HingeLoss"), opt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_and_perr_with_tied_scores_match_jax(seed):
    """Scores rounded to one decimal tie all over; top-k breaks ties
    lowest index first, and PERR shares the tied capacity out, as the JAX
    device functions do. Row 0 has no labels, row 1 is all one score."""
    rng = np.random.default_rng(seed)
    preds = np.round(rng.random((12, 30)), 1).astype(np.float32)
    preds[1] = 0.5
    preds[2, :4] = 0.0
    labels = rng.random((12, 30)) < 0.2
    labels[0] = False
    labels[2, :6] = True
    want_v, want_i = jax.lax.top_k(jnp.asarray(preds), 7)
    got_v, got_i, got_p = topk_and_perr_on_device(
        torch.from_numpy(preds), torch.from_numpy(labels), 7)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    want_p = np.asarray(jax_perr(jnp.asarray(preds), jnp.asarray(labels)))
    assert got_p.dtype == torch.float32 and got_p[0].item() == 0.0
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-6)


def test_kernel_train_rule():
    """The train kernels run for bf16 on CUDA with lstm_pallas_train set,
    or when forced; never on the inference path."""
    bf16 = TINY.replace(compute_dtype="bfloat16")
    kw = tstep._model_apply_kwargs
    assert kw(bf16, torch.device("cuda"))["use_kernel_train"]
    assert not kw(bf16, torch.device("cpu"))["use_kernel_train"]
    assert not kw(TINY, torch.device("cuda"))["use_kernel_train"]
    assert not kw(bf16.replace(lstm_pallas_train=False),
                  torch.device("cuda"))["use_kernel_train"]
    assert kw(TINY, torch.device("cpu"), kernel_train_mode="on")["use_kernel_train"]
    assert not kw(bf16, torch.device("cuda"), kernel_train_mode="off")["use_kernel_train"]
    assert "use_kernel_train" not in kw(bf16, torch.device("cuda"), inference=True)
    with pytest.raises(ValueError):
        kw(TINY, torch.device("cpu"), kernel_train_mode="interpret")
