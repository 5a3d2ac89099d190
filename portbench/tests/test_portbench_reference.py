"""The plain reference against the port's plain path (float32, the plain
scans on the CPU) at a small width: the towers' forward, the
distillation and finetune steps (losses, and the parameters after one
TF-Adam step with per-variable clipping), and the eval step's
predictions."""

import numpy as np
import pytest
import torch

from portbench import harness, traffic, weights
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.tests.small import SMALL

FLAGS = dict(SMALL, model="HierarchicalLstmModel", lstm_layers=2, moe_num_mixtures=2,
             video_level_classifier_model="MoeModel", feature_names="rgb, audio",
             compute_dtype="float32", base_learning_rate=0.01,
             learning_rate_decay=0.95, learning_rate_decay_examples=4000000,
             optimizer="AdamOptimizer", clip_gradient_norm=1.0)


def _program(towers, seed=5):
    _, cfg = harness.program_config(FLAGS, device="cpu")
    drawn = weights.draw(FLAGS, towers, seed, "cpu")
    return cfg, {t: harness.program_tower(cfg, drawn[t], "cpu") for t in towers}


def _batch(seed=3, n=8):
    v = traffic.pool({"videos": n, "seconds": [10, 60], "mean_labels": 3.4}, FLAGS, seed)
    labels = np.zeros((n, FLAGS["num_classes"]), bool)
    for i, c in enumerate(v["labels"]):
        labels[i, c] = True
    return {"features": torch.from_numpy(v["features"]), "labels": torch.from_numpy(labels),
            "num_frames": torch.from_numpy(v["num_frames"])}


@pytest.mark.parametrize("tower", ["teacher", "student"])
def test_tower_forward(tower):
    from efficientvideoclassification_youtube8m_torch.train import step as step_lib

    cfg, program = _program((tower,))
    b = _batch()
    nf = b["num_frames"]
    x = step_lib.preprocess_batch(cfg, b["features"], nf)
    if tower == "teacher":
        got = step_lib.forward_teacher(cfg, program[tower], x, nf, inference=True)
        want = ref_model.tower(weights.draw(FLAGS, (tower,), 5, "cpu")[tower],
                               ref_model.preprocess(b["features"], nf.long()), nf.long(),
                               FLAGS["num_inputs_to_lstm"])
    else:
        from efficientvideoclassification_youtube8m_torch.ops.preprocess import (
            student_num_frames, uniform_subsample)
        nfs = student_num_frames(nf, cfg.every_n, cfg.max_num_frames)
        got = step_lib.forward_student(cfg, program[tower], uniform_subsample(x, cfg.every_n),
                                       nfs, inference=True)
        xs, nfs_ref = ref_model.student_input(b["features"], nf.long(), cfg.every_n,
                                              cfg.max_num_frames)
        assert torch.equal(nfs.long(), nfs_ref)
        want = ref_model.tower(weights.draw(FLAGS, (tower,), 5, "cpu")[tower], xs, nfs_ref,
                               FLAGS["num_inputs_L1"])
    torch.testing.assert_close(got["state"], want["state"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got["predictions"], want["predictions"], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("step", ["distill", "finetune"])
def test_train_step(step):
    from efficientvideoclassification_youtube8m_torch.train import step as step_lib
    from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
    from efficientvideoclassification_youtube8m_torch.train.state import (
        DistillState, StudentState, params_of)

    towers = ("teacher", "student") if step == "distill" else ("student",)
    cfg, program = _program(towers)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    slots = {f"opt_{t}": opt.init(params_of(program[t])) for t in towers}
    if step == "distill":
        state = DistillState(**program, **slots, global_step=0, dropout_keep_prob=1.0)
        fn = step_lib.build_distill_train_step(cfg, opt)
    else:
        state = StudentState(**program, **slots, global_step=0, dropout_keep_prob=1.0)
        fn = step_lib.build_finetune_step(cfg, opt, host_subsampled=True)
    ref = {t: {k: v.requires_grad_() for k, v in leaves.items()}
           for t, leaves in weights.draw(FLAGS, towers, 5, "cpu").items()}
    want = ref_train.run_steps(FLAGS, step, ref, [_batch(seed=3), _batch(seed=4)])
    for batch_seed, ref_losses in zip((3, 4), want["losses"]):
        bb = _batch(seed=batch_seed)
        f = bb["features"] if step == "distill" else bb["features"][:, ::FLAGS["every_n"]]
        state, metrics = fn(state, f, bb["labels"], bb["num_frames"])
        for key in ref_train_keys(step):
            assert float(metrics[key]) == pytest.approx(ref_losses[key], rel=1e-5, abs=1e-6)
    for t in towers:
        for name, p in program[t].named_parameters():
            torch.testing.assert_close(p.detach(), ref[t][name].detach(), rtol=1e-4, atol=2e-6)


def ref_train_keys(step):
    if step == "distill":
        return ("teacher_label_loss", "student_label_loss", "student_loss_state", "pred_loss")
    return ("student_label_loss",)


def test_eval_step_predictions():
    from efficientvideoclassification_youtube8m_torch.train import step as step_lib

    cfg, program = _program(("student",))
    b = _batch()
    fn = step_lib.build_eval_step(cfg, host_subsampled=True)
    strided = b["features"][:, ::FLAGS["every_n"]].contiguous()
    got = fn(program["student"], strided, b["labels"], b["num_frames"])["predictions"]
    want = ref_model.student_predictions(weights.draw(FLAGS, ("student",), 5, "cpu")["student"],
                                         strided, b["num_frames"], FLAGS)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_fp8_control_rounds():
    t = torch.randn(4, 64, requires_grad=True)
    stored = harness.FP8.store(t)
    scale = t.detach().abs().amax(1, keepdim=True) / 448
    # e4m3 keeps 3 mantissa bits: a relative error of at most 2^-4
    assert not torch.equal(stored, t)
    assert torch.all((stored - t).abs() <= t.abs() * 2 ** -4 + scale * 2 ** -6)
    assert len(torch.unique(stored[0])) < 64 or torch.equal(stored[0], t[0])
    stored.sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))
    w = torch.randn(64, 16)
    torch.testing.assert_close(harness.FP8.mm(t.detach(), w), t.detach() @ w, rtol=0.2, atol=1.0)
