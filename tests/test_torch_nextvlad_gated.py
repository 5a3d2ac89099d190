"""`NeXtVLADGatedModel`, the published NeXtVLAD (arXiv:1811.05014), which
the port has and the JAX package does not, against the benchmark's plain
reference (`portbench/reference/nextvlad.py`) at a small size on the CPU:
through the port's eval step, on seeded random weights with random
biases and batch-norm statistics away from the identity. Each of four
planted faults fails the comparison. Then the model through the normal
path: `cli.finetune --start_new_model` for 2 steps and `cli.eval` of its
checkpoint."""

import glob
import math
import os

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import finetune
from efficientvideoclassification_youtube8m_torch.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_torch.models import frame_level, get_model
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    read_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from portbench import harness, weights_vlad
from portbench.reference import nextvlad as ref_vlad

torch.set_num_threads(1)

FLAGS = {"feature_sizes": "12, 4", "num_classes": 24, "max_num_frames": 30, "every_n": 1}
WIDTHS = {"vlad_clusters": 8, "groups": 4, "expansion": 2, "hidden_size": 32,
          "gating_reduction": 4, "drop_rate": 0.5}
B, T, D = 6, 30, 16
# float32: the program and the reference differ in summation order only
# (batched products against one product a video, rsqrt against a
# division); 1.2e-7 measured on the predictions.
F32_ATOL = 2e-6
# bfloat16 operands and products (8 significant bits, 2^-9 relative) in a
# chain of eight products, two of them feeding a softmax and a batch norm
# that scale their differences up: 1.8e-3 measured at most (the three
# seeds below and four more). The fp8 reference reads 1.5e-2 or more on
# the same seeds, so the tolerance would catch a precision one step lower.
BF16_ATOL = 6e-3


def _cfg(dtype="float32"):
    return TrainConfig(model="NeXtVLADGatedModel", feature_sizes="12, 4", num_classes=24,
                       max_num_frames=T, every_n=1, compute_dtype=dtype,
                       video_level_classifier_model="LogisticModel")


def _model(seed):
    """The program's module and the reference's leaves: the benchmark's
    draw, with the zero biases made random."""
    leaves = weights_vlad.draw({"flags": FLAGS, "nextvlad": WIDTHS}, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for name, t in leaves.items():
        if name.endswith(".b"):
            leaves[name] = 0.2 * torch.randn(t.shape, generator=g)
    module = get_model("NeXtVLADGatedModel")(
        D, FLAGS["num_classes"], feature_sizes=(12, 4), classifier="LogisticModel",
        **WIDTHS)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(leaves[name])
    assert set(leaves) == set(dict(module.named_parameters()))
    return module, leaves


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    features = torch.randint(0, 256, (B, T, D), generator=g, dtype=torch.uint8)
    num_frames = torch.tensor([30, 1, 17, 29, 8, 23], dtype=torch.int32)
    labels = torch.rand(B, FLAGS["num_classes"], generator=g) < 0.1
    return features, labels, num_frames


def _gap(module, leaves, seed, dtype="float32"):
    """The widest gap of the eval step's predictions to the reference's."""
    features, labels, nf = _inputs(seed)
    got = tstep.build_eval_step(_cfg(dtype), host_subsampled=True)(
        module, features, labels, nf)["predictions"]
    return float((got - ref_vlad.predictions(leaves, features, nf, FLAGS)).abs().max())


def _fp8_gap(leaves, seed):
    """The same gap of the reference computed in fp8 (the benchmark's
    control)."""
    features, _, nf = _inputs(seed)
    got = ref_vlad.predictions(leaves, features, nf, FLAGS, harness.FP8)
    return float((got - ref_vlad.predictions(leaves, features, nf, FLAGS)).abs().max())


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
def test_eval_step_matches_the_reference_in_float32(seed):
    module, leaves = _model(seed)
    assert _gap(module, leaves, seed) <= F32_ATOL


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
def test_eval_step_matches_the_reference_in_bfloat16(seed):
    module, leaves = _model(seed)
    assert _gap(module, leaves, seed, "bfloat16") <= BF16_ATOL
    assert _fp8_gap(leaves, seed) > BF16_ATOL


def _skip_cluster_bn(monkeypatch, module):
    real = frame_level._bn_apply

    def apply(p, x, is_training, **kw):
        return (x, {}) if p is module.video.cluster_bn else real(p, x, is_training, **kw)
    monkeypatch.setattr(frame_level, "_bn_apply", apply)


def _unmask_padding(monkeypatch, module):
    monkeypatch.setattr(frame_level, "_frame_mask",
                        lambda nf, T, device=None: torch.ones(len(nf), T, 1))


def _drop_audio(monkeypatch, module):
    monkeypatch.setattr(module.audio, "forward",
                        lambda x, *a: torch.zeros(x.shape[0], module.audio.code_size))


def _skip_gating(monkeypatch, module):
    monkeypatch.setattr(module, "_gate", lambda act, norm, dtype: act)


@pytest.mark.parametrize("fault", [_skip_cluster_bn, _unmask_padding, _drop_audio,
                                   _skip_gating], ids=lambda f: f.__name__.strip("_"))
def test_a_planted_fault_fails_the_comparison(monkeypatch, fault):
    module, leaves = _model(0)
    fault(monkeypatch, module)
    assert _gap(module, leaves, 0) > 100 * F32_ATOL


def test_training_updates_the_moving_statistics_and_drops_out():
    module, _ = _model(0)
    features, labels, nf = _inputs(0)
    x = tstep.preprocess_batch(_cfg(), features, nf)
    out = module(x, nf, rng=prng.prng_key(7), is_training=True)
    stats = out["updated_stats"]
    assert set(stats) == {f"{n}.{s}" for n in ("video.cluster_bn", "video.vlad_bn",
                                               "audio.cluster_bn", "audio.vlad_bn",
                                               "hidden_bn", "gate_bn")
                          for s in ("moving_mean", "moving_var")}
    again = module(x, nf, rng=prng.prng_key(8), is_training=True)["predictions"]
    assert not torch.equal(out["predictions"], again)  # another dropout mask
    inference = module(x, nf, rng=prng.prng_key(7), is_training=False)
    assert "updated_stats" not in inference
    torch.testing.assert_close(inference["predictions"],
                               module(x, nf, rng=prng.prng_key(8), is_training=False)["predictions"])


def test_two_features_are_required():
    with pytest.raises(ValueError, match="two features"):
        get_model("NeXtVLADGatedModel")(16, 24, feature_sizes=(16,))
    with pytest.raises(ValueError, match="two features"):
        get_model("NeXtVLADGatedModel")(16, 24)


def test_published_widths_are_the_defaults():
    module = get_model("NeXtVLADGatedModel")(1152, 3862, feature_sizes=(1024, 128),
                                             classifier="LogisticModel", device="meta")
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert shapes["video.cluster.w"] == (2048, 1024)
    assert shapes["video.centers"] == (256, 128)
    assert shapes["audio.cluster.w"] == (256, 256)
    assert shapes["audio.centers"] == (64, 64)
    assert shapes["hidden.w"] == (36864, 2048)
    assert shapes["gate1.w"] == (2048, 256) and shapes["gate2.w"] == (256, 2048)
    assert shapes["classifier.fc.w"] == (2048, 3862)
    assert module.drop_rate == 0.5
    assert sum(p.numel() for p in module.parameters()) == 88_970_274


def test_finetune_then_eval_through_the_binaries(tmp_path):
    """At the published widths over 12 + 4 features: two steps of
    cli.finetune --start_new_model (the batch norms' moving statistics
    written back into the checkpoint), then cli.eval of it."""
    for s, n in ((0, 8), (1, 8)):
        write_synthetic_frame_shard(str(tmp_path / f"train-{s}.tfrecord"), num_videos=n,
                                    seed=s, feature_sizes=(12, 4), max_frames=T,
                                    vocab_size=40)
    write_synthetic_frame_shard(str(tmp_path / "validate-0.tfrecord"), num_videos=6,
                                seed=9, feature_sizes=(12, 4), max_frames=T, vocab_size=40)
    train_dir = str(tmp_path / "model") + "/"
    flags = ["--model", "NeXtVLADGatedModel", "--every_n", "1",
             "--video_level_classifier_model", "LogisticModel", "--num_classes", "40",
             "--feature_names", "rgb, audio", "--feature_sizes", "12, 4",
             "--max_num_frames", str(T), "--batch_size", "8", "--num_readers", "1",
             "--compute_dtype", "float32", "--top_k", "5", "--device", "cpu",
             "--train_dir", train_dir]
    finetune.main(flags + ["--train_data_pattern", str(tmp_path / "train-*.tfrecord"),
                           "--start_new_model", "true", "--num_epochs", "1",
                           "--save_summaries_secs", "0"])
    ckpt = latest_checkpoint(train_dir)
    assert ckpt.endswith("model.ckpt-2.msgpack")
    stats = read_checkpoint(ckpt)["params_student"]["video"]["cluster_bn"]
    assert np.any(np.asarray(stats["moving_mean"]) != 0)
    assert np.any(np.asarray(stats["moving_var"]) != 1)
    epoch = eval_cli.main(flags + ["--eval_data_pattern",
                                   str(tmp_path / "validate-*.tfrecord"),
                                   "--run_once", "true"])
    assert 0.0 <= epoch["avg_hit_at_one"] <= 1.0
    assert all(math.isfinite(epoch[k]) for k in ("avg_perr", "gap", "avg_loss"))
    assert glob.glob(os.path.join(train_dir, "eval", "events.out.tfevents.*"))
