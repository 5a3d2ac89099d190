"""`GatedNetVLADModel`, Gated NetVLAD (arXiv:1706.06905, the 2017
YouTube-8M winner), which the port has and the JAX package does not,
against the benchmark's plain reference
(`portbench/reference/gated_netvlad.py`) at a small size on the CPU:
through the port's eval step over uneven lengths, on the benchmark's
seeded weights (batch-norm statistics away from the identity). Each
planted fault fails the comparison. Then the training forward (frames
drawn, moving statistics returned), the published widths, and the model
through the binaries: `cli.finetune --start_new_model` for 2 steps, then
`cli.eval` and `cli.infer` of its checkpoint, and `cli.validate` of a
distillation state (the classifier's input is the model's "state")."""

import csv
import glob
import inspect
import math
import os

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import finetune
from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli import infer as infer_cli
from efficientvideoclassification_youtube8m_torch.cli import validate as validate_cli
from efficientvideoclassification_youtube8m_torch.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_torch.models import frame_level, get_model
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    read_checkpoint,
    save_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import init_distill_state
from efficientvideoclassification_youtube8m_torch.utils import profiling
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from portbench import harness, weights_gnetvlad
from portbench.reference import gated_netvlad as ref_gnetvlad
from portbench.tests.test_portbench_gnetvlad import MODEL_FAULTS

torch.set_num_threads(1)

V = 50
FLAGS = {"feature_sizes": "12, 4", "num_classes": V, "max_num_frames": 12, "every_n": 1,
         "moe_num_mixtures": 2}
WIDTHS = {"vlad_clusters": 16, "hidden_size": 64}
B, T, D = 6, 12, 16
LENGTHS = [12, 1, 7, 11, 3, 9]
# float32: the program and the reference differ in summation order only
# (batched products against one product a video, rsqrt against a
# division); 3.3e-7 measured at most on the predictions (seven seeds).
F32_ATOL = 2e-6
# bfloat16 operands and products (8 significant bits, 2^-9 relative) in a
# chain of seven products, two of them feeding a softmax and batch norms
# that scale their differences up: 4.6e-3 measured at most (the three
# seeds below and four more). The fp8 reference reads 3.0e-2 or more on
# the same seeds, so the tolerance would catch a precision one step lower.
BF16_ATOL = 1.2e-2
SEEDS = [0, 1, 2 ** 31 + 5]


def _cfg(dtype="float32"):
    return TrainConfig(model="GatedNetVLADModel", feature_sizes="12, 4", num_classes=V,
                       max_num_frames=T, every_n=1, compute_dtype=dtype,
                       video_level_classifier_model="MoeModel", moe_num_mixtures=2)


def _model(seed, widths=WIDTHS):
    """The program's module and the reference's leaves: the benchmark's
    draw at `widths`."""
    leaves = weights_gnetvlad.draw({"flags": FLAGS, "gnetvlad": widths}, seed, "cpu")
    module = get_model("GatedNetVLADModel")(
        D, V, feature_sizes=(12, 4), vlad_clusters=widths["vlad_clusters"],
        hidden_size=widths["hidden_size"], classifier_kwargs={"num_mixtures": 2})
    assert set(leaves) == set(dict(module.named_parameters()))
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(leaves[name])
    return module, leaves


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    features = torch.randint(0, 256, (B, T, D), generator=g, dtype=torch.uint8)
    labels = torch.rand(B, V, generator=g) < 0.1
    return features, labels, torch.tensor(LENGTHS, dtype=torch.int32)


def _gap(module, leaves, seed, dtype="float32"):
    """The widest gap of the eval step's predictions to the reference's."""
    features, labels, nf = _inputs(seed)
    got = tstep.build_eval_step(_cfg(dtype), host_subsampled=True)(
        module, features, labels, nf)["predictions"]
    return float((got - ref_gnetvlad.predictions(leaves, features, nf, FLAGS)).abs().max())


@pytest.mark.parametrize("seed", SEEDS)
def test_eval_step_matches_the_reference_in_float32(seed):
    module, leaves = _model(seed)
    assert _gap(module, leaves, seed) <= F32_ATOL


@pytest.mark.parametrize("seed", SEEDS)
def test_eval_step_matches_the_reference_in_bfloat16(seed):
    module, leaves = _model(seed)
    assert _gap(module, leaves, seed, "bfloat16") <= BF16_ATOL
    features, _, nf = _inputs(seed)
    fp8 = ref_gnetvlad.predictions(leaves, features, nf, FLAGS, harness.FP8)
    want = ref_gnetvlad.predictions(leaves, features, nf, FLAGS)
    assert float((fp8 - want).abs().max()) > BF16_ATOL


@pytest.mark.parametrize("fault", MODEL_FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_fails_the_comparison(monkeypatch, fault):
    """Each fault moves a prediction by 0.04 or more (0.04-0.65 measured on
    two seeds): above the bf16 tolerance as well as the float32 one."""
    module, leaves = _model(0)
    fault(monkeypatch, module)
    assert _gap(module, leaves, 0) > 3 * BF16_ATOL


def test_training_draws_frames_and_returns_every_moving_statistic():
    """With `rng` in training the forward draws `iterations` frames of
    each video (`sample_random_frames` on the first half of the key) and
    the batch norms take their moments over those rows; the new moving
    statistics of all five batch norms come back. At inference `rng` and
    the statistics change nothing."""
    module, _ = _model(0)
    features, _, nf = _inputs(0)
    x = tstep.preprocess_batch(_cfg(), features, nf)
    key = prng.prng_key(7)
    out = module(x, nf, rng=key, is_training=True)
    stats = out["updated_stats"]
    assert set(stats) == {f"{n}.{s}" for n in ("input_bn", "video.cluster_bn",
                                               "audio.cluster_bn", "gate_bn", "prob_gate_bn")
                          for s in ("moving_mean", "moving_var")}
    drawn = frame_level.sample_random_frames(x, nf, 300, prng.split(key)[0]).reshape(-1, D)
    torch.testing.assert_close(
        stats["input_bn.moving_mean"],
        0.999 * module.input_bn.moving_mean + 0.001 * drawn.mean(dim=0))
    again = module(x, nf, rng=prng.prng_key(8), is_training=True)["predictions"]
    assert not torch.equal(out["predictions"], again)  # other frames drawn
    inference = module(x, nf, rng=key, is_training=False)
    assert "updated_stats" not in inference
    torch.testing.assert_close(inference["predictions"],
                               module(x, nf, is_training=False)["predictions"])


@pytest.mark.parametrize("iterations", [5, 30, 300])
def test_the_step_passes_iterations_to_the_training_draw(iterations):
    """`--iterations` (the README's command sets 300) reaches the training
    forward through the step's keywords: the input batch norm's moments
    are those of `iterations` frames drawn from each video."""
    cfg = _cfg()
    cfg.iterations = iterations
    kw = tstep._model_apply_kwargs(cfg, torch.device("cpu"))
    assert kw["iterations"] == iterations
    module, _ = _model(0)
    features, _, nf = _inputs(0)
    x = tstep.preprocess_batch(cfg, features, nf)
    key = prng.prng_key(3)
    stats = module(x, nf, rng=key, **kw)["updated_stats"]
    drawn = frame_level.sample_random_frames(x, nf, iterations, prng.split(key)[0])
    assert drawn.shape[1] == iterations
    torch.testing.assert_close(
        stats["input_bn.moving_mean"],
        0.999 * module.input_bn.moving_mean + 0.001 * drawn.reshape(-1, D).mean(dim=0))


def test_two_features_are_required():
    with pytest.raises(ValueError, match="two features"):
        get_model("GatedNetVLADModel")(16, 24, feature_sizes=(16,))
    with pytest.raises(ValueError, match="two features"):
        get_model("GatedNetVLADModel")(16, 24)


def test_published_widths_are_the_defaults():
    """The README's Gated NetVLAD command over the 2017 release: 333.2 M
    parameters (the FC 285.2 M, the MoE 24.2 M, the probability gate
    22.2 M)."""
    module = get_model("GatedNetVLADModel")(1152, 4716, feature_sizes=(1024, 128),
                                            device="meta")
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert shapes["input_bn.scale"] == (1152,)
    assert shapes["video.cluster.w"] == shapes["video.centers"] == (1024, 256)
    assert shapes["audio.cluster.w"] == shapes["audio.centers"] == (128, 128)
    assert shapes["hidden.w"] == (278528, 1024) and shapes["hidden.b"] == (1024,)
    assert shapes["gate.w"] == (1024, 1024) and shapes["gate_bn.scale"] == (1024,)
    assert shapes["classifier.gates.w"] == (1024, 3, 4716)
    assert shapes["classifier.experts.w"] == (1024, 2, 4716)
    assert shapes["prob_gate.w"] == (4716, 4716) and shapes["prob_gate_bn.scale"] == (4716,)
    assert inspect.signature(module.forward).parameters["iterations"].default == 300
    assert sum(p.numel() for p in module.parameters()) == 333_244_440


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two steps of cli.finetune --start_new_model at the published widths
    over 12 + 4 features: (its flags, its train dir, the eval pattern)."""
    root = tmp_path_factory.mktemp("gnetvlad")
    for s in range(2):
        write_synthetic_frame_shard(str(root / f"train-{s}.tfrecord"), num_videos=8,
                                    seed=s, feature_sizes=(12, 4), max_frames=30,
                                    vocab_size=40)
    write_synthetic_frame_shard(str(root / "validate-0.tfrecord"), num_videos=16, seed=9,
                                feature_sizes=(12, 4), max_frames=30, vocab_size=40)
    train_dir = str(root / "model") + "/"
    flags = ["--model", "GatedNetVLADModel", "--every_n", "1", "--num_classes", "40",
             "--feature_names", "rgb, audio", "--feature_sizes", "12, 4",
             "--max_num_frames", "30", "--batch_size", "8", "--num_readers", "1",
             "--compute_dtype", "float32", "--top_k", "5", "--device", "cpu",
             "--train_dir", train_dir]
    finetune.main(flags + ["--train_data_pattern", str(root / "train-*.tfrecord"),
                           "--start_new_model", "true", "--num_epochs", "1",
                           "--save_summaries_secs", "0"])
    return flags, train_dir, str(root / "validate-*.tfrecord")


def test_finetune_writes_the_moving_statistics(trained):
    _, train_dir, _ = trained
    ckpt = latest_checkpoint(train_dir)
    assert ckpt.endswith("model.ckpt-2.msgpack")
    params = read_checkpoint(ckpt)["params_student"]
    for norm in (params["input_bn"], params["video"]["cluster_bn"], params["gate_bn"],
                 params["prob_gate_bn"]):
        assert np.any(np.asarray(norm["moving_mean"]) != 0)
        assert np.any(np.asarray(norm["moving_var"]) != 1)


def test_eval_runs_its_checkpoint_with_its_spans(trained, tmp_path):
    """cli.eval over two batches under a trace: one span of each of the
    four `gnetvlad.*` a batch, inside `step.eval`."""
    flags, train_dir, pattern = trained
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        epoch = eval_cli.main(flags + ["--eval_data_pattern", pattern, "--run_once", "true"])
    assert 0.0 <= epoch["avg_hit_at_one"] <= 1.0
    assert all(math.isfinite(epoch[k]) for k in ("avg_perr", "gap", "avg_loss"))
    assert glob.glob(os.path.join(train_dir, "eval", "events.out.tfevents.*"))
    spans = t.totals["spans"]
    names = ("gnetvlad.video", "gnetvlad.audio", "gnetvlad.hidden", "gnetvlad.head")
    assert spans["step.eval"]["count"] == 2
    assert all(spans[n]["count"] == 2 for n in names)
    recs = profiling.records()
    steps = [r for r in recs if r[0] == "step.eval"]
    for r in recs:
        if r[0] in names:
            assert any(s[1] == r[1] and s[2] <= r[2] and r[3] <= s[3] for s in steps)


def test_validate_runs_a_distillation_state(trained, tmp_path):
    """cli.validate reads both towers of a distillation checkpoint."""
    flags, _, pattern = trained
    flags = flags[:-1] + [str(tmp_path / "distill")]
    cfg = flags_lib.config_from_args(flags_lib.base_parser("").parse_args(flags))
    save_checkpoint(flags[-1], init_distill_state(cfg, make_optimizer(cfg.optimizer)), 3)
    epoch = validate_cli.main(flags + ["--eval_data_pattern", pattern, "--run_once", "true"])
    assert math.isfinite(epoch["avg_loss"])


def test_infer_runs_its_checkpoint(trained, tmp_path):
    flags, _, pattern = trained
    out = str(tmp_path / "pred.csv")
    infer_cli.main(flags + ["--input_data_pattern", pattern, "--output_file", out])
    with open(out) as f:
        assert len(list(csv.reader(f))) == 17  # the header and 16 videos
