"""The port's `--frame_features=False` (aggregated video-level) branch on
the CPU, as tests/test_aggregated.py drives the JAX package's: any
video-level model trains, evaluates and infers straight on [B, D]
pre-aggregated Example features. The port's binaries learn the
learnable shards; its finetune and eval steps agree with the JAX
package's from one init on one batch (dropout included); its loader reads
the JAX loader's batches; and each package's cli.infer reads the other's
checkpoint into the same CSV.

Tolerances: one finetune step, losses within 1e-5 relative, updated
parameters within 1e-5 absolute (f32 sums in another order; TF-Adam's
normalized step magnifies the rounding of a near-zero gradient element,
as in tests/test_torch_train_step.py: 1.2e-6 measured, an MoE weight at
learning rate 0.05); eval predictions within 1e-6; CSV probabilities
within 1e-6 (the CSV prints 6 decimals)."""

import csv
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.cli import infer as jax_infer
from efficientvideoclassification_youtube8m_tpu.data import (
    AggregatedDataLoader as JaxAggregatedDataLoader,
)
from efficientvideoclassification_youtube8m_tpu.train import step as jstep
from efficientvideoclassification_youtube8m_tpu.train.optimizer import (
    make_optimizer as jax_make_optimizer,
)
from efficientvideoclassification_youtube8m_tpu.train.state import (
    init_distill_state as jax_init_distill_state,
    student_state_from_distill as jax_student_state,
)
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import finetune, flags, infer, train, validate
from efficientvideoclassification_youtube8m_torch.data import (
    AggregatedDataLoader,
    AggregatedVideo,
    TFRecordWriter,
    encode_aggregated_record,
    parse_aggregated_record,
)
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.checkpoint import latest_checkpoint
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    params_of,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params

torch.set_num_threads(1)

VOCAB = 40
FEATURE_NAMES = ("mean_rgb", "mean_audio")
FEATURE_SIZES = (6, 2)
TOTAL = sum(FEATURE_SIZES)
AGG_FLAGS = [
    "--frame_features", "false", "--num_classes", str(VOCAB), "--batch_size", "32",
    "--feature_names", "mean_rgb, mean_audio", "--feature_sizes", "6, 2",
    "--num_readers", "2", "--compute_dtype", "float32", "--top_k", "5",
    "--base_learning_rate", "0.1", "--save_model_secs", "100000", "--device", "cpu",
]
STEP_RTOL, PARAM_ATOL, PRED_ATOL = 1e-5, 1e-5, 1e-6


def write_learnable_aggregated_shard(path, num_videos, seed, noise=0.05):
    """One label a video; features = the label's prototype plus noise:
    linearly separable (tests/test_aggregated.py's shards)."""
    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(99).normal(size=(VOCAB, TOTAL))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    truth = []
    with TFRecordWriter(path) as w:
        for i in range(num_videos):
            c = int(rng.integers(VOCAB))
            feats = (protos[c] + noise * rng.normal(size=TOTAL)).astype(np.float32)
            vid = f"agg{seed:02d}_{i:05d}"
            w.write(encode_aggregated_record(vid, [c], feats, FEATURE_NAMES, FEATURE_SIZES))
            truth.append(AggregatedVideo(vid, [c], feats))
    return truth


@pytest.fixture(scope="module")
def agg_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("aggregated")
    data_dir = root / "data"
    data_dir.mkdir()
    for s in range(2):
        write_learnable_aggregated_shard(str(data_dir / f"train-{s:04d}.tfrecord"),
                                         num_videos=128, seed=s)
    truth = write_learnable_aggregated_shard(str(data_dir / "validate-0000.tfrecord"),
                                             num_videos=64, seed=9)
    return {"root": root, "truth": truth,
            "train_pattern": str(data_dir / "train-*.tfrecord"),
            "eval_pattern": str(data_dir / "validate-*.tfrecord")}


def _finetune_eval(agg_dirs, model, extra=()):
    train_dir = str(agg_dirs["root"] / f"model_{model}") + "/"
    finetune.main(AGG_FLAGS + list(extra) + [
        "--model", model, "--train_dir", train_dir, "--num_epochs", "40",
        "--train_data_pattern", agg_dirs["train_pattern"], "--start_new_model", "true"])
    assert latest_checkpoint(train_dir).endswith("model.ckpt-320.msgpack")
    epoch = eval_cli.main(AGG_FLAGS + list(extra) + [
        "--model", model, "--train_dir", train_dir, "--run_once", "true",
        "--eval_data_pattern", agg_dirs["eval_pattern"]])
    assert glob.glob(os.path.join(train_dir, "eval", "events.out.*"))
    return train_dir, epoch


def test_finetune_eval_logistic(agg_dirs):
    """LogisticModel trains from scratch on the aggregated shards and the
    held-out epoch shows it learned the linear map."""
    _, epoch = _finetune_eval(agg_dirs, "LogisticModel")
    assert epoch["avg_hit_at_one"] > 0.9 and epoch["gap"] > 0.8
    assert np.isfinite(epoch["avg_loss"])


def test_finetune_eval_moe(agg_dirs):
    _, epoch = _finetune_eval(agg_dirs, "MoeModel", ("--moe_num_mixtures", "2"))
    assert epoch["avg_hit_at_one"] > 0.9


def _rows(path):
    with open(path) as f:
        reader = csv.reader(f)
        assert next(reader) == ["VideoId", "LabelConfidencePairs"]
        return {vid: pairs.split() for vid, pairs in reader}


def test_infer_aggregated_and_across_packages(agg_dirs):
    """cli.infer --frame_features=False: the top-1 is the known label for
    most videos, and the JAX package's cli.infer on the port's checkpoint
    writes the same rows."""
    train_dir = str(agg_dirs["root"] / "model_infer") + "/"
    finetune.main(AGG_FLAGS + ["--model", "LogisticModel", "--train_dir", train_dir,
                               "--num_epochs", "40", "--start_new_model", "true",
                               "--train_data_pattern", agg_dirs["train_pattern"]])
    outs = {}
    for name, binary, extra in (("port", infer, ["--device", "cpu"]), ("jax", jax_infer, [])):
        outs[name] = str(agg_dirs["root"] / f"preds_{name}.csv")
        argv = [a for a in AGG_FLAGS if a not in ("--device", "cpu")] + extra
        binary.main(argv + ["--model", "LogisticModel", "--train_dir", train_dir,
                            "--input_data_pattern", agg_dirs["eval_pattern"],
                            "--output_file", outs[name]])
    port, other = _rows(outs["port"]), _rows(outs["jax"])
    truth = {v.video_id: v.labels[0] for v in agg_dirs["truth"]}
    assert sorted(port) == sorted(other) == sorted(truth)
    assert sum(int(port[v][0]) == truth[v] for v in truth) / len(truth) > 0.9
    for vid in truth:
        got, want = port[vid], other[vid]
        np.testing.assert_allclose(np.float64(got[1::2]), np.float64(want[1::2]),
                                   atol=PRED_ATOL)
        assert got[0::2] == want[0::2], vid


def test_train_cli_rejects_aggregated(agg_dirs):
    """Distillation and validation need frame features: the JAX
    package's messages."""
    for binary, pattern in ((train, "--train_data_pattern"), (validate, "--eval_data_pattern")):
        with pytest.raises(ValueError, match="requires frame-level features"):
            binary.main(AGG_FLAGS + ["--train_dir", str(agg_dirs["root"] / "nope") + "/",
                                     pattern, agg_dirs["train_pattern"]])


def test_frame_level_model_rejected_on_aggregated_input():
    cfg = TrainConfig(model="HierarchicalLstmModel", num_classes=VOCAB,
                      feature_names="mean_rgb, mean_audio", feature_sizes="6, 2")
    with pytest.raises(ValueError, match="video-level"):
        tstep.forward_video_level(cfg, None, torch.zeros(4, TOTAL))


def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, TOTAL)).astype(np.float32)
    labels = rng.random((n, VOCAB)) < 0.1
    return feats, labels, np.ones(n, np.int32)


@pytest.mark.parametrize("model,extra", [
    ("LogisticModel", {}),
    ("MoeModel", {"moe_num_mixtures": 3}),
    ("SingleHiddenLayerModelDropout", {"num_hidden_units": 7, "dropout": 0.5}),
])
def test_aggregated_finetune_step_matches_jax(model, extra):
    """One `build_finetune_step(aggregated=True)` step of each package from
    one init on one batch: the l2-normalized input, the video-level
    forward (dropout masks from the step's key), the loss, the update;
    then one eval step."""
    cfg = TrainConfig(model=model, num_classes=VOCAB, feature_names="mean_rgb, mean_audio",
                      feature_sizes="6, 2", compute_dtype="float32", batch_size=16,
                      base_learning_rate=0.05, **extra)
    jopt = jax_make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    jstate = jax_student_state(jax_init_distill_state(cfg, jopt), jopt)
    jnew, jm = jax.jit(jstep.build_finetune_step(cfg, jopt, top_k=5, aggregated=True))(
        jstate, *map(jnp.asarray, _batch(0)))
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(cfg, opt), opt)
    load_jax_params(state.student, jax.tree.map(np.asarray, jstate.params_student))
    state, m = tstep.build_finetune_step(cfg, opt, top_k=5, aggregated=True)(
        state, *map(torch.from_numpy, _batch(0)))
    for key in ("student_label_loss", "student_reg_loss"):
        np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=STEP_RTOL, err_msg=key)
    np.testing.assert_array_equal(m["topk_idx"].numpy(), np.asarray(jm["topk_idx"]))
    want = jax.tree_util.tree_flatten_with_path(jnew.params_student)[0]
    want = {".".join(str(k.key) for k in path): np.asarray(v) for path, v in want}
    for name, p in params_of(state.student).items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=PARAM_ATOL,
                                   err_msg=name)
    feats, labels, nf = _batch(1)
    jout = jax.jit(jstep.build_eval_step(cfg, top_k=5, aggregated=True))(
        jnew.params_student, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(nf))
    tout = tstep.build_eval_step(cfg, top_k=5, aggregated=True)(
        state.student, *map(torch.from_numpy, (feats, labels, nf)))
    np.testing.assert_allclose(tout["predictions"].numpy(), np.asarray(jout["predictions"]),
                               atol=PRED_ATOL)
    np.testing.assert_allclose(tout["per_example_loss"].numpy(),
                               np.asarray(jout["per_example_loss"]), rtol=STEP_RTOL)


def test_aggregated_step_math():
    """sigmoid(W . l2norm(x) + b) exactly: the reference's unconditional
    last-axis l2_normalize, no dequantize (eval_finetune.py:134-137)."""
    cfg = TrainConfig(model="LogisticModel", num_classes=VOCAB,
                      feature_names="mean_rgb, mean_audio", feature_sizes="6, 2",
                      compute_dtype="float32")
    rng = np.random.default_rng(3)
    w = rng.normal(size=(TOTAL, VOCAB)).astype(np.float32)
    b = rng.normal(size=(VOCAB,)).astype(np.float32)
    model = init_distill_state(cfg, make_optimizer(cfg.optimizer)).student
    load_jax_params(model, {"fc": {"w": w, "b": b}})
    feats = rng.normal(size=(8, TOTAL)).astype(np.float32)
    out = tstep.build_eval_step(cfg, top_k=5, aggregated=True)(
        model, torch.from_numpy(feats), torch.zeros(8, VOCAB, dtype=torch.bool),
        torch.ones(8, dtype=torch.int32))
    x = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    want = 1.0 / (1.0 + np.exp(-(x @ w + b)))
    np.testing.assert_allclose(out["predictions"].numpy(), want, rtol=1e-5, atol=1e-6)


def test_aggregated_loader_matches_jax(agg_dirs):
    """The port's copy of the loader reads the JAX loader's batches, in
    order and shuffled, with the all-ones num_frames placeholder; and the
    parser reads the writer's records back bit for bit."""
    truth = write_learnable_aggregated_shard(str(agg_dirs["root"] / "rt.tfrecord"),
                                             num_videos=10, seed=5)
    for kw in ({"shuffle": False, "batch_size": 10},
               {"shuffle": True, "seed": 3, "batch_size": 4, "pad_final_batch": True}):
        args = (agg_dirs["train_pattern"] if kw["shuffle"]
                else str(agg_dirs["root"] / "rt.tfrecord"),)
        common = dict(feature_names=FEATURE_NAMES, feature_sizes=FEATURE_SIZES,
                      vocab_size=VOCAB, num_epochs=1, num_readers=1, **kw)
        got = list(AggregatedDataLoader(*args, **common))
        want = list(JaxAggregatedDataLoader(*args, **common))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.video_ids == w.video_ids and g.pad == w.pad
            for field in ("features", "labels", "num_frames"):
                np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
    (batch,) = list(AggregatedDataLoader(str(agg_dirs["root"] / "rt.tfrecord"),
                                         batch_size=10, feature_names=FEATURE_NAMES,
                                         feature_sizes=FEATURE_SIZES, vocab_size=VOCAB,
                                         shuffle=False, num_epochs=1))
    np.testing.assert_array_equal(batch.num_frames, np.ones(10, np.int32))
    by_id = {v.video_id: v for v in truth}
    for i, vid in enumerate(batch.video_ids):
        np.testing.assert_array_equal(batch.features[i], by_id[vid].features)
        assert sorted(np.nonzero(batch.labels[i])[0]) == by_id[vid].labels
    record = encode_aggregated_record("x", [1], np.arange(TOTAL, dtype=np.float32),
                                      FEATURE_NAMES, FEATURE_SIZES)
    with pytest.raises(IOError, match="mean_rgb"):
        parse_aggregated_record(record, FEATURE_NAMES, (5, 3))


def test_reference_invocation_parses():
    """The reference eval_finetune aggregated invocation parses 1:1
    (eval_finetune.py:298-302)."""
    args = flags.base_parser("t").parse_args([
        "--eval_data_pattern", "/data/validate-*.tfrecord", "--frame_features", "False",
        "--model", "MoeModel", "--feature_names", "mean_rgb, mean_audio",
        "--feature_sizes", "1024, 128", "--batch_size", "1024", "--run_once", "True"])
    assert args.frame_features is False
    cfg = flags.config_from_args(args)
    assert cfg.total_feature_size == 1152
    assert cfg.feature_names_list == ["mean_rgb", "mean_audio"]
