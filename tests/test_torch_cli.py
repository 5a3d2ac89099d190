"""The port's five binaries (train -> validate -> convert -> finetune ->
eval) on synthetic shards at tests/test_pipeline_e2e.py's tiny flags, on
the CPU; and the same pipeline crossing between the packages: both
trainers from one JAX step-0 checkpoint, and each package's checkpoints
evaluated by the other's cli.eval."""

import datetime
import glob
import importlib
import os
import socket

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.cli import convert as jax_convert
from efficientvideoclassification_youtube8m_tpu.cli import eval as jax_eval
from efficientvideoclassification_youtube8m_tpu.cli import finetune as jax_finetune
from efficientvideoclassification_youtube8m_tpu.cli import flags as jax_flags
from efficientvideoclassification_youtube8m_tpu.cli import train as jax_train
from efficientvideoclassification_youtube8m_tpu.data import (
    TFRecordWriter,
    encode_frame_record,
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_tpu.metrics import eval_util as jax_eval_util
from efficientvideoclassification_youtube8m_tpu.parallel import distributed as jax_dist
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state as jax_init_distill_state,
    make_optimizer as jax_make_optimizer,
    restore_checkpoint as jax_restore_checkpoint,
    save_checkpoint as jax_save_checkpoint,
    student_state_from_distill as jax_student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.cli import convert, finetune, train, validate
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import flags
from efficientvideoclassification_youtube8m_torch.metrics import eval_util
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.serving import Predictor
from efficientvideoclassification_youtube8m_torch.data import TFRecordReader, iter_fields
from efficientvideoclassification_youtube8m_torch.train import msgpack_io
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    read_checkpoint,
    restore_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    StudentState,
    init_model,
    params_of,
    state_tree,
)

torch.set_num_threads(1)

TINY_FLAGS = [
    "--num_classes", "40", "--batch_size", "8", "--lstm_cells", "8",
    "--lstm_layers", "2", "--max_num_frames", "40",
    "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2", "--every_n", "2",
    "--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
    "--num_readers", "2", "--deterministic_input", "true",
    "--compute_dtype", "float32", "--top_k", "5", "--scan_unroll", "1",
    "--device", "cpu",
]
# both trainers read the single-reader batch stream
SAME_BATCHES = ["--num_readers", "1"]
# Six distill steps from one checkpoint, JAX's XLA scan against the port's
# plain torch scan, both f32 with sums in another order; TF-Adam's
# normalized step magnifies the relative error of a near-zero gradient
# element (tests/test_torch_train_step.py), so the bound leaves a margin
# of 15x over the 6.6e-7 measured on the parameters (5.3e-8 on mu, 2.3e-10
# on nu).
TRAIN_ATOL = 1e-5
# Epoch metrics of one checkpoint through the two packages' eval: the f32
# forwards differ by summation order only (3e-8 on the predictions,
# tests/test_torch_eval_step.py), which moves no rank on these videos:
# Hit@1, PERR, GAP, mAP and the mean CE measured equal.
EVAL_ATOL = 1e-6
LOSS_ATOL = 1e-5
EPOCH_KEYS = ("avg_hit_at_one", "avg_perr", "gap")


def _data(root):
    data_dir = root / "data"
    data_dir.mkdir()
    for s in range(2):
        write_synthetic_frame_shard(
            str(data_dir / f"train-{s:04d}.tfrecord"), num_videos=12, seed=s,
            feature_names=("rgb", "audio"), feature_sizes=(6, 2),
            max_frames=40, vocab_size=40)
    write_synthetic_frame_shard(
        str(data_dir / "validate-0000.tfrecord"), num_videos=10, seed=9,
        feature_names=("rgb", "audio"), feature_sizes=(6, 2),
        max_frames=40, vocab_size=40)
    return str(data_dir / "train-*.tfrecord"), str(data_dir / "validate-*.tfrecord")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    train_pattern, eval_pattern = _data(root)
    return {"root": root, "train_pattern": train_pattern,
            "eval_pattern": eval_pattern,
            "train_dir": str(root / "model_train") + "/",
            "finetune_dir": str(root / "model_") + "/finetune/"}


def _leaves(path, prefix=""):
    tree = read_checkpoint(path)
    out = {}

    def walk(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{name}{k}/")
        else:
            out[name[:-1]] = np.asarray(node)

    walk(tree, prefix)
    return out


def _epoch_metrics(run):
    """The epoch metrics of every eval epoch `run()` makes, through the
    EvaluationMetrics class of either package (each package's binaries use
    their own)."""
    captured = []
    classes = (jax_eval_util.EvaluationMetrics, eval_util.EvaluationMetrics)
    originals = [cls.get for cls in classes]

    def capturing(orig):
        def capture(self):
            data = orig(self)
            captured.append(data)
            return data
        return capture

    for cls, orig in zip(classes, originals):
        cls.get = capturing(orig)
    try:
        run()
    finally:
        for cls, orig in zip(classes, originals):
            cls.get = orig
    return captured


def test_01_train(dirs):
    train.main(TINY_FLAGS + [
        "--train_dir", dirs["train_dir"],
        "--train_data_pattern", dirs["train_pattern"],
        "--num_epochs", "2", "--start_new_model", "true"])
    ckpt = latest_checkpoint(dirs["train_dir"])
    # 24 videos * 2 epochs / batch 8 = 6 batches -> global_step 12 (2/batch)
    assert ckpt.endswith("model.ckpt-12.msgpack")
    assert glob.glob(os.path.join(dirs["train_dir"], "events.out.*"))


def test_01b_train_resume(dirs):
    """Without --start_new_model the trainer resumes from the latest
    checkpoint (train.py:470-475)."""
    state = train.main(TINY_FLAGS + [
        "--train_dir", dirs["train_dir"],
        "--train_data_pattern", dirs["train_pattern"], "--num_epochs", "1"])
    assert state.global_step == 18
    assert latest_checkpoint(dirs["train_dir"]).endswith("model.ckpt-18.msgpack")


def test_02_validate(dirs):
    data = validate.main(TINY_FLAGS + [
        "--train_dir", dirs["train_dir"],
        "--eval_data_pattern", dirs["eval_pattern"], "--run_once", "true"])
    assert data["epoch_id"] == 18 and np.isfinite(data["avg_loss"])
    assert 0.0 <= data["gap"] <= 1.0
    assert glob.glob(os.path.join(dirs["train_dir"], "eval", "events.out.*"))


def test_03_convert(dirs):
    """The converted student is bit-equal to the trained one; its slots and
    step start anew."""
    path = convert.main(TINY_FLAGS + ["--train_dir", dirs["train_dir"]])
    assert path == os.path.join(dirs["finetune_dir"], "model.ckpt-0.msgpack")
    trained = _leaves(latest_checkpoint(dirs["train_dir"]))
    converted = _leaves(path)
    params = [k for k in converted if k.startswith("params_student/")]
    assert len(params) == 11
    for key in params:
        np.testing.assert_array_equal(converted[key], trained[key], err_msg=key)
    assert not any(k.startswith(("params_teacher", "opt_teacher")) for k in converted)
    assert int(converted["global_step"]) == 0
    assert int(converted["opt_student/count"]) == 0
    assert not converted["opt_student/mu/rnn_l1/0/kernel"].any()


def test_04_finetune(dirs):
    finetune.main(TINY_FLAGS + [
        "--train_dir", dirs["finetune_dir"],
        "--train_data_pattern", dirs["train_pattern"], "--num_epochs", "1"])
    ckpt = latest_checkpoint(dirs["finetune_dir"])
    # 24 videos / batch 8 = 3 batches -> student global_step 3 (1/batch)
    assert ckpt.endswith("model.ckpt-3.msgpack")
    tuned = _leaves(ckpt)
    trained = _leaves(latest_checkpoint(dirs["train_dir"]))
    for key in ("params_student/rnn_l1/0/kernel", "params_student/classifier/gates/w"):
        assert not np.array_equal(tuned[key], trained[key]), key
    assert int(tuned["opt_student/count"]) == 3


def test_05_eval_and_int8(dirs):
    """cli.eval and cli.eval --quantize int8 over the pipeline's finetuned
    student: the epoch of the finetune checkpoint, finite metrics."""
    for quant in ("none", "int8"):
        data = eval_cli.main(TINY_FLAGS + [
            "--train_dir", dirs["finetune_dir"],
            "--eval_data_pattern", dirs["eval_pattern"], "--run_once", "true",
            "--quantize", quant])
        assert data["epoch_id"] == 3 and np.isfinite(data["avg_loss"])
        assert all(0.0 <= data[key] <= 1.0 for key in EPOCH_KEYS)


def _write_prototype_shard(path, num_videos, seed, num_classes=40, size=8,
                           frames=40):
    """tests/test_torch_quantize.py's learnable mapping as a shard: one
    label a video, frames = the class prototype plus noise."""
    protos = np.random.default_rng(1234).normal(size=(num_classes, size))
    protos = protos / np.linalg.norm(protos, axis=1, keepdims=True) * 80 + 128
    rng = np.random.default_rng(seed)
    with TFRecordWriter(path) as w:
        for i in range(num_videos):
            c = int(rng.integers(num_classes))
            feats = np.clip(protos[c] + rng.normal(scale=6.0, size=(frames, size)),
                            0, 255).astype(np.uint8)
            w.write(encode_frame_record(f"p{seed}_{i}", [c], feats,
                                        ("rgb", "audio"), (6, 2)))


def test_05b_int8_within_2e3_on_a_trained_student(tmp_path):
    """The deploy-gate bar of tests/test_quantize.py through the binaries:
    a student that predicts (cli.finetune --start_new_model on a learnable
    mapping), then cli.eval and cli.eval --quantize int8 on held-out
    videos: epoch Hit@1, PERR, GAP and mAP within 2e-3."""
    _write_prototype_shard(str(tmp_path / "train-0.tfrecord"), 256, seed=0)
    _write_prototype_shard(str(tmp_path / "validate-0.tfrecord"), 192, seed=1)
    flags_32 = TINY_FLAGS + ["--batch_size", "32", "--base_learning_rate", "0.02",
                             "--train_dir", str(tmp_path / "student") + "/"]
    finetune.main(flags_32 + [
        "--train_data_pattern", str(tmp_path / "train-*.tfrecord"),
        "--num_epochs", "28", "--start_new_model", "true"])
    runs = {quant: eval_cli.main(flags_32 + [
        "--eval_data_pattern", str(tmp_path / "validate-*.tfrecord"),
        "--run_once", "true", "--quantize", quant]) for quant in ("none", "int8")}
    base, quant = runs["none"], runs["int8"]
    assert base["avg_hit_at_one"] > 0.9  # the comparison is meaningful
    for key in EPOCH_KEYS:
        assert abs(base[key] - quant[key]) <= 2e-3, (key, base[key], quant[key])
    assert abs(np.mean(base["aps"]) - np.mean(quant["aps"])) <= 2e-3


def test_06_predictor_from_checkpoint(dirs):
    """Predictor.from_checkpoint serves a distill dir's student or teacher
    and a finetune dir's student; a finetune dir has no teacher."""
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 256, (3, 40, 8), dtype=np.uint8)
    nf = np.array([40, 7, 1], np.int32)
    for train_dir, tower in ((dirs["train_dir"], "teacher"),
                             (dirs["train_dir"], "student"),
                             (dirs["finetune_dir"], "student")):
        p = Predictor.from_checkpoint(train_dir, cfg, tower=tower, serve_batch=4,
                                      device="cpu")
        leaves = _leaves(latest_checkpoint(train_dir))
        np.testing.assert_array_equal(
            p.model.rnn_l2[1].kernel.detach().numpy(),
            leaves[f"params_{tower}/rnn_l2/1/kernel"])
        probs = p.predict(feats, nf)
        assert probs.shape == (3, 40) and np.all(np.isfinite(probs))
    with pytest.raises(ValueError, match="no teacher tower"):
        Predictor.from_checkpoint(dirs["finetune_dir"], cfg, tower="teacher",
                                  device="cpu")


TENSOR_PARALLEL = "ROADMAP Queue 1, the tensor-parallel MoE head"
ORBAX = "ROADMAP Queue 1, orbax checkpoints"
HOST_PATHS = "ROADMAP Queue 1, the host paths of the binaries"


@pytest.mark.parametrize("binary,extra,match", [
    (train, ["--use_shardmap_train", "true"], None),
    # ported now: one process is a mesh of one device, which model=2 does
    # not divide (the JAX create_mesh's ValueError); the id is the case's own
    pytest.param(train, ["--model_parallelism", "2"], "not divisible by model=2",
                 id=f"{train.__name__}-extra1-{TENSOR_PARALLEL}"),
    # ported now (the ids are the cases' own): a run with the option is the
    # run without it (None)
    pytest.param(train, ["--checkpoint_format", "orbax"], None,
                 id=f"{train.__name__}-extra2-{ORBAX}"),
    pytest.param(eval_cli, ["--steps_per_dispatch", "3"], None,
                 id=f"{eval_cli.__name__}-extra3-{HOST_PATHS}"),
    pytest.param(validate, ["--steps_per_dispatch", "3"], None,
                 id=f"{validate.__name__}-extra4-{HOST_PATHS}"),
])
def test_07_unported_options_raise(dirs, tmp_path, binary, extra, match):
    """The options that were not ported. Each run with one (match None)
    is the run without it: `--use_shardmap_train` names the data-parallel
    step every run takes, and `--checkpoint_format orbax` writes an orbax
    directory holding the msgpack file's state, bit for bit;
    `--steps_per_dispatch 3` gives the epoch metrics of one batch a
    launch (rank metrics bit-equal, avg_loss within 1e-6 relative, the
    JAX CLI tests' ulp allowance). `--model_parallelism 2` is ported: in
    one process it raises the JAX package's ValueError for one device
    (tests/test_torch_tensor_parallel.py runs it over two ranks)."""
    argv = TINY_FLAGS + ["--train_data_pattern", dirs["train_pattern"],
                         "--eval_data_pattern", dirs["eval_pattern"],
                         "--run_once", "true"]
    if match is None and binary is train:
        runs = [binary.main(argv + extra + ["--train_dir", str(tmp_path / "flag")]),
                binary.main(argv + ["--train_dir", str(tmp_path / "plain")])]
        got, want = (_leaves(latest_checkpoint(str(tmp_path / d))) for d in ("flag", "plain"))
        assert runs[0].global_step == runs[1].global_step > 0
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        if "orbax" in extra:
            assert os.path.isdir(latest_checkpoint(str(tmp_path / "flag")))
        return
    if match is None:
        got, want = (binary.main(argv + ["--train_dir", dirs["train_dir"]] + e)
                     for e in (extra, []))
        assert sorted(got) == sorted(want)
        for key in want:  # Hit@1, PERR, GAP, every AP
            if key != "avg_loss":
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["avg_loss"], want["avg_loss"], rtol=1e-6)
        return
    with pytest.raises(ValueError, match=match):
        binary.main(argv + ["--train_dir", dirs["train_dir"]] + extra)


@pytest.mark.parametrize("name,match", [("export_tf", "model.ckpt-18")])
def test_07b_unported_binaries_raise(dirs, tmp_path, name, match):
    """The binaries that were stubs run now: cli.export_tf writes the
    trained distill checkpoint as a TF-V2 bundle named by its step, which
    restores to the checkpoint's parameters
    (tests/test_torch_tf_checkpoint.py holds it against the JAX binary)."""
    binary = importlib.import_module(
        f"efficientvideoclassification_youtube8m_torch.cli.{name}")
    out = binary.main(TINY_FLAGS + ["--train_dir", dirs["train_dir"], "--output_prefix",
                                    str(tmp_path / "tf_export" / "model.ckpt")])
    assert out.endswith(match) and os.path.exists(out + ".index")
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    state = StudentState(student=init_model(cfg), opt_student={}, global_step=0,
                         dropout_keep_prob=1.0)
    restore_checkpoint(out, state)
    want = _leaves(latest_checkpoint(dirs["train_dir"]))
    for name_, value in state.student.state_dict().items():
        np.testing.assert_array_equal(
            value.numpy(), want["params_student/" + name_.replace(".", "/")], err_msg=name_)
    assert state.global_step == 18


@pytest.mark.parametrize("binary,extra,error,match", [
    (train, ["--model", "DbofModel", "--dbof_cluster_size", "8",
             "--dbof_hidden_size", "4"], ValueError, "distillation 'state'"),
    (train, ["--frame_features", "false"], ValueError, "requires frame-level features"),
    (validate, ["--frame_features", "false"], ValueError, "requires frame-level features"),
    (eval_cli, ["--frame_features", "false", "--quantize", "int8"], ValueError,
     "frame-level student path"),
    (eval_cli, ["--model", "DbofModel", "--quantize", "int8"], ValueError, "flagship"),
])
def test_07c_zoo_options_fail_as_in_jax(dirs, tmp_path, binary, extra, error, match):
    """The zoo's flags run in the port; what the JAX binaries refuse, the
    port refuses with the same message (DBoF has no distillation state;
    distillation and validation need frame features; int8 is the
    flagship's frame path)."""
    with pytest.raises(error, match=match):
        binary.main(TINY_FLAGS + ["--train_dir", str(tmp_path / "zoo") + "/",
                                  "--train_data_pattern", dirs["train_pattern"],
                                  "--eval_data_pattern", dirs["eval_pattern"],
                                  "--start_new_model", "true",
                                  "--run_once", "true"] + extra)


def test_07d_validate_with_another_head(dirs, tmp_path):
    """The flagship with a non-MoE head through train and validate."""
    head = ["--video_level_classifier_model", "SingleHiddenLayerModelDropout",
            "--num_hidden_units", "6", "--dropout", "0.5", "--num_epochs", "1"]
    train_dir = str(tmp_path / "head") + "/"
    state = train.main(TINY_FLAGS + head + ["--train_dir", train_dir, "--start_new_model",
                                            "true", "--train_data_pattern",
                                            dirs["train_pattern"]])
    assert state.global_step == 2 * 3 and state.dropout_keep_prob == 0.5
    epoch = validate.main(TINY_FLAGS + head + ["--train_dir", train_dir, "--run_once",
                                               "true", "--eval_data_pattern",
                                               dirs["eval_pattern"]])
    assert epoch["epoch_id"] == 6 and np.isfinite(epoch["avg_loss"])


def test_08_flags_devices_and_clusters(dirs, tmp_path, monkeypatch):
    parser = flags.base_parser("")
    args = parser.parse_args(TINY_FLAGS)
    cfg = flags.config_from_args(args)
    # the parameter dump is the JAX package's, line for line
    jstate = jax_init_distill_state(cfg, jax_make_optimizer(cfg.optimizer))
    model = init_model(cfg)
    assert (flags.param_names(model, "model_student")
            == jax_flags.param_names(jstate.params_student, "model_student"))
    # steps_per_dispatch: auto and negatives resolve to 1
    for k in (0, -2, 1):
        args.steps_per_dispatch = k
        assert flags.resolve_steps_per_dispatch(args) == 1
        assert args.steps_per_dispatch == 1
    for device, want in (("cpu", "cpu"), ("/cpu:0", "cpu")):
        assert flags.resolve_device(parser.parse_args(["--device", device])) == torch.device(want)
    if not torch.cuda.is_available():  # never a silent fall-back to the CPU
        for argv in ([], ["--device", "cuda:0"], ["--device", "/gpu:1"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                flags.resolve_device(parser.parse_args(argv))
    with pytest.raises(ValueError):
        flags.resolve_device(parser.parse_args(["--device", "tpu"]))
    # a two-host TF_CONFIG whose worker never comes: the binary joins the
    # group as its master, waits the (shortened) timeout and raises
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("TF_CONFIG", '{"cluster": {"master": ["localhost:%d"], '
                       '"worker": ["localhost:1"]}, "task": {"type": "master"}}' % port)
    monkeypatch.setattr(distributed, "DEFAULT_TIMEOUT", datetime.timedelta(seconds=2))
    with pytest.raises(torch.distributed.DistError):
        train.main(TINY_FLAGS + ["--train_dir", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("TF_CONFIG")
    with pytest.raises(IOError, match="no converted checkpoint"):
        finetune.main(TINY_FLAGS + ["--train_dir", str(tmp_path / "empty"),
                                    "--train_data_pattern", dirs["train_pattern"]])


@pytest.mark.parametrize("k", [3, 4, 5])
def test_09_host_pack_unpacks_as_jax(k):
    """The port's unpack_host_pack reads both pack layouts as the JAX
    package's does, and gather_step_outputs drops the padding rows."""
    rng = np.random.default_rng(k)
    B, h = 6, (k + 1) // 2
    vals = rng.random((B, k)).astype(np.float32)
    idx = rng.integers(0, 4716, (B, k)).astype(np.int32)
    padded = np.pad(idx, ((0, 0), (0, 2 * h - k)))
    words = (padded[:, 0::2] | (padded[:, 1::2] << 16) | np.int32(-(1 << 30)))
    tail = rng.random((B, 2)).astype(np.float32)
    labels = rng.random((B, 40)) < 0.1
    for pack in (np.concatenate([vals, words.view(np.float32), tail], 1),
                 np.concatenate([vals, idx.astype(np.float32), tail], 1)):
        got = distributed.unpack_host_pack(pack, labels)
        want = jax_dist.unpack_host_pack(pack, labels)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        rows = distributed.gather_step_outputs(
            {"host_pack": torch.from_numpy(pack)}, labels, pad=2)
        assert rows["topk_idx"].shape == (B - 2, k)
        np.testing.assert_array_equal(rows["topk_idx"], idx[:B - 2])


# ---------------------------------------------------- across the packages

@pytest.fixture(scope="module")
def cross(dirs):
    """One JAX step-0 distill checkpoint saved into two train dirs; the JAX
    package's cli.train runs in one, the port's in the other, over the
    same batches."""
    root = dirs["root"]
    cfg = jax_flags.config_from_args(
        jax_flags.base_parser("").parse_args(TINY_FLAGS))
    state = jax_init_distill_state(cfg, jax_make_optimizer(cfg.optimizer))
    out = {"init": jax_save_checkpoint(str(root / "init"), state, 0)}
    for pkg, binary in (("jax", jax_train), ("port", train)):
        train_dir = str(root / f"{pkg}_model_train") + "/"
        jax_save_checkpoint(train_dir, state, 0)
        binary.main(TINY_FLAGS + SAME_BATCHES + [
            "--train_dir", train_dir,
            "--train_data_pattern", dirs["train_pattern"], "--num_epochs", "2"])
        out[pkg] = train_dir
    return out


def test_10_cross_package_training(cross):
    """Six distill steps of each package's cli.train from the same JAX
    step-0 checkpoint end in checkpoints that agree leaf by leaf."""
    jax_leaves = _leaves(latest_checkpoint(cross["jax"]))
    port_leaves = _leaves(latest_checkpoint(cross["port"]))
    assert latest_checkpoint(cross["port"]).endswith("model.ckpt-12.msgpack")
    assert jax_leaves.keys() == port_leaves.keys()
    worst = {}
    for key, want in jax_leaves.items():
        got = port_leaves[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            worst[key] = float(np.abs(got - want).max())
    assert int(port_leaves["global_step"]) == 12
    assert int(port_leaves["opt_teacher/count"]) == 6
    init = _leaves(cross["init"])
    moved = max(float(np.abs(port_leaves[k] - init[k]).max())
                for k in init if k.startswith("params_"))
    assert moved > 100 * TRAIN_ATOL  # the runs went somewhere
    assert max(worst.values()) <= TRAIN_ATOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:3]


def test_10b_cross_package_training_from_one_seed(dirs):
    """With no checkpoint, `--seed` alone gives both packages' cli.train
    the same init (ops/prng.py draws the JAX package's weights), so their
    fresh runs end as close as runs from one checkpoint do."""
    root = dirs["root"]
    train_dirs = {}
    for pkg, binary in (("jax", jax_train), ("port", train)):
        train_dirs[pkg] = str(root / f"{pkg}_seeded_train") + "/"
        binary.main(TINY_FLAGS + SAME_BATCHES + [
            "--train_dir", train_dirs[pkg], "--seed", "3",
            "--start_new_model", "true",
            "--train_data_pattern", dirs["train_pattern"], "--num_epochs", "2"])
    jax_leaves = _leaves(latest_checkpoint(train_dirs["jax"]))
    port_leaves = _leaves(latest_checkpoint(train_dirs["port"]))
    assert jax_leaves.keys() == port_leaves.keys()
    assert int(port_leaves["global_step"]) == 12
    worst = max(float(np.abs(port_leaves[k] - want).max())
                for k, want in jax_leaves.items() if k.startswith("params_"))
    assert worst <= TRAIN_ATOL


def test_11_cross_package_eval(dirs, cross):
    """A JAX-trained, JAX-converted checkpoint evaluated by the port's
    cli.eval, and a port-trained, port-converted one by the JAX package's,
    give the other package's epoch Hit@1, PERR, GAP and mAP (ROADMAP item
    8's "done means")."""
    jax_convert.main(TINY_FLAGS + ["--train_dir", cross["jax"]])
    convert.main(TINY_FLAGS + ["--train_dir", cross["port"]])
    for train_dir in (cross["jax"], cross["port"]):
        finetune_dir = train_dir.replace("train", "") + "finetune/"
        argv = TINY_FLAGS + ["--train_dir", finetune_dir,
                             "--eval_data_pattern", dirs["eval_pattern"],
                             "--run_once", "true"]
        (want,) = _epoch_metrics(lambda: jax_eval.main(argv))
        (got,) = _epoch_metrics(lambda: eval_cli.main(argv))
        for key in EPOCH_KEYS:
            assert abs(got[key] - want[key]) <= EVAL_ATOL, (finetune_dir, key)
        np.testing.assert_allclose(got["aps"], want["aps"], atol=EVAL_ATOL)
        assert abs(got["avg_loss"] - want["avg_loss"]) <= LOSS_ATOL


def _scalars(logdir, tag):
    """{step: value} of the scalar summary `tag` in logdir's events files."""
    out = {}
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*"))):
        for record in TFRecordReader(path):
            fields = {f: v for f, _, v in iter_fields(record)}
            for _, _, sv in iter_fields(bytes(fields.get(5, b""))):
                value = {f: v for f, _, v in iter_fields(bytes(sv))}
                if bytes(value.get(1, b"")).decode() == tag:
                    out[fields.get(2, 0)] = float(np.frombuffer(bytes(value[2]), "<f4")[0])
    return out


# DBoF through both packages' cli.finetune --start_new_model from one seed:
# the inits agree to 3 ulp (normal draws), the frame samples and dropout
# keys bit for bit, so the losses of each step agree in f32 (4.1e-7
# relative measured) and the batch-norm moving statistics, which the
# forward computes, to 1e-6 (1.6e-7 measured; the trained weights differ
# by up to 1.3e-4, TF-Adam's sign of a near-zero gradient element).
DBOF_LOSS_RTOL, DBOF_STATS_ATOL = 1e-5, 1e-6


def test_12_dbof_finetune_across_packages(dirs, tmp_path):
    """Three steps of DBoF (batch norm on) in each package's cli.finetune;
    each package's student checkpoint restores into the other's template,
    moving statistics included."""
    argv = TINY_FLAGS + SAME_BATCHES + [
        "--model", "DbofModel", "--dbof_cluster_size", "16", "--dbof_hidden_size", "8",
        "--iterations", "5", "--seed", "2", "--start_new_model", "true",
        "--num_epochs", "1", "--save_summaries_secs", "0",
        "--train_data_pattern", dirs["train_pattern"]]
    train_dirs = {}
    for pkg, binary in (("jax", jax_finetune), ("port", finetune)):
        train_dirs[pkg] = str(tmp_path / pkg) + "/"
        binary.main(argv + ["--train_dir", train_dirs[pkg]])
    losses = {pkg: _scalars(d, "student_label_loss") for pkg, d in train_dirs.items()}
    assert sorted(losses["port"]) == sorted(losses["jax"]) == [1, 2]
    for step, want in losses["jax"].items():
        np.testing.assert_allclose(losses["port"][step], want, rtol=DBOF_LOSS_RTOL)
    ckpts = {pkg: latest_checkpoint(d) for pkg, d in train_dirs.items()}
    assert all(c.endswith("model.ckpt-3.msgpack") for c in ckpts.values())
    leaves = {pkg: _leaves(c) for pkg, c in ckpts.items()}
    for name in ("input_bn/moving_mean", "cluster_bn/moving_var", "hidden1_bn/moving_mean"):
        key = f"params_student/{name}"
        assert np.any(leaves["port"][key] != (1.0 if "var" in name else 0.0)), key
        np.testing.assert_allclose(leaves["port"][key], leaves["jax"][key],
                                   atol=DBOF_STATS_ATOL, err_msg=key)

    # the JAX checkpoint into the port's template, the port's into the JAX one's
    cfg = flags.config_from_args(flags.base_parser("").parse_args(argv))
    opt = make_optimizer(cfg.optimizer)
    student = init_model(cfg)
    template = StudentState(student=student, opt_student=opt.init(params_of(student)),
                            global_step=0, dropout_keep_prob=1.0)
    restored = _flat(state_tree(restore_checkpoint(ckpts["jax"], template)))
    for key, want in leaves["jax"].items():
        np.testing.assert_array_equal(np.asarray(restored[key], want.dtype), want,
                                      err_msg=key)
    jopt = jax_make_optimizer(cfg.optimizer)
    jtemplate = jax_student_state_from_distill(jax_init_distill_state(cfg, jopt), jopt)
    jrestored = jax_restore_checkpoint(ckpts["port"], jtemplate)
    for key, want in leaves["port"].items():
        node = jrestored
        for part in key.split("/"):
            node = getattr(node, part) if not isinstance(node, dict) else node[part]
        np.testing.assert_array_equal(np.asarray(node), want, err_msg=key)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor)
                                    else tree)}
