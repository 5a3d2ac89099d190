"""The port's Kaggle-CSV inference and its tools against the JAX
package's binaries on the CPU, at tiny flags: cli.infer (f32, bf16 and
int8) and cli.inference_bias on one JAX-written checkpoint and one set of
shards, rescale_bias_param bit for bit, cli.max_ensemble and
cli.hash_check file for file, cli.inspect_checkpoint name for name."""

import glob
import json
import os

import jax
import numpy as np
import pytest

from efficientvideoclassification_youtube8m_tpu.cli import hash_check as jax_hash_check
from efficientvideoclassification_youtube8m_tpu.cli import infer as jax_infer
from efficientvideoclassification_youtube8m_tpu.cli import (
    inference_bias as jax_inference_bias,
)
from efficientvideoclassification_youtube8m_tpu.cli import (
    inspect_checkpoint as jax_inspect,
)
from efficientvideoclassification_youtube8m_tpu.cli import max_ensemble as jax_max_ensemble
from efficientvideoclassification_youtube8m_tpu.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_tpu.data.tf_checkpoint import write_tf_checkpoint
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state as jax_init_distill_state,
    make_optimizer as jax_make_optimizer,
    save_checkpoint as jax_save_checkpoint,
    student_state_from_distill as jax_student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.cli import flags
from efficientvideoclassification_youtube8m_torch.cli import hash_check, infer
from efficientvideoclassification_youtube8m_torch.cli import inference_bias
from efficientvideoclassification_youtube8m_torch.cli import inspect_checkpoint
from efficientvideoclassification_youtube8m_torch.cli import max_ensemble
from efficientvideoclassification_youtube8m_torch.ensemble import read_pred_file
from efficientvideoclassification_youtube8m_torch.train.state import init_model
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params

TINY_FLAGS = [
    "--num_classes", "40", "--batch_size", "8", "--lstm_cells", "8",
    "--lstm_layers", "2", "--max_num_frames", "40",
    "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2", "--every_n", "2",
    "--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
    "--num_readers", "2", "--deterministic_input", "true", "--top_k", "5",
    "--scan_unroll", "1", "--device", "cpu",
]
# The CSV bar of chip_smoke.py phase 9: probabilities within 1e-5 (the
# forwards differ by summation order only; the CSV prints 6 decimals), the
# same class wherever neighbouring probabilities are more than 1e-5 apart.
TOL_CSV = 1e-5
DTYPES = {"f32": "float32", "bf16": "bfloat16"}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A JAX finetune-style checkpoint (the student, its biases made
    non-zero) and 13 test videos: a full batch of 8 and a padded one."""
    root = tmp_path_factory.mktemp("infer")
    write_synthetic_frame_shard(str(root / "test-0000.tfrecord"), 13, seed=3,
                                feature_sizes=(6, 2), max_frames=40, vocab_size=40)
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    opt = jax_make_optimizer(cfg.optimizer)
    state = jax_student_state_from_distill(jax_init_distill_state(cfg, opt), opt)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(scale=0.3, size=x.shape).astype(np.float32),
        state.params_student)
    train_dir = str(root / "model_finetune") + "/"
    state = state.replace(params_student=params)
    jax_save_checkpoint(train_dir, state, 7)
    return {"root": root, "train_dir": train_dir, "params": params, "state": state,
            "pattern": str(root / "test-*.tfrecord")}


def _rows(path):
    with open(path) as f:
        header, *lines = f.read().splitlines()
    assert header == "VideoId,LabelConfidencePairs"
    out = []
    for line in lines:
        vid, pairs = line.split(",", 1)
        tokens = pairs.split(" ")
        out.append((vid, [int(t) for t in tokens[0::2]],
                    np.array([float(t) for t in tokens[1::2]])))
    return out


def _assert_rows_agree(got_path, want_path, tol):
    got, want = _rows(got_path), _rows(want_path)
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) == 13
    for (vid, gc, gp), (_, wc, wp) in zip(got, want):
        assert len(gc) == len(wc) == 5
        np.testing.assert_allclose(gp, wp, atol=tol, err_msg=vid)
        for r in range(5):
            apart = [abs(wp[r] - wp[q]) for q in (r - 1, r + 1) if 0 <= q < 5]
            if min(apart) > tol:
                assert gc[r] == wc[r], (vid, r)


def _run(binary, dirs, out, *extra, dtype="float32"):
    binary.main(TINY_FLAGS + [
        "--compute_dtype", dtype, "--train_dir", dirs["train_dir"],
        "--input_data_pattern", dirs["pattern"], "--output_file", out, *extra])


@pytest.fixture(scope="module")
def csvs(dirs):
    """Each package's cli.infer CSV, by (package, dtype, quantize)."""
    out = {}
    for dtype in DTYPES:
        for quant in ("none", "int8"):
            for pkg, binary in (("jax", jax_infer), ("port", infer)):
                path = str(dirs["root"] / f"{pkg}_{dtype}_{quant}.csv")
                _run(binary, dirs, path, "--quantize", quant, dtype=DTYPES[dtype])
                out[pkg, dtype, quant] = path
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_infer_csv_agrees_with_jax(csvs, dtype, quant):
    _assert_rows_agree(csvs["port", dtype, quant], csvs["jax", dtype, quant], TOL_CSV)


@pytest.mark.parametrize("path,alpha", [
    ("classifier/experts/b", 2.0), ("classifier/experts/b", 0.3),
    ("rnn_l1/0/bias", 2.0), ("classifier/gates/w", 5.0)])
def test_rescale_bias_param_bit_identical(dirs, path, alpha):
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    tree = jax.tree.map(np.array, dirs["params"])
    model = load_jax_params(init_model(cfg), tree)
    infer.rescale_bias_param(model, path, alpha)
    want = jax_infer.rescale_bias_param(tree, path, alpha)
    got = model.state_dict()[path.replace("/", ".")].numpy()
    node = want
    for key in path.split("/"):
        node = node[int(key)] if isinstance(node, list) else node[key]
    want_leaf = np.asarray(node)
    assert got.dtype == want_leaf.dtype
    assert got.tobytes() == want_leaf.tobytes()
    assert not np.array_equal(got, np.asarray(_leaf(dirs["params"], path)))


def _leaf(tree, path):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def test_rescale_bias_param_unknown_name(dirs):
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    with pytest.raises(KeyError, match="classifier/experts/c"):
        infer.rescale_bias_param(init_model(cfg), "classifier/experts/c", 2.0)


def test_inference_bias_agrees_with_jax(dirs):
    paths = {}
    for pkg, binary in (("jax", jax_inference_bias), ("port", inference_bias)):
        paths[pkg] = str(dirs["root"] / f"{pkg}_bias.csv")
        _run(binary, dirs, paths[pkg], "--tensor_name", "classifier/experts/b",
             "--alpha_bias", "3")
    _assert_rows_agree(paths["port"], paths["jax"], TOL_CSV)
    plain = str(dirs["root"] / "port_plain.csv")
    _run(infer, dirs, plain)
    assert open(plain).read() != open(paths["port"]).read()  # the bias moved


def test_max_ensemble_identical(dirs, csvs):
    outs = {}
    pattern = str(dirs["root"] / "jax_*.csv")
    for pkg, binary in (("jax", jax_max_ensemble), ("port", max_ensemble)):
        outs[pkg] = str(dirs["root"] / f"ensemble_{pkg}.txt")
        binary.main(["--preds_pattern", pattern, "--output_file", outs[pkg],
                     "--num_classes", "40", "--top_k", "5"])
    assert open(outs["port"], "rb").read() == open(outs["jax"], "rb").read()
    merged = read_pred_file(outs["port"])
    inputs = [read_pred_file(p) for p in sorted(glob.glob(pattern))]
    assert len(merged) == 13
    for vid, (labels, probs) in merged.items():
        for c, p in zip(labels, probs):
            assert p == max(dict(zip(*d[vid])).get(c, 0.0) for d in inputs)


def test_max_ensemble_refuses_other_videos(csvs, tmp_path):
    """A truncated CSV beside a whole one: both packages refuse."""
    lines = open(csvs["jax", "f32", "none"]).read().splitlines(keepends=True)
    (tmp_path / "full.csv").write_text("".join(lines))
    (tmp_path / "short.csv").write_text("".join(lines[:-1]))
    for binary in (jax_max_ensemble, max_ensemble):
        with pytest.raises(ValueError, match="video universe"):
            binary.main(["--preds_pattern", str(tmp_path / "*.csv"), "--output_file",
                         str(tmp_path / "merged.txt"), "--num_classes", "40"])


@pytest.mark.parametrize("base", ["", "https://example.invalid/yt8m"])
def test_hash_check_identical(dirs, tmp_path, capsys, base):
    shard = dirs["pattern"].replace("*", "0000")
    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({
        os.path.basename(shard): jax_hash_check.md5_of(shard),
        "gone.tfrecord": "0" * 32,
        "test-0000.tfrecord.bad": "1" * 32}))
    (tmp_path / "test-0000.tfrecord.bad").write_bytes(b"x")
    results = []
    for binary, data_dir in ((jax_hash_check, os.path.dirname(shard)),
                             (hash_check, os.path.dirname(shard))):
        argv = ["--manifest", str(manifest), "--data_dir", data_dir]
        code = binary.main(argv + (["--redownload_base", base] if base else []))
        results.append((code, capsys.readouterr().out))
    assert results[0] == results[1]
    assert results[1][0] == 1 and "1/3 shards OK" in results[1][1]
    assert hash_check.md5_of(shard) == jax_hash_check.md5_of(shard)


def _listing(binary, argv, capsys):
    binary.main(argv)
    lines = capsys.readouterr().out.splitlines()
    return [line.split("  dtype:")[0] for line in lines if line.startswith("tensor_name:")]


def test_inspect_checkpoint_lists_the_same(dirs, tmp_path, capsys):
    (ckpt,) = glob.glob(os.path.join(dirs["train_dir"], "model.ckpt-*.msgpack"))
    want = _listing(jax_inspect, ["--file_name", ckpt], capsys)
    got = _listing(inspect_checkpoint, ["--file_name", ckpt], capsys)
    # params, mu and nu of 11 tensors each; count, global_step, dropout
    assert got == want and len(got) == 3 * 11 + 3
    one = ["--file_name", ckpt, "--tensor_name", "params_student/rnn_l2/1/kernel"]
    inspect_checkpoint.main(one)
    port_out = capsys.readouterr().out
    jax_inspect.main(one)
    assert port_out == capsys.readouterr().out
    prefix = write_tf_checkpoint(str(tmp_path / "model.ckpt-5"), {
        "model/a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "global_step": np.array(5, np.int64)})
    for argv in (["--file_name", prefix], ["--file_name", prefix + ".index", "--all_tensors"]):
        inspect_checkpoint.main(argv)
        port_out = capsys.readouterr().out
        jax_inspect.main(argv)
        assert port_out == capsys.readouterr().out
    # an orbax directory the JAX package wrote: the same lines, values too
    odir = jax_save_checkpoint(str(tmp_path / "orbax"), dirs["state"], 7,
                               backend="orbax")
    for argv in (["--file_name", odir],
                 ["--file_name", odir, "--tensor_name", "rnn_l1/0/bias"]):
        inspect_checkpoint.main(argv)
        port_out = capsys.readouterr().out
        jax_inspect.main(argv)
        assert port_out == capsys.readouterr().out and "rnn_l1/0/bias" in port_out


def test_infer_options(dirs, tmp_path):
    out = str(tmp_path / "x.csv")
    # K = 3: 13 videos are a stack of one full and one padded batch; the
    # rows from the device top-k, as the JAX binary's at K = 3
    _run(infer, dirs, out, "--steps_per_dispatch", "3")
    _run(jax_infer, dirs, str(tmp_path / "jax.csv"), "--steps_per_dispatch", "3")
    _assert_rows_agree(out, str(tmp_path / "jax.csv"), TOL_CSV)
    # the aggregated branch takes video-level models (tests/test_torch_aggregated.py)
    with pytest.raises(ValueError, match="frame-level model"):
        _run(infer, dirs, out, "--frame_features", "false")
    with pytest.raises(ValueError, match="frame-level student path"):
        _run(infer, dirs, out, "--frame_features", "false", "--quantize", "int8")
    with pytest.raises(IOError, match="unable to find a checkpoint"):
        infer.main(TINY_FLAGS + ["--train_dir", str(tmp_path / "none"),
                                 "--input_data_pattern", dirs["pattern"],
                                 "--output_file", out])
    for k in ("0", "-2"):  # read as 1
        _run(infer, dirs, out, "--steps_per_dispatch", k)
        assert len(_rows(out)) == 13
