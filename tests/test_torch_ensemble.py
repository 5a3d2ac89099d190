"""The port's ensemble binaries (cli.train_ensemble, cli.inference_ensemble)
on the CPU, against the JAX package's (tests/test_ensemble.py): each of
the five ensemble heads trains over K prior-prediction CSVs and infers;
the two packages' trainers give the same head from one seed and one
batch order; a head file written by either package is read by the
other's cli.inference_ensemble into the same CSV rows.

The trainers run plain gradient descent here: TF-Adam's normalized step
turns the rounding of a gradient element that cancels to ~0 into a step
of either sign (a 512-unit hidden weight moved 3e-4 apart in 11 of 6144
elements after six steps), which says nothing of the binaries; the
optimizers' parity is tests/test_torch_optimizer.py's. Tolerances: head
parameters after two epochs within 1e-5 absolute (f32 sums in another
order, at learning rate 0.5; 4.8e-6 measured); CSV probabilities within 1e-6 (printed to 6 decimals), the same
classes."""

import csv
import os

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.cli import (
    inference_ensemble as jax_ie,
    train_ensemble as jax_te,
)
from efficientvideoclassification_youtube8m_torch.cli import inference_ensemble as ie_cli
from efficientvideoclassification_youtube8m_torch.cli import train_ensemble as te_cli
from efficientvideoclassification_youtube8m_torch.data import (
    write_synthetic_aggregated_shard,
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_torch.ensemble import (
    format_lines,
    read_pred_file,
    write_predictions_csv,
)
from efficientvideoclassification_youtube8m_torch.train import msgpack_io

torch.set_num_threads(1)

VOCAB = 30
PARAM_ATOL, CSV_ATOL = 1e-5, 1e-6
FLAGS = [
    "--num_classes", str(VOCAB), "--batch_size", "6", "--feature_names",
    "mean_rgb, mean_audio", "--feature_sizes", "8, 4", "--num_epochs", "2",
    "--compute_dtype", "float32", "--top_k", "5", "--frame_features", "false",
    "--num_readers", "1", "--base_learning_rate", "0.5",
    "--optimizer", "GradientDescentOptimizer",
]
HEADS = ["LinearRegressionEnsemble", "SingleHiddenLayerEnsemble",
         "LinearRegressionWeightedMeanEnsemble",
         "LinearRegressionWeightedMeanEnsembleDifferenceLoss",
         "IndependentClassEnsemble"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """An aggregated shard of 15 videos (a padded final batch at 6) and
    three prediction CSVs over the same ids."""
    root = tmp_path_factory.mktemp("ensemble")
    truth = write_synthetic_aggregated_shard(
        str(root / "agg-0000.tfrecord"), num_videos=15, seed=5,
        feature_names=("mean_rgb", "mean_audio"), feature_sizes=(8, 4),
        vocab_size=VOCAB)
    ids = [t.video_id for t in truth]
    rng = np.random.default_rng(4)
    for k in range(3):
        preds = rng.uniform(size=(len(ids), VOCAB))
        write_predictions_csv(str(root / f"preds_{k}.csv"), format_lines(ids, preds, 12))
    return {"root": root, "ids": ids,
            "agg": str(root / "agg-*.tfrecord"), "preds": str(root / "preds_*.csv")}


def _train(binary, data, head, path, extra=()):
    argv = FLAGS + list(extra) + ["--model", head, "--train_data_pattern", data["agg"],
                                  "--preds_pattern", data["preds"],
                                  "--head_checkpoint", path]
    return binary.main(argv + (["--device", "cpu"] if binary is te_cli else []))


def _infer(binary, data, path, out, extra=(), pattern=None):
    argv = FLAGS + list(extra) + ["--input_data_pattern", pattern or data["agg"],
                                  "--preds_pattern", data["preds"],
                                  "--head_checkpoint", path, "--output_file", out]
    binary.main(argv + (["--device", "cpu"] if binary is ie_cli else []))
    return read_pred_file(out)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _same_rows(got, want):
    assert sorted(got) == sorted(want)
    for vid, (labels, probs) in want.items():
        g_labels, g_probs = got[vid]
        assert g_labels == labels, vid
        np.testing.assert_allclose(g_probs, probs, atol=CSV_ATOL, err_msg=vid)


@pytest.mark.parametrize("head", HEADS)
def test_train_and_infer_ensemble_head_across_packages(data, head, tmp_path):
    """Both trainers from one seed over one batch order: the same head;
    each head file through both packages' inference: the same rows.
    Heads without labels at inference (the DifferenceLoss head's margin
    loss needs them) still predict."""
    files = {name: str(tmp_path / f"{name}.msgpack") for name in ("port", "jax")}
    _train(te_cli, data, head, files["port"])
    _train(jax_te, data, head, files["jax"])
    port, other = (msgpack_io.load(files[n]) for n in ("port", "jax"))
    for key in ("model", "input_size", "num_models"):
        assert port[key] == other[key], key
    assert (port["model"], port["input_size"], port["num_models"]) == (head, 12, 3)
    want = _leaves(other["params"])
    got = _leaves(port["params"])
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, atol=PARAM_ATOL, err_msg=name)
    for source in ("port", "jax"):
        rows = {binary: _infer(binary, data, files[source],
                               str(tmp_path / f"{source}_{binary.__name__}.csv"))
                for binary in (ie_cli, jax_ie)}
        _same_rows(rows[ie_cli], rows[jax_ie])
        assert len(rows[ie_cli]) == len(data["ids"])
        for labels, probs in rows[ie_cli].values():
            assert len(labels) == 5 and all(0.0 <= p <= 1.0 for p in probs)


def test_inference_ensemble_over_frame_shards(data, tmp_path):
    """Frame-level shards: the head reads the mean of the true frames
    (uint8 dequantized and l2-normalized), as in the JAX binary."""
    frame_shard = str(tmp_path / "frames-0000.tfrecord")
    truth = write_synthetic_frame_shard(frame_shard, num_videos=7, seed=2,
                                        feature_sizes=(8, 4), max_frames=20,
                                        vocab_size=VOCAB)
    root = tmp_path / "frame_preds"
    root.mkdir()
    rng = np.random.default_rng(8)
    ids = [t.video_id for t in truth]
    for k in range(3):
        write_predictions_csv(str(root / f"p_{k}.csv"),
                              format_lines(ids, rng.uniform(size=(7, VOCAB)), 10))
    frame_data = dict(data, preds=str(root / "p_*.csv"))
    head = str(tmp_path / "head.msgpack")
    _train(te_cli, data, "SingleHiddenLayerEnsemble", head)
    flags = ["--frame_features", "true", "--feature_names", "rgb, audio",
             "--max_num_frames", "20"]
    got = _infer(ie_cli, frame_data, head, str(tmp_path / "p.csv"), flags, frame_shard)
    want = _infer(jax_ie, frame_data, head, str(tmp_path / "j.csv"), flags, frame_shard)
    _same_rows(got, want)


def test_ensemble_binaries_refuse_what_jax_refuses(data, tmp_path):
    with pytest.raises(ValueError, match="not an ensemble head"):
        _train(te_cli, data, "MoeModel", str(tmp_path / "x.msgpack"))
    head = str(tmp_path / "h.msgpack")
    _train(te_cli, data, "LinearRegressionEnsemble", head)
    with pytest.raises(ValueError, match="input_size 12"):
        _infer(ie_cli, data, head, str(tmp_path / "o.csv"), ["--feature_sizes", "8, 5"])
    two = str(data["root"] / "preds_[01].csv")
    with pytest.raises(ValueError, match="over 3 prediction files"):
        _infer(ie_cli, dict(data, preds=two), head, str(tmp_path / "o.csv"))
    missing = tmp_path / "short"
    missing.mkdir()
    for k in range(3):
        lines = open(str(data["root"] / f"preds_{k}.csv")).read().splitlines()
        (missing / f"p_{k}.csv").write_text("\n".join(lines[:-1 if k == 1 else None]) + "\n")
    with pytest.raises(KeyError, match="p_1.csv"):
        _infer(ie_cli, dict(data, preds=str(missing / "p_*.csv")), head,
               str(tmp_path / "o.csv"))
    assert not os.path.exists(str(tmp_path / "x.msgpack"))
    with open(str(tmp_path / "o.csv")) as f:
        assert next(csv.reader(f)) == ["VideoId", "LabelConfidencePairs"]
