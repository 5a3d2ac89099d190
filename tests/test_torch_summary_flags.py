"""The port's copies of the events-file writer, the flag parser and the
config against the JAX package's: the same summaries write the same
records, the reference flag sets parse to equal namespaces and configs,
and both TrainConfigs have the same fields and defaults."""

import dataclasses
import time

import numpy as np
import pytest

from efficientvideoclassification_youtube8m_tpu.cli import flags as jflags
from efficientvideoclassification_youtube8m_tpu.data.tfrecord import TFRecordReader
from efficientvideoclassification_youtube8m_tpu.utils import config as jconfig
from efficientvideoclassification_youtube8m_tpu.utils import summary as jsummary
from efficientvideoclassification_youtube8m_torch.cli import flags as tflags
from efficientvideoclassification_youtube8m_torch.utils import config as tconfig
from efficientvideoclassification_youtube8m_torch.utils import summary as tsummary

EPOCH = {"epoch_id": 7, "avg_hit_at_one": 0.5, "avg_perr": 0.25,
         "avg_loss": 3.5, "aps": [0.1, 0.2, 0.7], "gap": 0.625}
STEP = {"hit_at_one": 0.75, "perr": 0.5, "loss": 1.25, "examples_per_second": 812.5}


def _write(module, logdir):
    """A fixed set of summaries through one package's writer; returns the
    log lines of the two helpers."""
    w = module.SummaryWriter(str(logdir))
    w.scalar("model/Training_GAP", 0.875, 3)
    w.histogram("model/rnn_l1/0/kernel", np.linspace(-2, 2, 101), 3)
    w.add_summary(module.make_histogram_from_stats(
        "model/x", 4.0, -1.0, 2.0, 1.5, 6.0, np.arange(len(module._BUCKET_LIMITS)) % 3), 4)
    lines = (module.add_global_step_summary(w, 5, STEP, "Eval"),
             module.add_epoch_summary(w, 5, EPOCH, "Eval"))
    module.NullSummaryWriter().scalar("ignored", 1.0, 1)
    w.close()
    return lines


def test_events_files_identical(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234567890.5)
    jax_lines = _write(jsummary, tmp_path / "jax")
    port_lines = _write(tsummary, tmp_path / "port")
    assert port_lines == jax_lines
    (jfile,) = (tmp_path / "jax").iterdir()
    (tfile,) = (tmp_path / "port").iterdir()
    assert tfile.name == jfile.name
    records = list(TFRecordReader(str(tfile), verify_crc=True))
    assert len(records) == 13  # version, scalar, 2 histograms, 4 + 5 scalars
    assert records == list(TFRecordReader(str(jfile), verify_crc=True))


def test_bucket_limits_and_histograms_identical():
    np.testing.assert_array_equal(tsummary._BUCKET_LIMITS, jsummary._BUCKET_LIMITS)
    values = np.concatenate([np.random.default_rng(0).normal(size=500), [np.inf, np.nan]])
    assert tsummary.make_histogram("h", values) == jsummary.make_histogram("h", values)
    assert tsummary.make_summary("s", 0.1) == jsummary.make_summary("s", 0.1)


REFERENCE_FLAGS = [
    [],
    # run_train.sh's distillation flags
    ["--train_dir", "./model_train/", "--train_data_pattern", "train*.tfrecord",
     "--frame_features", "True", "--model", "HierarchicalLstmModel",
     "--feature_names", "rgb, audio", "--feature_sizes", "1024, 128",
     "--batch_size", "256", "--base_learning_rate", "0.001", "--every_n", "10",
     "--lstm_cells", "1024", "--num_epochs", "5", "--start_new_model"],
    # eval / inference style flags, with the parser's quirks
    ["--eval_data_pattern", "validate*", "--run_once", "--top_k", "20",
     "--device", "/gpu:1", "--gpu", "1", "--a_rate", "3", "--compute_dtype",
     "float32", "--use_native_io", "false", "--fetch_depth", "2",
     "--checkpoint_format", "orbax", "--num_readers", "1",
     "--deterministic_input", "yes", "--dropout", "0.5"],
]


@pytest.mark.parametrize("argv", REFERENCE_FLAGS, ids=["defaults", "train", "eval"])
def test_parser_and_config_identical(argv):
    jargs = jflags.base_parser("x").parse_args(argv)
    targs = tflags.base_parser("x").parse_args(argv)
    assert vars(targs) == vars(jargs)
    assert (dataclasses.asdict(tflags.config_from_args(targs))
            == dataclasses.asdict(jflags.config_from_args(jargs)))
    assert isinstance(tflags.config_from_args(targs), tconfig.TrainConfig)


def test_train_configs_identical():
    jfields = {f.name: (f.type, f.default) for f in dataclasses.fields(jconfig.TrainConfig)}
    tfields = {f.name: (f.type, f.default) for f in dataclasses.fields(tconfig.TrainConfig)}
    assert tfields == jfields
    cfg, jcfg = tconfig.TrainConfig(), jconfig.TrainConfig()
    for prop in ("feature_names_list", "feature_sizes_list", "total_feature_size",
                 "max_frames_student"):
        assert getattr(cfg, prop) == getattr(jcfg, prop)
    assert (dataclasses.asdict(cfg.replace(lstm_cells=7))
            == dataclasses.asdict(jcfg.replace(lstm_cells=7)))
    assert (tconfig.parse_feature_csv("a, b", "1,2")
            == jconfig.parse_feature_csv("a, b", "1,2"))
    with pytest.raises(ValueError):
        tconfig.parse_feature_csv("a, b", "1")


def test_dump_flags_identical(caplog):
    args = tflags.base_parser("x").parse_args(REFERENCE_FLAGS[1])
    with caplog.at_level("INFO"):
        tflags.dump_flags(args)
        port = [r.getMessage() for r in caplog.records]
        caplog.clear()
        jflags.dump_flags(args)
        jax = [r.getMessage() for r in caplog.records]
    assert port == jax and len(port) == len(vars(args))
