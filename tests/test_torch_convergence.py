"""Both packages' bf16 distillation from one seed over hundreds of steps,
on the CPU at a reduced width: the gate's recipe (learnable shards with
vocab 256, 20 chunks, every_n 10, deterministic input, bf16) at lstm_cells
64, feature sizes 48 + 16 and batch 32, 12 epochs of 512 videos (384
global steps). With the JAX package's init (ops/prng.py) and batch
order, the port's cli.train follows the JAX package's through the GAP~0
plateau and out of it: the losses agree closely while the runs are on
the plateau, and both leave it by the end. The hand-written kernels are
the card's; here both packages run their plain bf16 scans."""

import logging
import re

import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.cli import train as jax_train
from efficientvideoclassification_youtube8m_tpu.data.yt8m import write_learnable_frame_shard
from efficientvideoclassification_youtube8m_torch.cli import train

FLAGS = [
    "--feature_names", "rgb, audio", "--feature_sizes", "48, 16",
    "--num_classes", "256", "--batch_size", "32", "--num_inputs_to_lstm", "20",
    "--lstm_cells", "64", "--lstm_layers", "2", "--every_n", "10",
    "--num_readers", "2", "--deterministic_input", "true",
    "--compute_dtype", "bfloat16", "--scan_unroll", "1",
    "--save_model_secs", "100000", "--save_summaries_secs", "100000",
    "--device", "cpu", "--num_epochs", "12", "--start_new_model", "true",
]
_STEP = re.compile(r"training step (\d+)\| Hit@1: ([\d.]+)\| PERR: ([\d.]+)\| "
                   r"GAP: ([\d.]+)\| Teacher_Loss: ([\d.eE+-]+)\| L_REP: "
                   r"([\d.eE+-]+)\| L_PRED: ([\d.eE+-]+)\| L_CE: ([\d.eE+-]+)")
# Teacher_Loss and L_CE of the two packages, f32 sums in another order
# over bf16 products, drift apart as the steps compound: up to 0.9% by
# step 120 (measured); 2% is the bound while both are on the plateau.
PLATEAU_STEPS = 120
PLATEAU_RTOL = 0.02
# by step 384 both runs have left the plateau (train GAP 0.27 and 0.26
# measured), though no longer in step with each other
ESCAPED_GAP = 0.15


class _Steps(logging.Handler):
    def __init__(self):
        super().__init__()
        self.rows = {}

    def emit(self, record):
        m = _STEP.search(record.getMessage())
        if m:
            self.rows[int(m.group(1))] = [float(x) for x in m.groups()[1:]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("convergence")
    for s in range(4):
        write_learnable_frame_shard(str(root / f"train-{s:04d}.tfrecord"), 128,
                                    seed=s, vocab_size=256, feature_sizes=(48, 16))
    out = {}
    logger = logging.getLogger("train")
    level, threads = logger.level, torch.get_num_threads()
    logger.setLevel(logging.INFO)
    torch.set_num_threads(2)  # the measured runs' count
    for pkg, binary in (("jax", jax_train), ("port", train)):
        capture = _Steps()
        logger.addHandler(capture)
        try:
            binary.main(FLAGS + ["--train_dir", str(root / pkg) + "/",
                                 "--train_data_pattern", str(root / "train-*")])
        finally:
            logger.removeHandler(capture)
        out[pkg] = capture.rows
    logger.setLevel(level)
    torch.set_num_threads(threads)
    return out


def test_bf16_training_follows_jax_on_the_plateau(runs):
    assert sorted(runs["port"]) == sorted(runs["jax"])
    assert max(runs["port"]) == 384
    for step in (s for s in sorted(runs["jax"]) if s <= PLATEAU_STEPS):
        want, got = runs["jax"][step], runs["port"][step]
        for col in (3, 6):  # Teacher_Loss, L_CE
            assert got[col] == pytest.approx(want[col], rel=PLATEAU_RTOL), (step, col)


def test_bf16_training_leaves_the_plateau_in_both_packages(runs):
    for pkg in ("jax", "port"):
        assert runs[pkg][384][2] >= ESCAPED_GAP, pkg
