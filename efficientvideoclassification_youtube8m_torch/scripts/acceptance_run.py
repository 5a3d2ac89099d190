"""The convergence gate of the port (port of the JAX package's
scripts/acceptance_run.py).

    python -m efficientvideoclassification_youtube8m_torch.scripts.acceptance_run \
        [--workdir DIR] [--device cpu] [--extra_flags "--seed 1"]

Recipe, the JAX script's: learnable synthetic shards (a label -> byte
pattern mapping, `data.yt8m.write_learnable_frame_shard`) with vocab 256,
2048 train and 512 held-out videos; the flagship (HierarchicalLstm 2x1024,
300 frames, 20 chunks, every_n 10) in bf16, 30 epochs at batch 128 (16
batches an epoch, 960 faithful global steps) through the port's
cli.train; then held-out STUDENT validation through the port's
cli.validate, whose epoch is read through `EvaluationMetrics.get`.

Bands (asserted at this recipe only; a miss exits 1):
  * train GAP >= 0.995 by step <= 700
  * held-out student Hit@1 >= 0.95 and GAP >= 0.74

The per-step loss trajectory's sha1 and the first converged step are
printed, not asserted: the JAX package's TPU record (sha1 e3c3f539...,
step 338) is not a target for a GPU, which does not replay a TPU's
rounding.

The flags are the JAX script's, seed 0 included, and so is the init:
the port draws the JAX package's weights for a seed (ops/prng.py), and
its loader gives the JAX package's batch order, so this is the JAX
record's run on another chip. On the H100 (PERF.md, section 6) seed 0
first reached the band at step 368 on the train kernels and at step 338
on the plain scan (`--lstm_pallas_train false`), where the JAX TPU
records read 338 and 352; seeds 1-3 reached it at steps 330, 290 and
332. The run is deterministic on the card: the same seed gives the same
trajectory digest.

Any change to the train step's math (the precision of the residual or
cotangent streams, kernel fusion, optimizer math, loss terms) must pass
these bands on the card before it becomes a default: on the TPU a
bf16-residual kernel measured 38% faster but stalled at train GAP 0.06
(the JAX script's docstring).

`run` does the work at any dimensions, so that a CPU test can drive the
plumbing at tiny ones; `main` runs the recipe.
"""

from __future__ import annotations

import argparse
import hashlib
import logging
import os
import re
import shlex
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from efficientvideoclassification_youtube8m_torch.cli import train as train_cli
from efficientvideoclassification_youtube8m_torch.cli import validate as validate_cli
from efficientvideoclassification_youtube8m_torch.data.yt8m import (
    write_learnable_frame_shard,
)
from efficientvideoclassification_youtube8m_torch.metrics import eval_util

_STEP_RE = re.compile(
    r"training step (\d+)\| Hit@1: ([\d.]+)\| PERR: ([\d.]+)\| GAP: ([\d.]+)"
)
_LOSS_RE = re.compile(
    r"training step (\d+)\|.*Teacher_Loss: ([\d.eE+-]+)\| "
    r"L_REP: ([\d.eE+-]+)\| L_PRED: ([\d.eE+-]+)\| L_CE: ([\d.eE+-]+)"
)

VOCAB = 256
TRAIN_VIDEOS = 2048
HELDOUT_VIDEOS = 512
PER_SHARD = 512
NUM_EPOCHS = 30
CONVERGED_GAP = 0.995
CONVERGED_BY_STEP = 700
MIN_HELDOUT_HIT = 0.95
MIN_HELDOUT_GAP = 0.74

# the JAX script's flags (:153-168); --scan_unroll is accepted for parity
FLAGSHIP_FLAGS = [
    "--feature_names", "rgb, audio",
    "--feature_sizes", "1024, 128",
    "--model", "HierarchicalLstmModel",
    "--num_classes", str(VOCAB),
    "--batch_size", "128",
    "--num_inputs_to_lstm", "20",
    "--lstm_cells", "1024",
    "--lstm_layers", "2",
    "--every_n", "10",
    "--num_readers", "4",
    "--deterministic_input", "true",
    "--compute_dtype", "bfloat16",
    "--scan_unroll", "15",
    "--save_model_secs", "100000",  # one final checkpoint
]


class GapCapture(logging.Handler):
    """The train logger's per-step lines: the first step whose train GAP
    reaches the band, the last logged (step, GAP), and the loss columns
    of every step for the trajectory digest."""

    def __init__(self):
        super().__init__()
        self.first_converged_step: Optional[int] = None
        self.last = None
        self.steps: List[int] = []
        self.loss_lines: List[str] = []  # per-step "step,tl,lrep,lpred,lce"

    def emit(self, record):
        msg = record.getMessage()
        m = _STEP_RE.search(msg)
        if m:
            step, gap = int(m.group(1)), float(m.group(4))
            self.steps.append(step)
            self.last = (step, gap)
            if gap >= CONVERGED_GAP and self.first_converged_step is None:
                self.first_converged_step = step
        ml = _LOSS_RE.search(msg)
        if ml:
            self.loss_lines.append(",".join(ml.groups()))

    def trajectory_sha1(self) -> str:
        return hashlib.sha1("\n".join(self.loss_lines).encode()).hexdigest()


def write_shards(data_dir: str, train_videos: int = TRAIN_VIDEOS,
                 heldout_videos: int = HELDOUT_VIDEOS,
                 per_shard: int = PER_SHARD, vocab: int = VOCAB,
                 **shard_kwargs) -> None:
    """The learnable shards of the recipe (seeds 0.. for train, 9 for the
    held-out split), kept when they are all there already."""
    os.makedirs(data_dir, exist_ok=True)
    shards = [(os.path.join(data_dir, f"train-{s:04d}.tfrecord"), per_shard, s)
              for s in range(train_videos // per_shard)]
    shards.append((os.path.join(data_dir, "validate-0000.tfrecord"),
                   heldout_videos, 9))
    if all(os.path.exists(path) for path, _, _ in shards):
        print(f"reusing existing shards under {data_dir}")
        return
    print(f"writing learnable synthetic shards under {data_dir} ...")
    for path, videos, seed in shards:
        write_learnable_frame_shard(path, num_videos=videos, seed=seed,
                                    vocab_size=vocab, **shard_kwargs)


def run(workdir: str, flags: Sequence[str] = tuple(FLAGSHIP_FLAGS),
        num_epochs: int = NUM_EPOCHS, device: str = "/gpu:0",
        train_videos: int = TRAIN_VIDEOS, heldout_videos: int = HELDOUT_VIDEOS,
        per_shard: int = PER_SHARD, vocab: int = VOCAB,
        shard_kwargs: Optional[Dict] = None) -> Dict:
    """Write (or reuse) the shards under `workdir`, train through the
    port's cli.train and validate the student on the held-out split
    through cli.validate. Returns the first converged step, the last
    logged (step, GAP), the logged steps, the trajectory's sha1 and step
    count, the held-out epoch (`EvaluationMetrics.get`'s dict) and the
    seconds of each stage. Asserts nothing."""
    data_dir = os.path.join(workdir, "yt8m")
    t0 = time.perf_counter()
    write_shards(data_dir, train_videos, heldout_videos, per_shard, vocab,
                 **(shard_kwargs or {}))
    seconds = {"shards": time.perf_counter() - t0}
    train_dir = os.path.join(workdir, "model_train") + "/"
    if os.path.isdir(train_dir):  # stale checkpoints would confuse validate
        shutil.rmtree(train_dir)
    flags = list(flags) + ["--device", device]

    print("=== train (teacher+student) ===")
    capture = GapCapture()
    train_logger = logging.getLogger("train")
    # the per-step lines are INFO records, whatever the caller's logging
    level = train_logger.level
    train_logger.setLevel(logging.INFO)
    train_logger.addHandler(capture)
    t0 = time.perf_counter()
    try:
        train_cli.main(flags + [
            "--train_dir", train_dir,
            "--train_data_pattern", os.path.join(data_dir, "train-*.tfrecord"),
            "--num_epochs", str(num_epochs),
            "--start_new_model", "true",
        ])
    finally:
        train_logger.removeHandler(capture)
        train_logger.setLevel(level)
    seconds["train"] = time.perf_counter() - t0

    print("=== held-out student validation ===")
    epoch: Dict = {}
    orig_get = eval_util.EvaluationMetrics.get

    def capture_get(self):
        data = orig_get(self)
        epoch.update(data)
        return data

    eval_util.EvaluationMetrics.get = capture_get
    t0 = time.perf_counter()
    try:
        validate_cli.main(flags + [
            "--train_dir", train_dir,
            "--eval_data_pattern", os.path.join(data_dir, "validate-*.tfrecord"),
            "--run_once", "true",
        ])
    finally:
        eval_util.EvaluationMetrics.get = orig_get
    seconds["validate"] = time.perf_counter() - t0
    aps = epoch.get("aps") or []
    return {
        "first_converged_step": capture.first_converged_step,
        "last": capture.last,
        "steps": capture.steps,
        "trajectory_sha1": capture.trajectory_sha1(),
        "trajectory_steps": len(capture.loss_lines),
        "epoch": epoch,
        "map": sum(aps) / len(aps) if aps else 0.0,
        "seconds": seconds,
    }


def report(result: Dict) -> None:
    epoch = result["epoch"]
    if not epoch:
        print("  validation produced NO epoch data (empty eval stream?)")
    print(f"  train GAP >= {CONVERGED_GAP} first at step: "
          f"{result['first_converged_step']}; last logged: {result['last']}")
    print(f"  per-step loss trajectory sha1: {result['trajectory_sha1']} "
          f"({result['trajectory_steps']} steps)")
    print(f"  held-out Hit@1 {epoch.get('avg_hit_at_one', 0.0):.4f}"
          f" | PERR {epoch.get('avg_perr', 0.0):.4f}"
          f" | GAP {epoch.get('gap', 0.0):.4f}"
          f" | mAP {result['map']:.4f}")


def band_checks(result: Dict):
    """[(ok, description)] of the three bands."""
    epoch = result["epoch"]
    step = result["first_converged_step"]
    return [
        (step is not None and step <= CONVERGED_BY_STEP,
         f"train GAP reaches {CONVERGED_GAP} by step {CONVERGED_BY_STEP} "
         f"(first at {step})"),
        (epoch.get("avg_hit_at_one", 0.0) >= MIN_HELDOUT_HIT,
         f"held-out student Hit@1 >= {MIN_HELDOUT_HIT}"),
        (epoch.get("gap", 0.0) >= MIN_HELDOUT_GAP,
         f"held-out student GAP >= {MIN_HELDOUT_GAP}"),
    ]


def check_bands(result: Dict) -> None:
    """Print the bands; raise AssertionError if any is missed."""
    checks = band_checks(result)
    for ok, msg in checks:
        print(f"  [{'ok' if ok else 'FAIL'}] {msg}")
    missed = [msg for ok, msg in checks if not ok]
    if missed:
        raise AssertionError("acceptance bands missed: " + "; ".join(missed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("The port's convergence gate")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="/gpu:0",
                    help="/gpu:N, cuda:N or cpu (a multi-hour run on a CPU)")
    ap.add_argument("--extra_flags", default="",
                    help="flags appended to the recipe's, for a study of "
                    "its variants (e.g. '--seed 1', '--lstm_pallas_train "
                    "false'); the bands are checked all the same")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="yt8m_acceptance_")
    result = run(workdir, FLAGSHIP_FLAGS + shlex.split(args.extra_flags),
                 device=args.device)
    print("=== acceptance bands ===")
    report(result)
    try:
        check_bands(result)
    except AssertionError:
        print("ACCEPTANCE RUN FAILED")
        return 1
    print("acceptance bands: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
