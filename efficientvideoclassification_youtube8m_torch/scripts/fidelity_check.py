"""The fidelity harness of the port (port of the JAX package's
scripts/fidelity_check.py), the analog of the reference's acceptance
test: a logged `run_train.sh` run on the 10-record sample.

    python -m efficientvideoclassification_youtube8m_torch.scripts.fidelity_check \
        [--workdir DIR] [--num_videos 10] [--device cpu]

Writes a YT8M-shaped synthetic sample (10 videos a split at flagship
widths), runs the five stages on it through the port's binaries with the
JAX script's canonical flags (batch 5, 2 epochs, `--scan_unroll 1`):
train, validate, convert, finetune, eval. Then it pins the few-step loss
trajectory against the reference's golden log (its README, lines
116-122): the analytic step-2 init CE and the step-4 decrease shape
(teacher CE falls, L_REP grows as the towers specialize, L_PRED stays
near 0.01). Data order and init differ from the reference's run, so
these are bands, not bit-equality; the step-2 value is tight (it is
analytic). A missed band exits 1.

It runs on the card unless `--device cpu` is given (a run of about 20
minutes at flagship widths on one CPU core). `run` does the work at any
width, so that a CPU test can drive the plumbing at tiny ones; `main` is
`run` at the canonical flags plus the bands.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

from efficientvideoclassification_youtube8m_torch.cli import convert as convert_cli
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import finetune as finetune_cli
from efficientvideoclassification_youtube8m_torch.cli import train as train_cli
from efficientvideoclassification_youtube8m_torch.cli import validate as validate_cli
from efficientvideoclassification_youtube8m_torch.data import write_synthetic_frame_shard

# Reference golden log, README.md:116-122 (run_train.sh on the 10-record
# sample): the two logged steps of the acceptance run.
GOLDEN = {
    2: {"teacher": 1914.09, "l_rep": 1.16, "l_pred": 0.01, "l_ce": 1914.1},
    4: {"teacher": 1908.12, "l_rep": 1.52, "l_pred": 0.01, "l_ce": 1913.41},
}

STEP_RE = re.compile(
    r"training step (\d+)\|.*Teacher_Loss: ([\d.]+)\| "
    r"L_REP: ([\d.]+)\| L_PRED: ([\d.]+)\| L_CE: ([\d.]+)"
)

NUM_VIDEOS = 10
# the JAX script's canonical flags, the batch scaled to the sample
FLAGS = [
    "--feature_names", "rgb, audio",
    "--feature_sizes", "1024, 128",
    "--model", "HierarchicalLstmModel",
    "--batch_size", "5",
    "--num_inputs_to_lstm", "20",
    "--lstm_layers", "2",
    "--every_n", "10",
    "--num_epochs", "2",
    "--num_readers", "2",
    # accepted for parity: the port's kernels take no unroll
    "--scan_unroll", "1",
]


class _StepCapture(logging.Handler):
    """Collects the trainer's per-step metric lines."""

    def __init__(self):
        super().__init__()
        self.steps = {}

    def emit(self, record):
        m = STEP_RE.search(record.getMessage())
        if m:
            self.steps[int(m.group(1))] = {
                "teacher": float(m.group(2)),
                "l_rep": float(m.group(3)),
                "l_pred": float(m.group(4)),
                "l_ce": float(m.group(5)),
            }


def check_trajectory(steps) -> bool:
    """Band checks of the loss-decrease SHAPE vs the golden log."""
    ok = True

    def expect(cond, msg):
        nonlocal ok
        status = "ok" if cond else "FAIL"
        print(f"  [{status}] {msg}")
        ok = ok and cond

    s2, s4 = steps.get(2), steps.get(4)
    expect(s2 is not None and s4 is not None,
           f"steps 2 and 4 logged (got {sorted(steps)})")
    if not (s2 and s4):
        return False
    print(f"  step 2: {s2}  (golden {GOLDEN[2]})")
    print(f"  step 4: {s4}  (golden {GOLDEN[4]})")
    # step-2 init CE is analytic (label base rates at sigmoid init):
    # tight band around the golden 1914.09
    expect(abs(s2["teacher"] - GOLDEN[2]["teacher"]) < 2.0,
           f"step-2 Teacher_Loss {s2['teacher']:.2f} within 2.0 of "
           f"{GOLDEN[2]['teacher']}")
    expect(abs(s2["l_ce"] - GOLDEN[2]["l_ce"]) < 2.0,
           f"step-2 L_CE {s2['l_ce']:.2f} within 2.0 of {GOLDEN[2]['l_ce']}")
    # step-4 shape: teacher CE falls (golden: -5.97), student CE falls
    # less (golden: -0.69), L_REP grows as the towers specialize
    # (golden: 1.16 -> 1.52), L_PRED stays near zero (golden: 0.01)
    drop = s2["teacher"] - s4["teacher"]
    expect(1.0 < drop < 20.0,
           f"step-4 teacher CE decrease {drop:.2f} in (1, 20) "
           f"(golden {GOLDEN[2]['teacher'] - GOLDEN[4]['teacher']:.2f})")
    expect(s4["l_ce"] < s2["l_ce"],
           f"step-4 L_CE {s4['l_ce']:.2f} < step-2 {s2['l_ce']:.2f}")
    # L_REP's init LEVEL tracks the data distribution (golden 1.16 on
    # real YT8M features; ~0.08 on this synthetic sample) — only the
    # smallness and the growth shape below are data-independent
    expect(0.0 < s2["l_rep"] < 3.0,
           f"step-2 L_REP {s2['l_rep']:.2f} small at init, in (0, 3) "
           f"(golden {GOLDEN[2]['l_rep']} on real features)")
    expect(s4["l_rep"] > s2["l_rep"],
           f"L_REP grows {s2['l_rep']:.2f} -> {s4['l_rep']:.2f} "
           f"(golden {GOLDEN[2]['l_rep']} -> {GOLDEN[4]['l_rep']})")
    expect(s2["l_pred"] < 0.2 and s4["l_pred"] < 0.2,
           f"L_PRED stays near zero ({s2['l_pred']}, {s4['l_pred']}; "
           f"golden 0.01)")
    return ok


def run(workdir: str, flags: Sequence[str] = tuple(FLAGS),
        num_videos: int = NUM_VIDEOS, device: str = "/gpu:0",
        shard_kwargs: Optional[Dict] = None) -> Dict:
    """Write the sample under `workdir` (seed 0 for train, 1 for validate)
    and run the five stages through the port's binaries on `device`.
    Returns the captured train steps ({step: losses}), the train and
    finetune directories (the latter by the reference's rule, as
    cli.convert derives it), the validate and eval epochs and the
    seconds of each stage. Asserts nothing."""
    data_dir = os.path.join(workdir, "yt8m")
    os.makedirs(data_dir, exist_ok=True)
    for split, seed in (("train", 0), ("validate", 1)):
        write_synthetic_frame_shard(
            os.path.join(data_dir, f"{split}-0000.tfrecord"),
            num_videos=num_videos, seed=seed, **(shard_kwargs or {}))
    train_pattern = os.path.join(data_dir, "train*.tfrecord")
    eval_pattern = os.path.join(data_dir, "validate*.tfrecord")
    train_dir = os.path.join(workdir, "model_train") + "/"
    flags = list(flags) + ["--device", device]
    seconds = {}

    print("=== train (teacher+student) ===")
    capture = _StepCapture()
    train_logger = logging.getLogger("train")
    # the per-step lines are INFO records, whatever the caller's logging
    level = train_logger.level
    train_logger.setLevel(logging.INFO)
    train_logger.addHandler(capture)
    t0 = time.perf_counter()
    try:
        train_cli.main(flags + [
            "--train_dir", train_dir,
            "--train_data_pattern", train_pattern,
            "--start_new_model", "true",
        ])
    finally:
        train_logger.removeHandler(capture)
        train_logger.setLevel(level)
    seconds["train"] = time.perf_counter() - t0

    print("=== validate ===")
    t0 = time.perf_counter()
    validate_epoch = validate_cli.main(flags + [
        "--train_dir", train_dir,
        "--eval_data_pattern", eval_pattern,
        "--run_once", "true",
    ])
    seconds["validate"] = time.perf_counter() - t0

    print("=== convert ===")
    t0 = time.perf_counter()
    convert_cli.main(flags + ["--train_dir", train_dir])
    seconds["convert"] = time.perf_counter() - t0
    finetune_dir = convert_cli.finetune_dir(train_dir)

    print("=== finetune ===")
    t0 = time.perf_counter()
    finetune_cli.main(flags + [
        "--train_dir", finetune_dir,
        "--train_data_pattern", train_pattern,
        "--num_epochs", "1",
    ])
    seconds["finetune"] = time.perf_counter() - t0

    print("=== eval ===")
    t0 = time.perf_counter()
    eval_epoch = eval_cli.main(flags + [
        "--train_dir", finetune_dir,
        "--eval_data_pattern", eval_pattern,
        "--run_once", "true",
    ])
    seconds["eval"] = time.perf_counter() - t0
    print(f"fidelity pipeline completed under {workdir}")
    return {"steps": capture.steps, "train_dir": train_dir,
            "finetune_dir": finetune_dir, "validate": validate_epoch,
            "eval": eval_epoch, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("The port's fidelity harness")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--num_videos", type=int, default=NUM_VIDEOS)
    ap.add_argument("--device", default="/gpu:0",
                    help="/gpu:N, cuda:N or cpu (the whole pipeline on the "
                    "CPU: about 20 min at flagship widths)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="yt8m_fidelity_")
    result = run(workdir, FLAGS, args.num_videos, args.device)
    print("=== trajectory vs reference golden log (README.md:116-122) ===")
    if not check_trajectory(result["steps"]):
        print("TRAJECTORY CHECK FAILED vs the reference golden log")
        return 1
    print("trajectory check vs the reference golden log: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
