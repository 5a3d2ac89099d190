"""Checkpoint converter: teacher-student -> standalone student (port of
the JAX package's cli/convert.py).

The reference's train_convert_model.py ("meta-graph surgery", :360-401):
restore the latest teacher-student checkpoint, keep the student, reset
the optimizer slots and the step, and save at step 0 into the finetune
directory derived the reference's way: `train_dir.replace('train','') +
'finetune/'`. Then re-restore the file and check the student round-trips.
"""

from __future__ import annotations

import logging
import os
import sys

import torch

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    StudentState,
    init_distill_state,
    init_model,
    student_state_from_distill,
)

logger = logging.getLogger("convert")


def finetune_dir(train_dir: str) -> str:
    """The reference's finetune directory of `train_dir`:
    `train_dir.replace('train', '') + 'finetune/'`, every "train" of the
    path dropped (train_convert_model.py:398). From
    `./model_HLSTM_TeaStud_every10_train` it is
    `./model_HLSTM_TeaStud_every10_finetune/`; a trailing slash would
    leave `.../every10_/finetune/`."""
    return train_dir.replace("train", "") + "finetune/"


def convert(args) -> str:
    cfg = flags_lib.config_from_args(args)
    device = flags_lib.resolve_device(args)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, optimizer, device=device)

    ckpt = latest_checkpoint(cfg.train_dir)
    if ckpt is None:
        raise IOError(f"no checkpoint found in {cfg.train_dir}")
    logger.info("Restoring student variables from %s", ckpt)
    restore_checkpoint(ckpt, state)

    student_state = student_state_from_distill(state, optimizer)
    out_dir = finetune_dir(cfg.train_dir)
    os.makedirs(out_dir, exist_ok=True)
    path = save_checkpoint(out_dir, student_state, 0,
                           backend=args.checkpoint_format)
    logger.info("Saved standalone student checkpoint to %s", path)

    # the reference re-restores after the save (train_convert_model.py:
    # 398-401)
    student = init_model(cfg, device=device)
    restored = restore_checkpoint(path, StudentState(
        student=student, opt_student=optimizer.init(dict(student.named_parameters())),
        global_step=-1, dropout_keep_prob=0.0))
    want = student_state.student.state_dict()
    for name, value in restored.student.state_dict().items():
        if not torch.equal(value, want[name]):
            raise AssertionError(f"{path}: {name} did not round-trip")
    logger.info("Round-trip restore verified.")
    return path


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser(
        "Convert a teacher-student checkpoint to student-only")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return convert(args)


if __name__ == "__main__":
    main(sys.argv[1:])
