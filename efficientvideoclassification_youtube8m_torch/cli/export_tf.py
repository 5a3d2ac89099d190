"""Export a checkpoint as a reference TF-V2 bundle (port of the JAX
package's cli/export_tf.py).

Interop in the opposite direction from the importer: a model trained
here becomes a `model.ckpt-<step>` Saver-V2 bundle that the reference's
TF1 binaries (`validate.py:350-381` Saver maps,
`inspect_checkpoint_myfile.py`) consume directly, with the MoE layout
permuted back to the reference's class-interleaved columns and the Adam
moments and beta powers kept, so reference training can resume from it.

Usage:
    python -m efficientvideoclassification_youtube8m_torch.cli.export_tf \
        --train_dir /x/model_train --output_prefix /x/tf_export/model.ckpt \
        [--tower distill|student] <model dimension flags>
"""

from __future__ import annotations

import logging
import os
import sys

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.train.tf_export import (
    export_tf_checkpoint,
)

logger = logging.getLogger("export_tf")


def export(args) -> str:
    """Restore the checkpoint into a template of `--tower`'s state and
    write the bundle; returns its prefix."""
    cfg = flags_lib.config_from_args(args)
    device = flags_lib.resolve_device(args)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, optimizer, device=device)
    if args.tower == "student":
        state = student_state_from_distill(state, optimizer)

    ckpt = args.checkpoint or latest_checkpoint(cfg.train_dir)
    if ckpt is None:
        raise IOError(f"no checkpoint found in {cfg.train_dir}")
    logger.info("Restoring %s", ckpt)
    restore_checkpoint(ckpt, state)

    step = int(state.global_step)
    prefix = args.output_prefix or os.path.join(
        cfg.train_dir, f"tf_export/model.ckpt-{step}")
    if not prefix.rsplit("-", 1)[-1].isdigit():
        prefix = f"{prefix}-{step}"
    out = export_tf_checkpoint(prefix, state)
    # a TF-style pointer file so the reference's tf.train.latest_checkpoint
    # finds the bundle, but NEVER over an existing one: inside a live
    # train_dir it would redirect the next resume or eval poll to the
    # exported bundle
    pointer = os.path.join(os.path.dirname(os.path.abspath(out)), "checkpoint")
    if os.path.exists(pointer):
        logger.warning(
            "%s already exists (a live checkpoint directory?); leaving it "
            "untouched: point the reference tooling at the bundle prefix",
            pointer)
    else:
        with open(pointer, "w") as f:
            f.write(f'model_checkpoint_path: "{os.path.basename(out)}"\n')
            f.write(f'all_model_checkpoint_paths: "{os.path.basename(out)}"\n')
    logger.info("Exported TF-V2 bundle %s", out)
    return out


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser(
        "Export a checkpoint as a reference TF-V2 Saver bundle")
    parser.add_argument("--checkpoint", default="",
                        help="explicit checkpoint path (msgpack file or "
                        "TF-V2 prefix); default: latest in --train_dir")
    parser.add_argument("--output_prefix", default="",
                        help="output bundle prefix (the step is appended "
                        "when absent); default "
                        "<train_dir>/tf_export/model.ckpt-<step>")
    parser.add_argument("--tower", default="distill",
                        choices=["distill", "student"],
                        help="distill: both towers (train.py graphs); "
                        "student: student-only (finetune graphs)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return export(args)


if __name__ == "__main__":
    main(sys.argv[1:])
