"""Finetuned-student evaluator (port of the JAX package's cli/eval.py,
frame-level path, single process on one device).

The reference's eval_finetune.py: student-only eval, epoch-level
GAP/mAP/Hit@1/PERR, waiting for new checkpoints unless --run_once. The
loader strides the frames to every_n at the parser. In bf16 on a CUDA
device the recurrences run in the forward-only kernel
(`--use_pallas_inference`, default on); `--quantize int8` quantizes each
restored student once and evaluates the int8 forward, whose recurrences
run in the int8 kernel on a CUDA device.
"""

from __future__ import annotations

import logging
import os
import sys

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.validate import (
    EVAL_FIELDS,
    eval_loader,
    poll_checkpoints,
    run_eval_epoch,
)
from efficientvideoclassification_youtube8m_torch.ops.quantize import (
    quantize_hierarchical_params,
)
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    restore_subtree,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    StudentState,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.train.step import (
    build_eval_step,
    build_quantized_eval_step,
)
from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib

logger = logging.getLogger("eval")


def evaluate(args):
    """Returns the epoch metrics of the last checkpoint evaluated."""
    distributed.initialize()
    flags_lib.check_ported(args)
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        raise NotImplementedError(
            "--frame_features=False (video-level models on aggregated "
            "Examples) is not ported yet (ROADMAP Queue 1 item 12)")
    flags_lib.resolve_steps_per_dispatch(args, logger=logger)
    device = flags_lib.resolve_device(args)
    # parameters only: the optimizer slots are neither allocated nor read
    state = StudentState(student=init_model(cfg, device=device), opt_student={},
                         global_step=0, dropout_keep_prob=cfg.dropout)
    if args.quantize == "int8":
        step_fn = build_quantized_eval_step(cfg, top_k=args.top_k,
                                            host_subsampled=True)
    else:
        step_fn = build_eval_step(cfg, top_k=args.top_k, host_subsampled=True)
    writer = summary_lib.SummaryWriter(os.path.join(cfg.train_dir, "eval"))
    results = []

    def evaluate_checkpoint(ckpt):
        restore_subtree(ckpt, state, ("params_student",) + EVAL_FIELDS)
        params = state.student
        if args.quantize == "int8":
            # the int8 serving numerics: quantized once per checkpoint
            params = quantize_hierarchical_params(
                state.student, cfg.total_feature_size, cfg.lstm_cells,
                cfg.lstm_layers, device=device)
        results.append(run_eval_epoch(
            cfg, args, eval_loader(cfg, args, frame_stride=cfg.every_n), device,
            lambda f, l, n: step_fn(params, f, l, n), state.global_step, writer,
            logger))

    poll_checkpoints(cfg, args, evaluate_checkpoint, logger)
    writer.close()
    return results[-1] if results else None


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Evaluate the finetuned student (GPU)")
    parser.add_argument("--quantize", default="none", choices=["none", "int8"],
                        help="int8: evaluate the quantized serving path "
                        "(ops/quantize.py), the deploy-gate accuracy check")
    parser.add_argument("--steps_per_dispatch", type=int, default=0,
                        help="0 = auto (1 off the TPU) or 1: one batch per "
                        "launch; K > 1 is not ported (ROADMAP Queue 1 "
                        "item 9)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return evaluate(args)


if __name__ == "__main__":
    main(sys.argv[1:])
