"""Finetuned-student evaluator (port of the JAX package's cli/eval.py):
one process per device; under a `torch.distributed` group each rank
evaluates its slice of the shards and the rows are gathered, as
cli.validate does.

The reference's eval_finetune.py: student-only eval, epoch-level
GAP/mAP/Hit@1/PERR, waiting for new checkpoints unless --run_once. The
loader strides the frames to every_n at the parser. In bf16 on a CUDA
device the recurrences run in the forward-only kernel
(`--use_pallas_inference`, default on); `--quantize int8` quantizes each
restored student once and evaluates the int8 forward, whose recurrences
run in the int8 kernel on a CUDA device. `--frame_features=False`
evaluates a video-level model on pre-aggregated Examples
(eval_finetune.py:298-302). `--steps_per_dispatch K` fetches the outputs
of K batches at a time (`cli.loop.eval_loop`); the epoch metrics are
those of K = 1.
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
from efficientvideoclassification_youtube8m_torch.parallel.mesh import (
    create_mesh,
    shard_state,
)
from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
    build_sharded_eval_step,
    build_sharded_quantized_eval_step,
)
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    restore_subtree,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    StudentState,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib

logger = logging.getLogger("eval")


def evaluate(args):
    """Returns the epoch metrics of the last checkpoint evaluated."""
    cfg = flags_lib.config_from_args(args)
    aggregated = not args.frame_features
    if args.quantize == "int8" and aggregated:
        raise ValueError("--quantize int8 is the frame-level student path")
    flags_lib.resolve_steps_per_dispatch(args, logger=logger)
    device = flags_lib.resolve_device(args)
    distributed.initialize(device=device)
    host = distributed.host_context(cfg.batch_size, args.model_parallelism)
    # parameters only: the optimizer slots are neither allocated nor read
    state = StudentState(student=init_model(cfg, device=device), opt_student={},
                         global_step=0, dropout_keep_prob=cfg.dropout)
    mesh = create_mesh(model=args.model_parallelism, device=device)
    if args.quantize == "int8":
        step_fn = build_sharded_quantized_eval_step(cfg, mesh, top_k=args.top_k,
                                                    host_subsampled=True)
    else:
        # frame path: the loader strides the frames at the parser
        # a rank's program: the ranks' rows are gathered in run_eval_epoch
        step_fn = build_sharded_eval_step(cfg, mesh, top_k=args.top_k,
                                          host_subsampled=not aggregated,
                                          aggregated=aggregated)
    shard_state(state, mesh)  # each checkpoint restores into the columns
    writer = summary_lib.for_master(os.path.join(cfg.train_dir, "eval"),
                                    host.is_master)
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
            cfg, args, eval_loader(cfg, args,
                                   frame_stride=1 if aggregated else cfg.every_n,
                                   aggregated=aggregated, host=host), device,
            lambda f, l, n: step_fn(params, f, l, n), state.global_step, writer,
            logger, mesh=mesh))

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
                        help="K batches a fetch; the epoch metrics are those "
                        "of K = 1. 0 and negative values read as 1")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return evaluate(args)


if __name__ == "__main__":
    main(sys.argv[1:])
