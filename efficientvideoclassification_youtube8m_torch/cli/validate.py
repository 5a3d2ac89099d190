"""Student validator with the teacher present for L_REP (port of the JAX
package's cli/validate.py): one process per device, each rank
evaluating its slice of the shards under a `torch.distributed` group.

Evaluates the STUDENT on validation shards while running the teacher to
report the representation loss; waits for new checkpoints unless
--run_once. In bf16 on a CUDA device both towers' recurrences run in the
forward-only kernel (`--use_pallas_inference`, default on). Under a
group the master names the checkpoint, every rank's valid rows are
gathered before the host metrics (the epoch metrics are those of one
process), and the master alone writes summaries.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.loop import eval_loop
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.parallel.mesh import (
    create_mesh,
    shard_state,
)
from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
    build_sharded_validate_step,
)
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    restore_subtree,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.utils import profiling
from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_torch.data import (
    AggregatedDataLoader,
    FrameDataLoader,
)
from efficientvideoclassification_youtube8m_torch.metrics import EvaluationMetrics

logger = logging.getLogger("validate")

# what the eval binaries restore: the optimizer slots are never read
EVAL_FIELDS = ("global_step", "dropout_keep_prob")


def eval_loader(cfg, args, frame_stride: int = 1, aggregated: bool = False,
                pattern: Optional[str] = None,
                host: Optional[distributed.HostContext] = None
                ) -> FrameDataLoader:
    """One ordered pass over `pattern` (default --eval_data_pattern), the
    final batch padded; with `aggregated`, of pre-aggregated Examples.
    With `host`, this rank's shards and its slice of the batch."""
    loader_cls = AggregatedDataLoader if aggregated else FrameDataLoader
    if host is None:
        host = distributed.host_context(cfg.batch_size)
    return loader_cls(
        args.eval_data_pattern if pattern is None else pattern,
        batch_size=host.local_batch_size,
        shard_index=host.process_index,
        num_shards=host.process_count,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=1,
        shuffle=False,
        pad_final_batch=True,
        use_native=cfg.use_native_io,
        frame_stride=frame_stride,
    )


def run_eval_epoch(cfg, args, loader, device, launch, global_step_val, writer,
                   log, with_lrep=False, mesh=None):
    """The eval binaries' epoch over `cli.loop.eval_loop` (lag
    `fetch_depth`, one fetch a group of `--steps_per_dispatch` batches):
    each batch's packed host outputs unpacked into one row set per data
    index of the `--model_parallelism` layout
    (`distributed.gather_step_outputs`), the reference's per-batch log
    line to the logger `log` (with the step's L_REP when `with_lrep`) and
    the epoch summary. Batch order keeps the epoch metrics those of the
    sequential loop at every K. `mesh` is the step's (a model group's
    ranks run the batches of its first rank's loader)."""
    evl_metrics = EvaluationMetrics(cfg.num_classes, args.top_k)
    examples_processed = 0
    start = time.time()

    keys = ("host_pack", "student_loss_state") if with_lrep else ("host_pack",)
    batches = eval_loop(distributed.sync_host_streams(loader, "eval", mesh), device,
                        max(1, args.steps_per_dispatch), max(1, cfg.fetch_depth),
                        launch, keys, host_keep=lambda b: (b.labels, b.pad))
    for index, (out, (labels, pad)) in enumerate(batches):
        with profiling.annotate("eval.accumulate", index):
            with profiling.annotate("eval.unpack", index):
                rows = distributed.gather_step_outputs(out, labels, pad,
                                                       args.model_parallelism)
            with profiling.annotate("metrics.accumulate_topk"):
                info = evl_metrics.accumulate_topk(
                    rows["topk_val"], rows["topk_idx"], rows["labels"],
                    rows["per_example_loss"], perr_precision=rows["perr_precision"])
            with profiling.annotate("eval.summary"):
                examples_processed += rows["topk_val"].shape[0]
                info["examples_per_second"] = examples_processed / (time.time() - start)
                line = summary_lib.add_global_step_summary(
                    writer, global_step_val, info, summary_scope="Eval")
                if with_lrep:
                    log.info("%s | L_REP: %.4f", line, float(out["student_loss_state"]))
                else:
                    log.info(line)
            profiling.count("eval.batches")
    epoch_data = evl_metrics.get()
    epoch_data["epoch_id"] = global_step_val
    log.info(summary_lib.add_epoch_summary(
        writer, global_step_val, epoch_data, summary_scope="Eval"))
    log.info("Average examples processed in one second %0.20f",
             examples_processed / (time.time() - start))
    return epoch_data


def poll_checkpoints(cfg, args, evaluate_checkpoint, log) -> None:
    """Evaluate each new latest checkpoint of --train_dir; once with
    --run_once, else poll every 30 s. The master names the checkpoint, so
    every rank evaluates the same one."""
    last_checkpoint = None
    while True:
        ckpt = distributed.broadcast_str(
            latest_checkpoint(cfg.train_dir) if distributed.is_master() else None)
        if ckpt is None:
            log.info("No checkpoint yet in %s; waiting.", cfg.train_dir)
        elif ckpt != last_checkpoint:
            log.info("Loading checkpoint for eval: %s", ckpt)
            evaluate_checkpoint(ckpt)
            last_checkpoint = ckpt
        if args.run_once:
            break
        time.sleep(30)


def evaluate(args):
    """Returns the epoch metrics of the last checkpoint evaluated."""
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        # the reference's validate.py has no aggregated-reader branch
        raise ValueError(
            "--frame_features=False: validation runs both distillation "
            "towers and requires frame-level features. Evaluate "
            "video-level models with cli.eval --frame_features=False.")
    flags_lib.resolve_steps_per_dispatch(args, logger=logger)
    device = flags_lib.resolve_device(args)
    distributed.initialize(device=device)
    host = distributed.host_context(cfg.batch_size, args.model_parallelism)
    # parameters only: the optimizer slots this binary never reads are
    # neither allocated nor restored
    state = DistillState(teacher=init_model(cfg, device=device),
                         student=init_model(cfg, device=device),
                         opt_teacher={}, opt_student={}, global_step=0,
                         dropout_keep_prob=cfg.dropout)
    mesh = create_mesh(model=args.model_parallelism, device=device)
    step_fn = build_sharded_validate_step(cfg, mesh, top_k=args.top_k)
    shard_state(state, mesh)  # each checkpoint restores into the columns
    writer = summary_lib.for_master(os.path.join(cfg.train_dir, "eval"),
                                    host.is_master)
    results = []

    def evaluate_checkpoint(ckpt):
        restore_subtree(ckpt, state,
                        ("params_teacher", "params_student") + EVAL_FIELDS)
        results.append(run_eval_epoch(
            cfg, args, eval_loader(cfg, args, host=host), device,
            lambda f, l, n: step_fn(state.teacher, state.student, f, l, n),
            state.global_step, writer, logger, with_lrep=True, mesh=mesh))

    poll_checkpoints(cfg, args, evaluate_checkpoint, logger)
    writer.close()
    return results[-1] if results else None


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Validate the student on YT8M (GPU)")
    parser.add_argument("--steps_per_dispatch", type=int, default=0,
                        help="K batches a fetch; the epoch metrics are those "
                        "of K = 1. 0 and negative values read as 1")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return evaluate(args)


if __name__ == "__main__":
    main(sys.argv[1:])
