"""Student validator with the teacher present for L_REP (port of the JAX
package's cli/validate.py, single process on one device).

Evaluates the STUDENT on validation shards while running the teacher to
report the representation loss; waits for new checkpoints unless
--run_once. In bf16 on a CUDA device both towers' recurrences run in the
forward-only kernel (`--use_pallas_inference`, default on).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.loop import HostFetch, device_prefetch
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    restore_subtree,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.train.step import build_validate_step
from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader
from efficientvideoclassification_youtube8m_torch.metrics import EvaluationMetrics

logger = logging.getLogger("validate")

# what the eval binaries restore: the optimizer slots are never read
EVAL_FIELDS = ("global_step", "dropout_keep_prob")


def eval_loader(cfg, args, frame_stride: int = 1) -> FrameDataLoader:
    """One ordered pass over --eval_data_pattern, the final batch padded."""
    return FrameDataLoader(
        args.eval_data_pattern,
        batch_size=cfg.batch_size,
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
                   log, with_lrep=False):
    """The eval binaries' epoch: a lag-`fetch_depth` FIFO ring of launched
    batches, one packed fetch per batch (`gather_step_outputs`, its copy
    queued behind its own step by `HostFetch`), the reference's per-batch
    log line to the logger `log` (with the step's L_REP when `with_lrep`)
    and the epoch summary. FIFO order keeps the epoch metrics those of the
    sequential loop."""
    evl_metrics = EvaluationMetrics(cfg.num_classes, args.top_k)
    examples_processed = 0
    start = time.time()

    keys = ("host_pack", "student_loss_state") if with_lrep else ("host_pack",)

    def drain(fetch, labels, pad):
        nonlocal examples_processed
        out = fetch.get()
        rows = distributed.gather_step_outputs(out, labels, pad)
        info = evl_metrics.accumulate_topk(
            rows["topk_val"], rows["topk_idx"], rows["labels"],
            rows["per_example_loss"], perr_precision=rows["perr_precision"])
        examples_processed += rows["topk_val"].shape[0]
        info["examples_per_second"] = examples_processed / (time.time() - start)
        line = summary_lib.add_global_step_summary(
            writer, global_step_val, info, summary_scope="Eval")
        if with_lrep:
            log.info("%s | L_REP: %.4f", line, float(out["student_loss_state"]))
        else:
            log.info(line)

    ring: deque = deque()
    depth = max(1, cfg.fetch_depth)
    for (f, l, n), (labels, pad) in device_prefetch(
            loader, device, host_keep=lambda b: (b.labels, b.pad)):
        ring.append((HostFetch(launch(f, l, n), keys), labels, pad))
        if len(ring) > depth:
            drain(*ring.popleft())
    while ring:
        drain(*ring.popleft())
    epoch_data = evl_metrics.get()
    epoch_data["epoch_id"] = global_step_val
    log.info(summary_lib.add_epoch_summary(
        writer, global_step_val, epoch_data, summary_scope="Eval"))
    log.info("Average examples processed in one second %0.20f",
             examples_processed / (time.time() - start))
    return epoch_data


def poll_checkpoints(cfg, args, evaluate_checkpoint, log) -> None:
    """Evaluate each new latest checkpoint of --train_dir; once with
    --run_once, else poll every 30 s."""
    last_checkpoint = None
    while True:
        ckpt = latest_checkpoint(cfg.train_dir)
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
    distributed.initialize()
    flags_lib.check_ported(args)
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        # the reference's validate.py has no aggregated-reader branch
        raise ValueError(
            "--frame_features=False: validation runs both distillation "
            "towers and requires frame-level features. Evaluate "
            "video-level models with cli.eval --frame_features=False.")
    flags_lib.resolve_steps_per_dispatch(args, logger=logger)
    device = flags_lib.resolve_device(args)
    # parameters only: the optimizer slots this binary never reads are
    # neither allocated nor restored
    state = DistillState(teacher=init_model(cfg, device=device),
                         student=init_model(cfg, device=device),
                         opt_teacher={}, opt_student={}, global_step=0,
                         dropout_keep_prob=cfg.dropout)
    step_fn = build_validate_step(cfg, top_k=args.top_k)
    writer = summary_lib.SummaryWriter(os.path.join(cfg.train_dir, "eval"))
    results = []

    def evaluate_checkpoint(ckpt):
        restore_subtree(ckpt, state,
                        ("params_teacher", "params_student") + EVAL_FIELDS)
        results.append(run_eval_epoch(
            cfg, args, eval_loader(cfg, args), device,
            lambda f, l, n: step_fn(state.teacher, state.student, f, l, n),
            state.global_step, writer, logger, with_lrep=True))

    poll_checkpoints(cfg, args, evaluate_checkpoint, logger)
    writer.close()
    return results[-1] if results else None


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Validate the student on YT8M (GPU)")
    parser.add_argument("--steps_per_dispatch", type=int, default=0,
                        help="0 = auto (1 off the TPU) or 1: one batch per "
                        "launch; K > 1 is not ported (ROADMAP Queue 1, "
                        "the host paths of the binaries)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return evaluate(args)


if __name__ == "__main__":
    main(sys.argv[1:])
