"""Student-only finetuner (port of the JAX package's cli/finetune.py,
frame-level path, single process on one device).

The reference's train_finetune.py: single-tower training of the student
(CE + reg) resuming from the converted checkpoint in --train_dir (the
finetune directory, per run_finetune.sh). The loader strides the frames
to every_n at the parser, so only the student's frames are decoded and
copied. In bf16 on a CUDA device the recurrences run in the train
kernels (`--lstm_pallas_train`, default on).
"""

from __future__ import annotations

import logging
import sys
import time

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.loop import run_training_loop
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    AsyncCheckpointSaver,
    latest_checkpoint,
    restore_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    StudentState,
    init_model,
    params_of,
)
from efficientvideoclassification_youtube8m_torch.train.step import build_finetune_step
from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader
from efficientvideoclassification_youtube8m_torch.metrics import train_step_metrics

logger = logging.getLogger("finetune")


def finetune(args):
    distributed.initialize()
    flags_lib.check_ported(args)
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        raise NotImplementedError(
            "--frame_features=False (video-level models on aggregated "
            "Examples) is not ported yet (ROADMAP Queue 1, the model zoo and losses)")
    device = flags_lib.resolve_device(args)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    ckpt = None if args.start_new_model else latest_checkpoint(cfg.train_dir)
    if args.start_new_model:
        # from scratch (train_finetune.py:377-379); opt-in only, so a
        # mistyped --train_dir cannot silently train from a random init
        logger.info("Building new model.")
    elif ckpt is None:
        raise IOError(f"no converted checkpoint in {cfg.train_dir}; run "
                      "convert first, or pass --start_new_model to train "
                      "from scratch")
    # the student of a fresh distill state (`init_distill_state`): drawn
    # from the second half of split(PRNGKey(seed))
    student = init_model(cfg, prng.split(prng.prng_key(cfg.seed))[1], device)
    state = StudentState(student=student,
                         opt_student=optimizer.init(params_of(student)),
                         global_step=0, dropout_keep_prob=cfg.dropout)
    logger.info("Trainable Parameters of Student:")
    logger.info("%s", flags_lib.param_names(state.student, "model_student"))
    logger.info("Device: %s", device)
    step_fn = build_finetune_step(cfg, optimizer, top_k=args.top_k,
                                  host_subsampled=True)
    if ckpt:
        logger.info("Resuming student from %s", ckpt)
        restore_checkpoint(ckpt, state)

    loader = FrameDataLoader(
        cfg.train_data_pattern,
        batch_size=cfg.batch_size,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=cfg.num_epochs,
        shuffle=True,
        seed=cfg.seed,
        drop_remainder=True,  # static shapes, no fabricated rows
        use_native=cfg.use_native_io,
        bagging=args.bagging,
        # the student reads every every_n-th frame: stride at the parser
        frame_stride=cfg.every_n,
    )
    writer = summary_lib.SummaryWriter(cfg.train_dir)
    start_time = time.time()
    logger.info("Entering training loop.")

    def write_graph_summaries(metrics, global_step_val, cur_state):
        """In-graph scalars (train_finetune.py:229,285,297,322) + one
        histogram per student variable, at save_summaries_secs cadence."""
        for tag in ("learning_rate", "student_label_loss", "student_reg_loss"):
            writer.scalar(tag, float(metrics[tag]), global_step_val)
        summary_lib.write_variable_histograms(
            writer, cur_state.student, "model_student", global_step_val)
        writer.flush()

    def log_step(metrics, labels, seconds_per_batch):
        global_step_val = int(metrics["global_step"])
        info = train_step_metrics(
            metrics["topk_val"].cpu().numpy(), metrics["topk_idx"].cpu().numpy(),
            labels, perr_precision=metrics["perr_precision"].cpu().numpy())
        logger.info(
            "training step %d| Hit@1: %.2f| PERR: %.2f| GAP: %.2f| L_CE: %s",
            global_step_val, info["hit_at_one"], info["perr"], info["gap"],
            round(float(metrics["student_label_loss"]), 2),
        )
        writer.scalar("model/Training_Hit@1", info["hit_at_one"], global_step_val)
        writer.scalar("model/Training_Perr", info["perr"], global_step_val)
        writer.scalar("model/Training_GAP", info["gap"], global_step_val)
        writer.scalar("global_step/Examples/Second",
                      labels.shape[0] / seconds_per_batch, global_step_val)
        writer.flush()

    state = run_training_loop(
        loader=loader, device=device, state=state, step_fn=step_fn,
        saver=AsyncCheckpointSaver(enabled=args.async_checkpoint),
        writer=writer, cfg=cfg, args=args, log_step=log_step,
        write_graph_summaries=write_graph_summaries, logger=logger,
    )
    print("Total time taken is " + str(time.time() - start_time))
    return state


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Finetune the student alone (GPU)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return finetune(args)


if __name__ == "__main__":
    main(sys.argv[1:])
