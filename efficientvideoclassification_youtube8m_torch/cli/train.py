"""Teacher+student distillation trainer (port of the JAX package's
cli/train.py, single process on one device).

The rebuild of the reference's train.py: same flags, same log-line
format, same summary tags ("model/Training_Hit@1|Perr|GAP",
"global_step/Examples/Second", train.py:528-545), same checkpoint cadence
(save_model_secs, max_to_keep=1) and resume from the latest checkpoint.
In bf16 on a CUDA device the recurrences run in the train kernels
(`--lstm_pallas_train`, default on).
"""

from __future__ import annotations

import logging
import sys
import time

from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli.loop import run_training_loop
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    AsyncCheckpointSaver,
    latest_checkpoint,
    restore_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import init_distill_state
from efficientvideoclassification_youtube8m_torch.train.step import (
    build_distill_train_step,
)
from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader
from efficientvideoclassification_youtube8m_torch.metrics import train_step_metrics

logger = logging.getLogger("train")
TASK = "/job:master/task:0"  # the reference's task prefix (train.py:528-533)


def train(args):
    distributed.initialize()
    flags_lib.check_ported(args)
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        # the reference accepts the flag, but its graph build then fails
        # on the rank-2 aggregated input (train.py:268)
        raise ValueError(
            "--frame_features=False: the teacher-student distillation "
            "trainer requires frame-level features. Train video-level "
            "models on aggregated Examples with "
            "cli.finetune --frame_features=False --start_new_model.")
    device = flags_lib.resolve_device(args)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, optimizer, device=device)

    logger.info("Trainable Parameters of Teacher:")
    logger.info("%s", flags_lib.param_names(state.teacher, "model"))
    logger.info("Trainable Parameters of Student:")
    logger.info("%s", flags_lib.param_names(state.student, "model_student"))
    logger.info("Device: %s", device)
    step_fn = build_distill_train_step(cfg, optimizer, top_k=args.top_k)
    ckpt = None if args.start_new_model else latest_checkpoint(cfg.train_dir)
    if ckpt:
        logger.info("Restoring from %s", ckpt)
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
    )
    writer = summary_lib.SummaryWriter(cfg.train_dir)
    saver = AsyncCheckpointSaver(enabled=args.async_checkpoint)
    start_time = time.time()
    logger.info("%s: Entering training loop.", TASK)

    def write_graph_summaries(metrics, global_step_val, cur_state):
        """The reference's in-graph summaries (train.py:238-239,298,363,
        373,426-427): LR + loss scalars and one histogram per variable."""
        for tag, key in (("learning_rate", "learning_rate"),
                         ("learning_rate_stud", "learning_rate"),
                         ("label_loss", "teacher_label_loss"),
                         ("reg_loss", "teacher_reg_loss"),
                         ("State_student_loss", "student_loss_state"),
                         ("student_label_loss", "student_label_loss")):
            writer.scalar(tag, float(metrics[key]), global_step_val)
        summary_lib.write_variable_histograms(
            writer, cur_state.teacher, "model", global_step_val)
        summary_lib.write_variable_histograms(
            writer, cur_state.student, "model_student", global_step_val)
        writer.flush()

    def log_step(metrics, labels, seconds_per_batch):
        """Hit@1, GAP from the device top-k; PERR is the exact full-row
        precision computed inside the step."""
        global_step_val = int(metrics["global_step"])
        info = train_step_metrics(
            metrics["topk_val"].cpu().numpy(), metrics["topk_idx"].cpu().numpy(),
            labels, perr_precision=metrics["perr_precision"].cpu().numpy())
        logger.info(
            "%s: training step %d| Hit@1: %.2f| PERR: %.2f| GAP: %.2f| "
            "Teacher_Loss: %s| L_REP: %s| L_PRED: %s| L_CE: %s",
            TASK, global_step_val, info["hit_at_one"], info["perr"],
            info["gap"],
            round(float(metrics["teacher_label_loss"]), 2),
            round(float(metrics["student_loss_state"]), 2),
            round(float(metrics["pred_loss"]), 2),
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
        saver=saver, writer=writer, cfg=cfg, args=args, log_step=log_step,
        write_graph_summaries=write_graph_summaries, logger=logger,
    )
    print("Total time taken is " + str(time.time() - start_time))
    return state


def main(argv=None):
    flags_lib.setup_logging()
    parser = flags_lib.base_parser("Train teacher+student on YT8M (GPU)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    return train(args)


if __name__ == "__main__":
    main(sys.argv[1:])
