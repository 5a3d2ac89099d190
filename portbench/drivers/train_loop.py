"""The training loop of `cli.train` (step "distill") and `cli.finetune`
(step "finetune"): the program's `cli.loop.run_training_loop` with the
one-rank sharded step, the program's summary writer, `cli.train`'s
per-step host work in `log_step`, and the program's loader over the
pool.

Set-up builds the one state the window trains, from the seed's weights,
and drives it through its first three steps with the window's own call
and feed (the loop over the loader): one call of one step, after which
the first gradient is read from Adam's first moment, then one of two,
after which the parameters' change is read. Their three batches (rows
all distinct) are kept for the reference. The checkpoint cadence and the
graph summaries' cadence (the CLI's defaults, 1800 s and 120 s) lie
beyond the window; the final save is left out (the saver's stall is
another cell's).

After the window: the reference trains its own towers, drawn from the
same seed, three steps over the same batches, and the losses of each
step, the first gradient's norm and the parameters' change by leaf are
compared."""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, List

import torch

from portbench import harness
from portbench import weights as weights_lib
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

LOSSES = {"distill": ("teacher_label_loss", "student_label_loss",
                      "student_loss_state", "pred_loss"),
          "finetune": ("student_label_loss",)}
TOWERS = {"distill": ("teacher", "student"), "finetune": ("student",)}
BETA1 = 0.9


class NoSaver:
    """The checkpoint saver the window runs with: no save."""

    def save(self, *args, **kwargs):
        pass

    def wait(self):
        pass


def build(ctx: harness.Context, step: str):
    """(args, cfg, state, step_fn) of the cell, as the CLI builds them."""
    from efficientvideoclassification_youtube8m_torch.parallel.mesh import (
        create_mesh, shard_state)
    from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
        build_sharded_distill_step, build_sharded_finetune_step)
    from efficientvideoclassification_youtube8m_torch.train.optimizer import (
        make_optimizer)
    from efficientvideoclassification_youtube8m_torch.train.state import (
        DistillState, StudentState, params_of)

    args, cfg = harness.program_config(
        ctx.flags, train_dir=ctx.tmp / "train", seed=harness.program_seed(ctx.seed),
        device=str(ctx.device))
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    towers = harness.program_towers(ctx, cfg, TOWERS[step])
    mesh = create_mesh(model=1, device=ctx.device)
    if step == "distill":
        state = DistillState(
            teacher=towers["teacher"], student=towers["student"],
            opt_teacher=optimizer.init(params_of(towers["teacher"])),
            opt_student=optimizer.init(params_of(towers["student"])),
            global_step=0, dropout_keep_prob=cfg.dropout)
        step_fn = build_sharded_distill_step(cfg, optimizer, mesh, top_k=args.top_k)
    else:
        state = StudentState(
            student=towers["student"],
            opt_student=optimizer.init(params_of(towers["student"])),
            global_step=0, dropout_keep_prob=cfg.dropout)
        step_fn = build_sharded_finetune_step(cfg, optimizer, mesh, top_k=args.top_k,
                                              host_subsampled=True)
    shard_state(state, mesh)
    return args, cfg, state, step_fn


def _leaves(state, step: str) -> Dict[str, torch.Tensor]:
    return {f"{t}.{n}": p for t in TOWERS[step]
            for n, p in getattr(state, t).named_parameters()}


def _first_moment_norms(state, step: str) -> Dict[str, float]:
    """The first gradient as Adam got it, from its first moment after one
    step: m = (1 - beta1) g."""
    out = {}
    for t in TOWERS[step]:
        for n, m in getattr(state, f"opt_{t}")["mu"].items():
            out[f"{t}.{n}"] = float(torch.linalg.vector_norm(m.double()) / (1 - BETA1))
    return out


def run(ctx: harness.Context) -> harness.Outcome:
    from efficientvideoclassification_youtube8m_torch.cli.loop import run_training_loop
    from efficientvideoclassification_youtube8m_torch.metrics import train_step_metrics
    from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib

    step = ctx.spec["step"]
    pattern = harness.write_pool(ctx)
    ctx.mark("pool")
    args, cfg, state, step_fn = build(ctx, step)
    ctx.mark("program")
    loader = harness.frame_loader(ctx, cfg, pattern)
    tracer = harness.tracer_for(ctx)
    tap = harness.Tap(iter(loader), tracer, traced=ctx.trace)
    logger = logging.getLogger("portbench.train")
    recorded: List[Dict[str, float]] = []

    def traced_step(*a):
        with harness.trace_lib.span("step", ctx.trace):
            return step_fn(*a)

    def log_step(metrics, labels, seconds_per_batch):
        """cli.train's per-step host work: the training metrics and the
        writer's scalars; the step's losses are recorded."""
        with harness.trace_lib.span("log_step", ctx.trace):
            global_step = int(metrics["global_step"])
            info = train_step_metrics(
                metrics["topk_val"].cpu().numpy(), metrics["topk_idx"].cpu().numpy(),
                labels, perr_precision=metrics["perr_precision"].cpu().numpy())
            losses = {k: float(metrics[k]) for k in LOSSES[step]}
            logger.info("training step %d| Hit@1: %.2f| PERR: %.2f| GAP: %.2f| %s",
                        global_step, info["hit_at_one"], info["perr"], info["gap"],
                        losses)
            writer.scalar("model/Training_Hit@1", info["hit_at_one"], global_step)
            writer.scalar("model/Training_Perr", info["perr"], global_step)
            writer.scalar("model/Training_GAP", info["gap"], global_step)
            writer.scalar("global_step/Examples/Second",
                          labels.shape[0] / seconds_per_batch, global_step)
            writer.flush()
            recorded.append(losses)

    def loop(batches):
        nonlocal writer
        writer = summary_lib.SummaryWriter(str(ctx.tmp / "train"))
        return run_training_loop(
            loader=batches, device=ctx.device, state=state, step_fn=traced_step,
            saver=NoSaver(), writer=writer, cfg=cfg, args=args, log_step=log_step,
            write_graph_summaries=lambda *a: None, logger=logger)

    writer = None
    kept: List = []
    p0 = {k: p.detach().clone() for k, p in _leaves(state, step).items()}
    state = loop(tap.take(1, kept))
    grad_norms = _first_moment_norms(state, step)
    state = loop(tap.take(2, kept))
    change_norms = {k: float(torch.linalg.vector_norm((p.detach() - p0[k]).double()))
                    for k, p in _leaves(state, step).items()}
    del p0
    program_losses = list(recorded)
    ctx.mark("first_steps")
    harness.free(ctx.device)

    harness.sync(ctx.device)
    harness.reset_peak(ctx.device)
    setup_s = ctx.clock()
    wait0, count0 = tap.wait_s, tap.count
    start = harness.begin_window(ctx, tracer)
    state = loop(tap.until(start, ctx.seconds))
    harness.sync(ctx.device)
    window_s = time.perf_counter() - start
    steps = tap.count - count0
    peak = harness.memory_peak(ctx.device)
    tap.close()
    summary = tracer.reduce() if tracer is not None else None
    del state, step_fn
    harness.free(ctx.device)

    want = reference_readings(ctx, step, kept)
    got = {"losses": program_losses, "grad_norms": grad_norms, "change_norms": change_norms}
    found = numbers(step, got, want)
    videos = steps * cfg.batch_size
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, attempted=steps, failed=0,
        metrics={"train_videos_per_s": videos / window_s},
        checks=harness.checks(ctx, found), memory_peak_bytes=peak, trace=summary,
        marks=ctx.marks,
        observed={"batch": cfg.batch_size, "steps": steps,
                  "loader_wait_s": tap.wait_s - wait0},
        numbers=found, kept={"batches": kept, "want": want})


def reference_readings(ctx: harness.Context, step: str, batches,
                       prec=ref_model.PLAIN) -> Dict:
    """The reference's three steps from the seed's weights over `batches`
    (the program's FrameBatch objects): losses a step, the first clipped
    gradient's norm by leaf, and the parameters' change by leaf."""
    ref_model.no_tf32()
    drawn = weights_lib.draw(ctx.flags, TOWERS[step], ctx.seed, ctx.device)
    towers = {t: {k: v.requires_grad_() for k, v in leaves.items()}
              for t, leaves in drawn.items()}
    p0 = {f"{t}.{k}": v.detach().clone() for t, leaves in towers.items()
          for k, v in leaves.items()}
    dev = [{"features": torch.from_numpy(b.features).to(ctx.device),
            "labels": torch.from_numpy(b.labels).to(ctx.device),
            "num_frames": torch.from_numpy(b.num_frames).to(ctx.device)}
           for b in batches]
    out = ref_train.run_steps(ctx.flags, step, towers, dev, prec)
    grads = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in out["first_grads"].items()}
    change = {f"{t}.{k}": float(torch.linalg.vector_norm((v.detach() - p0[f"{t}.{k}"]).double()))
              for t, leaves in towers.items() for k, v in leaves.items()}
    return {"losses": out["losses"], "grad_norms": grads, "change_norms": change}


def numbers(step: str, got: Dict, want: Dict) -> Dict[str, float]:
    """The compared numbers: each loss of the first step and the worst of
    the three steps (relative), the worst leaf of the first gradient's
    norm and of the parameters' change. A
    leaf whose reference gradient is under a thousandth of the median
    leaf's moves by round-off alone and is left out of the change."""
    out = {}
    same = len(got["losses"]) == len(want["losses"])
    for key in LOSSES[step]:
        gaps = [harness.rel_gap(g[key], w[key]) for g, w in zip(got["losses"], want["losses"])]
        out[f"{key}_step1_rel"] = gaps[0] if gaps and same else math.inf
        out[f"{key}_rel"] = max(gaps) if gaps and same else math.inf
    grads = want["grad_norms"]
    median = sorted(grads.values())[len(grads) // 2]
    moving = [k for k, v in grads.items() if v >= 1e-3 * median]
    out["grad_norm_rel"] = harness.leaf_norm_gap(got["grad_norms"], grads)
    out["change_norm_rel"] = harness.leaf_norm_gap(got["change_norms"],
                                                   want["change_norms"], moving)
    return out


def control(ctx: harness.Context, out: harness.Outcome) -> Dict[str, Dict[str, float]]:
    """The numbers of the control (the reference in fp8 in the program's
    place) and of a planted fault (the reference on the first half of
    each batch, its losses the mean over that half), on the same
    batches, against the reference."""
    step, batches, want = ctx.spec["step"], out.kept["batches"], out.kept["want"]
    half = [type(b)(b.video_ids[:len(b.video_ids) // 2], b.features[:len(b.video_ids) // 2],
                    b.labels[:len(b.video_ids) // 2], b.num_frames[:len(b.video_ids) // 2])
            for b in batches]
    return {"fp8": numbers(step, reference_readings(ctx, step, batches, harness.FP8), want),
            "half_batch": numbers(step, reference_readings(ctx, step, half), want)}
