"""The eval loop of `cli.eval` over the YouTube-8M LSTM baseline
(`LstmModel` at its published widths, 2 x 1024 cells over every frame,
the configuration's flags): the program's `cli.validate.run_eval_epoch`
at K = 1 with the one-rank sharded eval step (`top_k` and `fetch_depth`
from the configuration, the frames strided to every_n at the parser: at
every_n 1 every frame), the program's summary writer and a logger, and
the program's loader over the pool, in order.

It is `vlad_eval.run` with another model (`vlad_eval`'s docstring): the
same set-up, window and comparison, here against
`portbench/reference/lstm.py` on leaves drawn by
`portbench/weights_lstm.py`. Its control is the reference itself in fp8
(`harness.FP8`), its top-k rows and losses packed as the program packs
them (`vlad_eval.pack_rows`)."""

from __future__ import annotations

import argparse
import logging
from typing import Dict, List

import torch

from portbench import harness
from portbench import weights_lstm
from portbench.drivers import eval_loop
from portbench.drivers.vlad_eval import pack_rows
from portbench.reference import lstm as ref_lstm
from portbench.reference import model as ref_model


def build(ctx: harness.Context, cfg, args):
    """(the program's module holding the seed's leaves, the one-rank eval
    step)."""
    from efficientvideoclassification_youtube8m_torch.parallel.mesh import create_mesh
    from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
        build_sharded_eval_step)

    ctx.mark("program_imports")
    leaves = weights_lstm.draw(ctx.flags, ctx.seed, ctx.device)
    ctx.mark("weights")
    module = harness.program_tower(cfg, leaves, ctx.device)
    ctx.mark("modules")
    mesh = create_mesh(model=1, device=ctx.device)
    return module.eval(), build_sharded_eval_step(cfg, mesh, top_k=args.top_k,
                                                  host_subsampled=True)


def run(ctx: harness.Context) -> harness.Outcome:
    from efficientvideoclassification_youtube8m_torch.cli.validate import run_eval_epoch
    from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib

    args, cfg = harness.program_config(
        ctx.flags, train_dir=ctx.tmp / "eval", seed=harness.program_seed(ctx.seed),
        device=str(ctx.device))
    args = argparse.Namespace(**vars(args), steps_per_dispatch=1)
    params, step_fn = build(ctx, cfg, args)
    ctx.mark("program")
    pattern = harness.write_pool(ctx)
    ctx.mark("pool")
    loader = harness.frame_loader(ctx, cfg, pattern)
    tracer = harness.tracer_for(ctx)
    tap = harness.Tap(iter(loader), tracer, traced=ctx.trace)
    logger = logging.getLogger("portbench.eval")
    writer = summary_lib.SummaryWriter(str(ctx.tmp / "eval"))
    sample = eval_loop.Reservoir(ctx.spec["check"]["batches"], ctx.seed)
    launched = [0]

    def launch(f, l, n):
        with harness.trace_lib.span("step", ctx.trace):
            out = step_fn(params, f, l, n)
        sample.keep(launched[0], out)
        launched[0] += 1
        return out

    run_eval_epoch(cfg, args, tap.take(ctx.spec["warmup_batches"]), ctx.device,
                   lambda f, l, n: step_fn(params, f, l, n), 0, writer,
                   eval_loop.TimedLog(logger))
    ctx.mark("warm_up")
    harness.sync(ctx.device)
    harness.reset_peak(ctx.device)
    setup_s = ctx.clock()
    wait0, count0 = tap.wait_s, tap.count
    log = eval_loop.TimedLog(logger)
    recorder = eval_loop.RecordingWriter(writer)
    start = harness.begin_window(ctx, tracer)
    run_eval_epoch(cfg, args, tap.until(start, ctx.seconds, sample.offer), ctx.device,
                   launch, 0, recorder, log)
    n_batches = tap.count - count0
    window_s = log.times[n_batches - 1] - start
    peak = harness.memory_peak(ctx.device)
    tap.close()
    writer.close()
    summary = tracer.reduce() if tracer is not None else None
    kept = sample.kept()
    for k in kept:
        k["info"] = recorder.info(k["index"])
        k["preds"] = None if k["preds"] is None else k["preds"].float().cpu()
        k["pack"] = None if k["pack"] is None else k["pack"].cpu().numpy()
    del params, step_fn
    harness.free(ctx.device)

    inputs = eval_loop.pool_inputs(ctx, [k["ids"] for k in kept])
    want = reference_predictions(ctx, inputs)
    found = dict(eval_loop.prediction_gaps([k["preds"] for k in kept], want),
                 **eval_loop.pack_gaps([k["pack"] for k in kept], want, inputs, args.top_k,
                                       cfg.num_classes))
    found["info_max_abs"] = eval_loop.info_gap(kept, inputs, args.top_k, cfg.num_classes)
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, attempted=n_batches, failed=0,
        metrics={"eval_videos_per_s": n_batches * cfg.batch_size / window_s},
        checks=harness.checks(ctx, found), memory_peak_bytes=peak, trace=summary,
        marks=ctx.marks,
        observed={"batch": cfg.batch_size, "steps": n_batches,
                  "loader_wait_s": tap.wait_s - wait0},
        numbers=found, kept={"inputs": inputs, "want": want, "top_k": args.top_k})


def reference_predictions(ctx: harness.Context, inputs, prec=ref_model.PLAIN
                          ) -> List[torch.Tensor]:
    """The reference's predictions for each kept batch, from the seed's
    leaves, on the run's device."""
    ref_model.no_tf32()
    params = weights_lstm.draw(ctx.flags, ctx.seed, ctx.device)
    out = []
    with torch.no_grad():
        for b in inputs:
            out.append(ref_lstm.predictions(
                params, torch.from_numpy(b["features"]).to(ctx.device),
                torch.from_numpy(b["num_frames"]).to(ctx.device), ctx.flags, prec).cpu())
    return out


def control(ctx: harness.Context, out: harness.Outcome) -> Dict[str, Dict[str, float]]:
    """The numbers of the control: the reference in fp8 on the kept
    batches, its rows packed as the program packs them, against the
    reference."""
    inputs, k = out.kept["inputs"], out.kept["top_k"]
    preds = reference_predictions(ctx, inputs, harness.FP8)
    packs = [pack_rows(p, torch.from_numpy(b["labels"]), k) for p, b in zip(preds, inputs)]
    want = out.kept["want"]
    return {"fp8": dict(eval_loop.prediction_gaps(preds, want),
                        **eval_loop.pack_gaps(packs, want, inputs, k, preds[0].shape[1]))}

