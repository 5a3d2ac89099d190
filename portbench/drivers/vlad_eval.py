"""The eval loop of `cli.eval` over NeXtVLAD (`NeXtVLADGatedModel` at its
published widths, the configuration's "nextvlad"): the program's
`cli.validate.run_eval_epoch` at K = 1 with the one-rank sharded eval
step (`top_k` and `fetch_depth` from the configuration, the frames
strided to every_n at the parser: at every_n 1 every frame), the
program's summary writer and a logger, and the program's loader over the
pool, in order.

It is `eval_loop.run` with another model: set-up warms the loop on a
few batches, the window ends with the last batch whose results the loop
accumulated, and `correct` compares the same numbers (eval_loop's
docstring), here against `portbench/reference/nextvlad.py`: a reservoir
keeps the step's predictions and packed host rows of a sample of the
window's batches, and a recording writer the loop's summaries. Its
control is the reference itself in fp8 (`harness.FP8`), its top-k rows
and losses packed as the program packs them.

A model of another family is added the same way: a reference module
under `portbench/reference/` whose forward takes a `Precision`, a
weights module that draws its leaves under the program's names from the
seed, a counts module with its FLOPs and least bytes, a configuration
file whose flags name the program's `--model` and which holds the widths
the program's constructor takes by default, and a driver like this one
that builds the program's module from those leaves and compares it with
its reference."""

from __future__ import annotations

import argparse
import logging
from typing import Dict, List

import numpy as np
import torch

from portbench import harness
from portbench import weights_vlad
from portbench.drivers import eval_loop
from portbench.reference import model as ref_model
from portbench.reference import nextvlad as ref_vlad


def build(ctx: harness.Context, cfg, args):
    """(the program's module holding the seed's leaves, the one-rank eval
    step)."""
    from efficientvideoclassification_youtube8m_torch.parallel.mesh import create_mesh
    from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
        build_sharded_eval_step)

    ctx.mark("program_imports")
    leaves = weights_vlad.draw(ctx.config, ctx.seed, ctx.device)
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
                  "loader_wait_s": tap.wait_s - wait0, "widths": ctx.config["nextvlad"]},
        numbers=found, kept={"inputs": inputs, "want": want, "top_k": args.top_k})


def reference_predictions(ctx: harness.Context, inputs, prec=ref_model.PLAIN
                          ) -> List[torch.Tensor]:
    """The reference's predictions for each kept batch, from the seed's
    leaves, on the run's device."""
    ref_model.no_tf32()
    params = weights_vlad.draw(ctx.config, ctx.seed, ctx.device)
    out = []
    with torch.no_grad():
        for b in inputs:
            out.append(ref_vlad.predictions(
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


def pack_rows(preds: torch.Tensor, labels: torch.Tensor, k: int) -> np.ndarray:
    """`preds` [B, V] as the program's packed host rows (eval_loop's
    layout): the top k values, their classes, the per-video cross
    entropy and a PERR lane (0, not compared)."""
    val, idx = torch.topk(preds, k, dim=1)
    idx = idx.to(torch.int32)
    if preds.shape[1] - 1 <= eval_loop.PAIRED_MAX:
        if k % 2:
            idx = torch.nn.functional.pad(idx, (0, 1))
        classes = (idx[:, 0::2] | (idx[:, 1::2] << 16) | -(1 << 30)).view(torch.float32)
    else:
        classes = idx.to(torch.float32)
    loss = ref_model.cross_entropy(preds, labels).to(torch.float32)
    return torch.cat([val, classes, loss[:, None], torch.zeros_like(loss)[:, None]],
                     dim=1).numpy()
