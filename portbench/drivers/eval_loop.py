"""The eval loop of `cli.eval` and `cli.validate`: the program's
`cli.validate.run_eval_epoch` at K = 1 with the one-rank sharded eval
step over the student (`top_k` and `fetch_depth` from the configuration,
the frames strided to every_n at the parser), the program's summary
writer and a logger, and the program's loader over the pool, in order.

Set-up warms the loop on a few batches. The window ends with the last
batch whose results the loop accumulated (its per-batch log line); the
epoch's `get()` falls outside it.

What `correct` compares. A reservoir drawn from the seed keeps a sample
of the window's batches as they pass: their video ids, and copies of the
step's predictions and of its packed host rows (top-k values and
classes, per-video loss, PERR), queued on the device behind the step. A
recording writer keeps, at full precision, every per-batch summary the
loop made of its fetched rows (Hit@1, PERR, loss). After the window the
reference works out each kept batch's predictions from the pool's
videos, found by id, never from the loader's output, and compares:

- `prob_max_abs`, `prob_mean_abs`: the step's predictions against the
  reference's;
- `topk_max_abs`: the packed top-k rows, read by this module's own
  reader of the pack's layout: each value against the reference's
  probability of its class, and that probability against the
  reference's value at the same rank;
- `loss_mean_rel`: the packed per-video cross entropy against the
  reference's over the pool's labels, the relative gap's mean over the
  kept videos (`loss_max_rel`, its widest, is reported, not compared: the
  control reads only 2.5 times the sound program there);
- `info_max_abs`: the loop's summary of each kept batch against the
  same means taken plainly over the packed rows and the pool's labels,
  in the accumulator's precision: a fetch that drops or alters rows, or
  an accumulator that counts wrong, reads above 0; a sound run reads 0.

A later cell runs another eval step through `run(ctx, build=...)`."""

from __future__ import annotations

import argparse
import logging
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import harness
from portbench import traffic as traffic_lib
from portbench import weights as weights_lib
from portbench.reference import model as ref_model

# the packed host rows' layout (the program's `train/step.py`,
# `_pack_host_outputs`, as it stood when the benchmark was defined):
# k f32 values | the k classes, two int16 a lane with bits 31 and 30 set,
# while every class id fits in 14 bits (else one f32 class a lane) |
# the per-video loss | PERR
PAIRED_MAX = 0x3F7F
INFO_TAGS = ("GlobalStep/Eval_Hit@1", "GlobalStep/Eval_Perr", "GlobalStep/Eval_Loss")


class TimedLog:
    """The loop's logger: writes through `logger` and keeps the time of
    each line."""

    def __init__(self, logger: logging.Logger):
        self.logger = logger
        self.times: List[float] = []

    def info(self, *args):
        self.logger.info(*args)
        self.times.append(time.perf_counter())


class RecordingWriter:
    """The program's summary writer, passed through, keeping every
    per-batch summary scalar the loop writes, in order."""

    def __init__(self, writer):
        self.writer = writer
        self.scalars: Dict[str, List[float]] = {t: [] for t in INFO_TAGS}

    def scalar(self, tag, value, global_step=0):
        if tag in self.scalars:
            self.scalars[tag].append(value)
        self.writer.scalar(tag, value, global_step)

    def info(self, i: int) -> Optional[List[float]]:
        """(Hit@1, PERR, loss) of the window's i-th batch, if written."""
        rows = [self.scalars[t] for t in INFO_TAGS]
        return [r[i] for r in rows] if all(i < len(r) for r in rows) else None

    def __getattr__(self, name):
        return getattr(self.writer, name)


class Reservoir:
    """k slots over a stream, each index kept with probability k / (i+1)
    (seeded); a kept index's video ids, predictions and packed rows share
    its slot."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = traffic_lib.rng(seed, 5)
        self.slot_of: Dict[int, int] = {}
        self.index: List = [None] * k
        self.ids: List = [None] * k
        self.preds: List = [None] * k
        self.packs: List = [None] * k
        self.seen = 0

    def offer(self, batch) -> None:
        i = self.seen
        self.seen += 1
        j = i if i < self.k else int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.slot_of[i] = j
            self.index[j], self.ids[j] = i, list(batch.video_ids)
            self.preds[j] = self.packs[j] = None

    def keep(self, i: int, out: Dict[str, torch.Tensor]) -> None:
        j = self.slot_of.pop(i, None)
        if j is not None and self.index[j] == i:
            self.preds[j] = out["predictions"].detach().clone()
            self.packs[j] = out["host_pack"].detach().clone()

    def kept(self) -> List[Dict]:
        return [{"index": i, "ids": v, "preds": p, "pack": q}
                for i, v, p, q in zip(self.index, self.ids, self.preds, self.packs)
                if i is not None]


def build_bf16(ctx: harness.Context, cfg, args):
    """(the student as the step takes it, the one-rank eval step)."""
    from efficientvideoclassification_youtube8m_torch.parallel.mesh import create_mesh
    from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
        build_sharded_eval_step)

    student = harness.program_towers(ctx, cfg, ("student",))["student"].eval()
    mesh = create_mesh(model=1, device=ctx.device)
    return student, build_sharded_eval_step(cfg, mesh, top_k=args.top_k,
                                             host_subsampled=True)


def run(ctx: harness.Context, build=build_bf16) -> harness.Outcome:
    from efficientvideoclassification_youtube8m_torch.cli.validate import run_eval_epoch
    from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib

    pattern = harness.write_pool(ctx)
    ctx.mark("pool")
    args, cfg = harness.program_config(
        ctx.flags, train_dir=ctx.tmp / "eval", seed=harness.program_seed(ctx.seed),
        device=str(ctx.device))
    args = argparse.Namespace(**vars(args), steps_per_dispatch=1)
    params, step_fn = build(ctx, cfg, args)
    ctx.mark("program")
    loader = harness.frame_loader(ctx, cfg, pattern)
    tracer = harness.tracer_for(ctx)
    tap = harness.Tap(iter(loader), tracer, traced=ctx.trace)
    logger = logging.getLogger("portbench.eval")
    writer = summary_lib.SummaryWriter(str(ctx.tmp / "eval"))
    sample = Reservoir(ctx.spec["check"]["batches"], ctx.seed)
    launched = [0]

    def launch(f, l, n):
        with harness.trace_lib.span("step", ctx.trace):
            out = step_fn(params, f, l, n)
        sample.keep(launched[0], out)
        launched[0] += 1
        return out

    warm = run_eval_epoch(cfg, args, tap.take(ctx.spec["warmup_batches"]), ctx.device,
                          lambda f, l, n: step_fn(params, f, l, n), 0, writer,
                          TimedLog(logger))
    del warm
    ctx.mark("warm_up")
    harness.sync(ctx.device)
    harness.reset_peak(ctx.device)
    setup_s = ctx.clock()
    wait0, count0 = tap.wait_s, tap.count
    log = TimedLog(logger)
    recorder = RecordingWriter(writer)
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

    inputs = pool_inputs(ctx, [k["ids"] for k in kept])
    want = reference_predictions(ctx, inputs)
    found = dict(prediction_gaps([k["preds"] for k in kept], want),
                 **pack_gaps([k["pack"] for k in kept], want, inputs, args.top_k,
                             cfg.num_classes))
    found["info_max_abs"] = info_gap(kept, inputs, args.top_k, cfg.num_classes)
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, attempted=n_batches, failed=0,
        metrics={"eval_videos_per_s": n_batches * cfg.batch_size / window_s},
        checks=harness.checks(ctx, found), memory_peak_bytes=peak, trace=summary,
        marks=ctx.marks,
        observed={"batch": cfg.batch_size, "steps": n_batches,
                  "loader_wait_s": tap.wait_s - wait0},
        numbers=found, kept={"inputs": inputs, "want": want, "top_k": args.top_k})


def control(ctx: harness.Context, out: harness.Outcome) -> Dict[str, Dict[str, float]]:
    """The numbers of the control: the program's own int8 eval step (its
    weights quantized once, as `cli.eval --quantize int8` does) on the
    kept batches, against the reference."""
    from efficientvideoclassification_youtube8m_torch.ops.quantize import (
        quantize_hierarchical_params)
    from efficientvideoclassification_youtube8m_torch.parallel.mesh import create_mesh
    from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
        build_sharded_quantized_eval_step)

    args, cfg = harness.program_config(ctx.flags, seed=harness.program_seed(ctx.seed),
                                       device=str(ctx.device))
    student = harness.program_towers(ctx, cfg, ("student",))["student"]
    qparams = quantize_hierarchical_params(student, cfg.total_feature_size,
                                           cfg.lstm_cells, cfg.lstm_layers,
                                           device=ctx.device)
    step_fn = build_sharded_quantized_eval_step(cfg, create_mesh(model=1, device=ctx.device),
                                                top_k=args.top_k, host_subsampled=True)
    preds, packs = [], []
    for b in out.kept["inputs"]:
        f = torch.from_numpy(np.ascontiguousarray(b["features"][:, ::cfg.every_n]))
        o = step_fn(qparams, f.to(ctx.device), torch.from_numpy(b["labels"]).to(ctx.device),
                    torch.from_numpy(b["num_frames"]).to(ctx.device))
        preds.append(o["predictions"].float().cpu())
        packs.append(o["host_pack"].cpu().numpy())
    want = out.kept["want"]
    return {"int8": dict(prediction_gaps(preds, want),
                         **pack_gaps(packs, want, out.kept["inputs"], out.kept["top_k"],
                                     cfg.num_classes))}


def pool_inputs(ctx: harness.Context, ids: List[List[str]]) -> List[Dict[str, np.ndarray]]:
    """Each kept batch's videos from the seed's pool, by id: full uint8
    frames, true lengths and dense labels."""
    pool = traffic_lib.pool(ctx.traffic, ctx.flags, ctx.seed, str(ctx.device))
    dense = traffic_lib.dense_labels(pool["labels"], ctx.flags["num_classes"])
    out = []
    for batch in ids:
        rows = np.asarray([traffic_lib.video_index(v) for v in batch])
        out.append({"features": pool["features"][rows], "num_frames": pool["num_frames"][rows],
                    "labels": dense[rows]})
    return out


def reference_predictions(ctx: harness.Context, inputs, prec=ref_model.PLAIN
                          ) -> List[torch.Tensor]:
    """The reference student's predictions for each kept batch, from the
    seed's weights, on the host."""
    ref_model.no_tf32()
    params = weights_lib.draw(ctx.flags, ("student",), ctx.seed, ctx.device)["student"]
    out = []
    with torch.no_grad():
        for b in inputs:
            out.append(ref_model.student_predictions(
                params, torch.from_numpy(b["features"]).to(ctx.device),
                torch.from_numpy(b["num_frames"]).to(ctx.device), ctx.flags, prec).cpu())
    return out


def prediction_gaps(got: List[torch.Tensor], want: List[torch.Tensor]) -> Dict[str, float]:
    """The widest and the mean absolute gap of the predicted
    probabilities over every kept row and class."""
    if (not want or len(got) != len(want)
            or any(g is None or g.shape != w.shape for g, w in zip(got, want))):
        return {"prob_max_abs": math.inf, "prob_mean_abs": math.inf}
    diffs = [(g.to(w.device) - w).abs() for g, w in zip(got, want)]
    if not all(torch.isfinite(d).all() for d in diffs):
        return {"prob_max_abs": math.inf, "prob_mean_abs": math.inf}
    return {"prob_max_abs": max(float(d.max()) for d in diffs),
            "prob_mean_abs": float(sum(d.sum() for d in diffs)
                                   / sum(d.numel() for d in diffs))}


def unpack(pack: np.ndarray, k: int, num_classes: int) -> Dict[str, np.ndarray]:
    """The packed host rows' fields (the layout above)."""
    if num_classes - 1 <= PAIRED_MAX:
        h = (k + 1) // 2
        words = np.ascontiguousarray(pack[:, k:k + h]).view(np.int32) & 0x3FFFFFFF
        idx = np.stack([words & 0xFFFF, words >> 16], axis=2).reshape(len(pack), 2 * h)[:, :k]
    else:
        h = k
        idx = pack[:, k:2 * k].astype(np.int32)
    m = k + h
    if pack.shape[1] != m + 2:
        raise ValueError(f"a pack of {pack.shape[1]} lanes for k = {k}")
    return {"topk_val": pack[:, :k], "topk_idx": idx, "loss": pack[:, m],
            "perr": pack[:, m + 1]}


def pack_gaps(packs, want: List[torch.Tensor], inputs, k: int, num_classes: int
              ) -> Dict[str, float]:
    """`topk_max_abs`, `loss_mean_rel` and `loss_max_rel` of the packed
    rows against the reference (see the module's docstring)."""
    bad = {"topk_max_abs": math.inf, "loss_mean_rel": math.inf, "loss_max_rel": math.inf}
    if not want or len(packs) != len(want) or any(p is None for p in packs):
        return bad
    topk, loss, rels = 0.0, 0.0, []
    for pack, w, b in zip(packs, want, inputs):
        try:
            f = unpack(pack, k, num_classes)
        except ValueError:
            return bad
        idx = torch.from_numpy(f["topk_idx"].astype(np.int64))
        if (idx.shape != (w.shape[0], k) or int(idx.min()) < 0
                or int(idx.max()) >= w.shape[1]):
            return bad
        at = w.gather(1, idx)
        ranked = torch.topk(w, k, dim=1).values
        val = torch.from_numpy(np.array(f["topk_val"]))
        gap = torch.maximum((val - at).abs(), ranked - at)
        ref_loss = ref_model.cross_entropy(w.double(), torch.from_numpy(b["labels"]))
        rel = (torch.from_numpy(np.array(f["loss"])).double() - ref_loss).abs() / ref_loss.abs()
        if not (torch.isfinite(gap).all() and torch.isfinite(rel).all()):
            return bad
        topk = max(topk, float(gap.max()))
        loss = max(loss, float(rel.max()))
        rels.append(rel)
    return {"topk_max_abs": topk, "loss_mean_rel": float(torch.cat(rels).mean()),
            "loss_max_rel": loss}


def info_gap(kept: List[Dict], inputs, k: int, num_classes: int) -> float:
    """The widest gap between the loop's (Hit@1, PERR, loss) of a kept
    batch and the plain means over its packed rows: Hit@1 from the pool's
    labels at each row's first class, PERR and loss the rows' values,
    summed as the accumulator sums them (so a sound run reads 0)."""
    worst = 0.0
    for rec, b in zip(kept, inputs):
        if rec["info"] is None or rec["pack"] is None:
            return math.inf
        f = unpack(rec["pack"], k, num_classes)
        rows = np.arange(len(b["labels"]))
        plain = (float(np.average(b["labels"][rows, f["topk_idx"][:, 0]])),
                 float(np.sum(np.asarray(f["perr"]))) / len(rows),
                 float(np.mean(f["loss"])))
        for got, want in zip(rec["info"], plain):
            if not math.isfinite(got):
                return math.inf
            worst = max(worst, abs(got - want))
    return worst
