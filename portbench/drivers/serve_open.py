"""Open-loop serving: one `serving.Predictor` of the cell's tower (its
file's "tower", the student if not given; bf16, the configuration's
flags, `serve_batch` from the traffic) and one server
that calls `predict` in arrival order. Requests of `request_videos`
uint8 videos ([V, max_frames, D] host arrays and their lengths) come
from a pool made from the seed at set-up, on a schedule of due times at
the traffic's fixed rate; each request is timed from its due time to
`predict`'s return, so a stall delays the requests behind it.

Set-up warms the Predictor on a few requests. After the window the
reference computes the tower's predictions for a sample of the
window's requests drawn from the seed, the request with the most frames
among them, and the gaps are compared."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import harness
from portbench import traffic as traffic_lib
from portbench.drivers.eval_loop import prediction_gaps
from portbench.reference import model as ref_model
from portbench import weights as weights_lib


def build(ctx: harness.Context, quantize: str = "none"):
    from efficientvideoclassification_youtube8m_torch.serving import Predictor

    _, cfg = harness.program_config(ctx.flags, seed=harness.program_seed(ctx.seed),
                                    device=str(ctx.device))
    tower = ctx.spec.get("tower", "student")
    module = harness.program_towers(ctx, cfg, (tower,))[tower].eval()
    return Predictor(cfg, module, tower=tower, serve_batch=ctx.traffic["serve_batch"],
                     device=ctx.device, quantize=quantize)


def sampled(ctx: harness.Context, order: np.ndarray, pool: Dict, n: int) -> List[int]:
    """Indices of the window's requests to compare: a sample drawn from the
    seed, and the request with the most frames."""
    k = min(ctx.spec["check"]["requests"], n)
    pick = set(traffic_lib.rng(ctx.seed, 6).choice(n, size=k, replace=False).tolist())
    frames = pool["num_frames"].sum(1)[order[:n]]
    pick.add(int(np.argmax(frames)))
    return sorted(pick)


def run(ctx: harness.Context) -> harness.Outcome:
    predictor = build(ctx)
    ctx.mark("program")
    pool = traffic_lib.requests(ctx.traffic, ctx.flags, ctx.seed, str(ctx.device))
    ctx.mark("pool")
    due = traffic_lib.schedule(ctx.traffic, ctx.seconds, ctx.seed)
    n = len(due)
    r = pool["num_frames"].shape[0]
    order = np.resize(traffic_lib.rng(ctx.seed, 7).permutation(r), n)
    check = sampled(ctx, order, pool, n)
    for i in range(ctx.spec["warmup_requests"]):
        predictor.predict(pool["features"][i % r], pool["num_frames"][i % r])
    ctx.mark("warm_up")
    tracer = harness.tracer_for(ctx)
    harness.sync(ctx.device)
    harness.reset_peak(ctx.device)
    setup_s = ctx.clock()

    latency = np.full(n, math.inf)
    service = np.full(n, math.nan)
    kept: Dict[int, np.ndarray] = {}
    failed = 0
    keep = set(check)
    start = harness.begin_window(ctx, tracer)
    for i in range(n):
        if tracer is not None:
            tracer.poll()
        with harness.trace_lib.span("idle", ctx.trace):
            # a spin, not a sleep: a core woken from sleep starts slow, and
            # that would be the harness's delay, not the program's
            while time.perf_counter() < start + due[i]:
                pass
        t = time.perf_counter()
        q = order[i]
        try:
            with harness.trace_lib.span("predict", ctx.trace):
                out = predictor.predict(pool["features"][q], pool["num_frames"][q])
        except RuntimeError:
            failed += 1
            continue
        done = time.perf_counter()
        latency[i] = done - (start + due[i])
        service[i] = done - t
        if i in keep:
            kept[i] = out
    window_s = time.perf_counter() - start
    if tracer is not None:
        tracer.finish()
    peak = harness.memory_peak(ctx.device)
    summary = tracer.reduce() if tracer is not None else None
    del predictor
    harness.free(ctx.device)

    idx = [i for i in check if i in kept]
    requests = [int(order[i]) for i in idx]
    want = reference_predictions(ctx, pool, requests)
    gaps = prediction_gaps([torch.from_numpy(kept[i]) for i in idx], want)
    if len(idx) < len(check):
        gaps = {k: math.inf for k in gaps}
    return harness.Outcome(
        setup_s=setup_s, window_s=window_s, attempted=n, failed=failed,
        metrics={"serve_latency_p95_ms": float(np.percentile(latency, 95)) * 1e3},
        checks=harness.checks(ctx, gaps), memory_peak_bytes=peak, trace=summary,
        marks=ctx.marks,
        observed={"batch": ctx.traffic["request_videos"],
                  "steps": n - failed, "service_s": service[np.isfinite(service)],
                  "late_s": latency},
        numbers=gaps, kept={"pool": pool, "requests": requests, "want": want})


def control(ctx: harness.Context, out: harness.Outcome) -> Dict[str, Dict[str, float]]:
    """The numbers of the control: the program's own int8 Predictor on the
    kept requests, against the reference."""
    predictor = build(ctx, quantize="int8")
    pool = out.kept["pool"]
    got = [torch.from_numpy(predictor.predict(pool["features"][q], pool["num_frames"][q]))
           for q in out.kept["requests"]]
    return {"int8": prediction_gaps(got, out.kept["want"])}


def reference_predictions(ctx: harness.Context, pool: Dict, requests,
                          prec=ref_model.PLAIN) -> List[torch.Tensor]:
    ref_model.no_tf32()
    tower = ctx.spec.get("tower", "student")
    params = weights_lib.draw(ctx.flags, (tower,), ctx.seed, ctx.device)[tower]
    out = []
    with torch.no_grad():
        for q in requests:
            out.append(ref_model.predictions(
                params, torch.from_numpy(pool["features"][q]).to(ctx.device),
                torch.from_numpy(pool["num_frames"][q]).to(ctx.device), ctx.flags, tower,
                prec))
    return out
