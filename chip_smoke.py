#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from this checkout's sources (one
nvcc per source, started together), holds each against its plain
PyTorch version at the shapes its path gives it, serves the flagship
student through `Predictor`, trains the flagship by distillation through
`build_distill_train_step`, serves it int8 through
`Predictor(quantize="int8")`, runs the eval steps, and checks that the
recurrences of every path went through the kernels. A kernel's and a
plain version's time in phases 2, 5 and 7 is that of an eager call
(`cuda_ms`, CUDA events around repeated calls), as in earlier runs; the
kernel's device time alone, the replay of a CUDA graph of one call
(`graph_ms`), stands beside it. Phases:

  1. the card (nvidia-smi name and power limit), torch and CUDA
     versions, the kernels' build time and ptxas report (no spills), the
     data parser that runs (native, and where its library was built, or
     pure Python), and
     the SASS of the step kernels (`cuobjdump -sass`): each runs wgmma
     (HGMMA for bf16, IGMMA for int8) fed by TMA (UTMALDG) and no legacy
     mma.sync (HMMA, IMMA);
  2. `lstm_chunk_scan` against `lstm_chunk_scan_reference` in bf16 at the
     student and teacher layer shapes and a ragged one, with times, each
     beside its bound (ops/kernels/bounds.py), its share of the bound, its
     TFLOP/s and the earlier design's time from PERF.md;
  3. the student tower at the flagship config (TrainConfig defaults in
     bf16: D=1152, 2x1024 LSTMs, 4716 classes, MoE 2, every_n=10, 5
     chunks, random weights from a seed) serving requests of 256, 100
     and 513 videos; the launch count, the range of the predictions, the
     agreement with the plain-scan Predictor, and videos/s at batch 256;
  4. one teacher request (the T=15 and T=20 recurrences);
  5. `lstm_train_fwd` and `lstm_train_bwd` against their plain versions
     in bf16 at the four flagship train layer shapes (batch 256) and a
     ragged one, and `LstmLayerTrain` against plain autograd of
     `lstm_train_fwd_reference`, with times, bounds, shares, TFLOP/s and
     the earlier design's times beside them;
  6. distillation training at the flagship config: the loss and the
     gradients of `distill_loss_and_grads` on the kernel path against
     the plain-scan path from the same weights, three steps of
     `build_distill_train_step` (launch counts, finite losses, the
     global step, train videos/s on both paths), and one
     `build_finetune_step` step;
  7. `lstm_chunk_scan_int8` against `lstm_chunk_scan_int8_reference` at
     the layer shapes of phases 2 and 5, on inputs made as the int8 path
     makes them, with times and bounds, the step and quantize kernels one
     call launches (the profiler's count: 2T), the bf16 scan's times at
     the same shape beside them and the time of the Wh_q pack the wrapper
     makes once per weight tensor; then the kernel's quantize pass alone
     on rows made to sit on rounding ties (`near_tie_rows`), bit for bit
     against `quantize_rows_reference`;
  8. the flagship student through `Predictor(quantize="int8")` at
     serve_batch 256 on requests of 256, 100 and 513 videos: the int8
     launch count, the agreement with the plain int8 scan and the
     distance to the bf16 kernel path, one teacher request, int8 and bf16
     serving videos/s; then one batch of 256 through
     `build_quantized_eval_step` and `build_eval_step` on the kernel
     paths, their top-k overlap and PERR, and their host packs decoded;
     last, at lstm_cells 100, a width the wrappers zero-pad for TMA, a
     bf16 and an int8 `Predictor` serve through the kernels (exact launch
     counts) against the plain-scan Predictors, and the distill losses
     and gradients of the train kernels against the plain path;
  9. the five binaries through their `main(argv)`, each with the kernel
     counts set to 0 just before it and checked just after: (a)
     scripts/fidelity_check.py's run (10 synthetic videos a split at
     flagship widths, batch 5, its canonical flags and its bands against
     the reference's golden log), then validate, convert (the student
     bit-equal), finetune and eval in bf16 and int8 (epoch metrics within
     2e-3); (c) on 9a's finetuned student and validate shards the
     inference binaries, with exact launch counts: cli.infer bf16 (its
     rows against format_lines of Predictor.from_checkpoint's predictions
     of the same videos) and int8 (within 1e-3 of bf16),
     cli.inference_bias, cli.max_ensemble over the CSVs,
     cli.inspect_checkpoint (one row per leaf) and cli.hash_check; (b)
     cli.train at batch 256 over 512 videos x 2 epochs, its
     Examples/Second against phase 6's step rate, the checkpoint's size
     and save/restore seconds, cli.eval bf16 and int8 over 600 videos
     with the CLI's examples/s, then cli.infer bf16 and int8 in turns
     over 21 batches of 256 (videos/s from its own progress lines) beside
     cli.eval on the same shards. Data and checkpoints live under
     build/chip_smoke_pipeline/ and are removed at the end;
 10. the library yardstick at the four flagship layer shapes on
     full-length sequences: cuDNN's LSTM layer (`torch.nn.LSTM` with the
     layer's weights in cuDNN's gate order and the forget bias folded in;
     fp16, since this PyTorch gives cuDNN no bf16 RNN) in inference,
     training forward and training backward, beside the port's layer (the
     `x @ Wx` GEMM + `lstm_chunk_scan`; `LstmLayerTrain` forward and
     backward). The port never calls cuDNN;
 11. the convergence gate: the port's scripts/acceptance_run.py at its
     recipe (the flagship in bf16, 30 epochs at batch 128 over 2048
     learnable videos, 960 global steps, then 512 held-out videos)
     through cli.train and cli.validate; its bands decide (train GAP >=
     0.995 by step 700, held-out Hit@1 >= 0.95 and GAP >= 0.74), with the
     exact train-kernel launch counts. Last, no module of jax, flax,
     msgpack or the JAX package is loaded and nothing was written into
     the JAX package's directory.

Any failure raises, so the exit code is not 0. The line before the last
is {"kernels": [...]}; the last is {"ok": true, "device": {...}}. With no
CUDA device the script stops before it measures anything.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import io
import json
import logging
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import time

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch import data as port_data
from efficientvideoclassification_youtube8m_torch import ensemble
from efficientvideoclassification_youtube8m_torch.cli import convert as convert_cli
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import finetune as finetune_cli
from efficientvideoclassification_youtube8m_torch.cli import flags
from efficientvideoclassification_youtube8m_torch.cli import hash_check as hash_check_cli
from efficientvideoclassification_youtube8m_torch.cli import infer as infer_cli
from efficientvideoclassification_youtube8m_torch.cli import inference_bias as inference_bias_cli
from efficientvideoclassification_youtube8m_torch.cli import (
    inspect_checkpoint as inspect_checkpoint_cli,
)
from efficientvideoclassification_youtube8m_torch.cli import max_ensemble as max_ensemble_cli
from efficientvideoclassification_youtube8m_torch.cli import train as train_cli
from efficientvideoclassification_youtube8m_torch.cli import validate as validate_cli
from efficientvideoclassification_youtube8m_torch.data import native
from efficientvideoclassification_youtube8m_torch.metrics.eval_util import (
    train_step_metrics,
)
from efficientvideoclassification_youtube8m_torch.ops.kernels import _build
from efficientvideoclassification_youtube8m_torch.ops.kernels import bounds, layout
from efficientvideoclassification_youtube8m_torch.ops import prng, quantize
from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan
from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan_int8
from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_train
from efficientvideoclassification_youtube8m_torch.serving import (
    Predictor,
    TrainConfig,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.train import checkpoint, msgpack_io
from efficientvideoclassification_youtube8m_torch.train.optimizer import (
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.scripts import acceptance_run
from efficientvideoclassification_youtube8m_torch.train.step import (
    build_distill_train_step,
    build_eval_step,
    build_finetune_step,
    build_quantized_eval_step,
    distill_loss_and_grads,
)

CSRC = "efficientvideoclassification_youtube8m_torch/ops/csrc/"
PALLAS = "efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py:"
LIBRARIES = ("lstm_chunk_scan", "lstm_train", "lstm_chunk_scan_int8")

# Kernel against plain version, both on bf16 operands with f32 sums: the
# sums run in another order, so a bf16 output can round an ulp or two
# apart (2**-8 relative, |h| < 1; 2e-3 measured on an H100), and the f32
# finals drift by the gates' summation error carried over T steps
# (1.4e-4 measured). The bounds leave a margin of 5x and more.
TOL_OUTS = 1e-2
TOL_FINALS = 2e-3
# Predictor with the kernel against Predictor with the plain bf16 scan:
# the same differences carried through both levels and the MoE head
# (5.4e-6 measured).
TOL_PREDICTIONS = 1e-3
# Train kernels against their plain versions, on the same bf16 operands
# (measured on an H100 in brackets): the forward's f32 residuals differ
# by the gates' summation order, like the finals above (2.2e-4); dgates
# are bf16, so an element can round one bf16 ulp apart after the f32 dh
# chain ran in another order (2.9e-3 of the max); gradients through
# LstmLayerTrain are compared as the largest difference over the
# tensor's largest magnitude, at tests/test_pallas_lstm.py's bar (3.1e-3:
# the plain autograd rounds dh to bf16 every step, the kernel keeps it
# at about f32 by the hi/lo split).
TOL_TRAIN_F32 = 2e-3
TOL_DGATES_REL = 1e-2
TOL_GRAD_REL = 3e-2
# Distill losses, kernel path against plain path: the forwards differ by
# summation order only (8e-4 relative on L_PRED, a batch sum of nearly
# cancelling terms; 6e-6 or less elsewhere).
TOL_LOSS_REL = 1e-3
TOL_LOSS_ABS = 1e-5
# int8 kernel against its plain version on the same inputs: both take
# true quotients, round half to even and sum exactly, and the kernel
# rounds every gate and cell operation where the plain version does, so
# they differ only where a transcendental of the card's library lands an
# ulp apart. Such an ulp can flip a rounding tie of h_q, which moves a gate
# by about max|h| * max|Wh| / 127 (2.4e-4 at the flagship's glorot
# weights); the bf16 kernel's bounds (1e-2 on bf16 outs, 2e-3 on the f32
# finals) cover a few of those carried over T steps.
TOL_INT8_OUTS = 1e-2
TOL_INT8_FINALS = 2e-3

# (name, T, B, H, D_in): the layers of the flagship at batch 256, in
# serving (serve_batch) and in training (batch_size). L1 folds 5 (student) or 20 (teacher) chunks into the batch axis;
# D_in is the input width of the level's first layer.
LAYER_SHAPES = [
    ("student_L1", 6, 1280, 1024, 1152),
    ("student_L2", 5, 256, 1024, 4096),
    ("teacher_L1", 15, 5120, 1024, 1152),
    ("teacher_L2", 20, 256, 1024, 4096),
    ("ragged", 7, 13, 48, 40),
    ("single_step", 1, 9, 16, 24),  # the train backward's prologue alone
    ("odd_width", 5, 24, 100, 40),  # H the wrappers zero-pad (104 bf16, 112 int8)
]
SERVE_BATCH = 256
FLAGSHIP_SHAPES = [s for s in LAYER_SHAPES if s[0].startswith(("student", "teacher"))]
# Times of the earlier designs at the flagship layer shapes, from
# PERF.md's kernel table (eager calls timed by CUDA events on an NVIDIA
# H100 80GB HBM3 at 700 W): the WMMA step kernels of the bf16 serving and
# train paths, and the WMMA int8 kernel. Printed beside this run's times
# for the reader; one call cannot run both designs.
EARLIER_MS = {
    "lstm_chunk_scan": {"student_L1": 0.6686},
    "lstm_train_fwd": {"student_L1": 0.7333, "student_L2": 0.1737,
                       "teacher_L1": 6.2563, "teacher_L2": 0.6449},
    "lstm_train_bwd": {"student_L1": 1.3615, "student_L2": 0.3591,
                       "teacher_L1": 13.0186, "teacher_L2": 1.5155},
    "lstm_chunk_scan_int8": {"student_L1": 0.8368, "student_L2": 0.2060,
                             "teacher_L1": 7.4173, "teacher_L2": 0.8676},
}
# The step kernels, by library: each must run wgmma (the first opcode)
# fed by TMA and no legacy mma.sync (the second).
STEP_KERNELS = {"lstm_chunk_scan": (("lstm_step_kernel", "HGMMA", "HMMA"),),
                "lstm_train": (("lstm_step_kernel", "HGMMA", "HMMA"),
                               ("lstm_bwd_step_kernel", "HGMMA", "HMMA")),
                "lstm_chunk_scan_int8": (("lstm_int8_step_kernel", "IGMMA", "IMMA"),)}
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")
NO_SPILLS = "0 bytes spill stores, 0 bytes spill loads"


def log(*parts) -> None:
    print(*parts, flush=True)


def against_bound(kernel: str, name: str, T: int, B: int, H: int, ms: float,
                  replay_ms: float) -> str:
    """The eager call's `ms` beside the kernel's bound at (T, B, H), its
    share of the bound, its operation rate and the earlier design's eager
    time where PERF.md has one; then the share of the graph replay's
    `replay_ms`."""
    b = bounds.achieved(kernel, T, B, H, ms)
    unit = "TOP/s" if kernel.endswith("int8") else "TFLOP/s"
    text = (f"{kernel} {ms:.4f} ms, bound {b['ms']:.4f} ms ({b['bound_by']}), "
            f"{b['share']:.3f} of it, {b['rate']:.1f} {unit}")
    earlier = EARLIER_MS[kernel]
    if name in earlier:
        text += f"; earlier {earlier[name]:.4f} ms ({earlier[name] / ms:.2f}x)"
    return text + f"; graph replay {replay_ms:.4f} ms, {b['ms'] / replay_ms:.3f} of the bound"


def cuda_ms(fn, iters: int) -> float:
    """Mean time of `fn` over `iters` runs, after a warm-up, by CUDA events
    around the runs: device time where the card is the limit, the host's
    time per call where the host is."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of one call of `fn`: the call is captured once in a
    CUDA graph and the graph replayed `iters` times between CUDA events,
    so the host's own time per call (Python, the wrapper's checks and
    allocations) stays out. At the B=256 layers an eager call's time is
    mostly the host's. Reported beside `cuda_ms`, never in its place."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return cuda_ms(graph.replay, iters)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1] card: {smi}")
    log(f"[1] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build(LIBRARIES)
    lstm_scan.load_kernel()
    lstm_train.load_kernel()
    lstm_scan_int8.load_kernel()
    log(f"[1] kernel builds (parallel) + load: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    if native.available():
        log(f"[1] data parser: native (g++), {native.loaded_path()}, built or loaded "
            f"in {time.perf_counter() - t0:.3f} s")
    else:
        log("[1] data parser: pure Python (the native library did not build)")
    spills = []
    for name in LIBRARIES:
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[1] ptxas {name}: {line.strip()}")
            if "spill" in line and NO_SPILLS not in line:
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError("ptxas reports spills: " + "; ".join(spills))
    for lib, kernels in STEP_KERNELS.items():
        counts = _build.sass_counts(lib, SASS_OPS)
        for kernel, mma, legacy in kernels:
            found = {fn: c for fn, c in counts.items() if kernel in fn}
            for fn, c in found.items():
                log(f"[1] sass {lib} {fn}: " + ", ".join(f"{op} {n}" for op, n in c.items()))
            if not found or not all(c[mma] and c["UTMALDG"] and not c[legacy]
                                    for c in found.values()):
                raise AssertionError(f"{lib}: {kernel} is not a TMA-fed wgmma kernel")
    return smi


def layer_case(T, B, H, D, gen):
    """Inputs of one layer as the serving path makes them: x @ Wx in bf16
    (unit-norm rows of x, glorot weights), Wh, a bias, and sequence
    lengths holding 0, T and mixed values."""
    limit = math.sqrt(6.0 / (D + H + 4 * H))
    x = torch.randn(T, B, D, generator=gen) / math.sqrt(D)
    w_x = (torch.rand(D, 4 * H, generator=gen) * 2 - 1) * limit
    w_h = (torch.rand(H, 4 * H, generator=gen) * 2 - 1) * limit
    bias = torch.randn(4 * H, generator=gen) * 0.1
    seq = torch.randint(0, T + 1, (B,), generator=gen, dtype=torch.int32)
    seq[0], seq[-1] = 0, T
    dev = "cuda"
    xp = torch.matmul(x.to(dev).bfloat16(), w_x.to(dev).bfloat16()).contiguous()
    return xp, w_h.to(dev).bfloat16(), bias.to(dev), seq.to(dev)


def phase_kernel():
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    times = {}
    for name, T, B, H, D in LAYER_SHAPES:
        args = layer_case(T, B, H, D, gen)
        outs, c, h = lstm_scan.lstm_chunk_scan(*args)
        r_outs, r_c, r_h = lstm_scan.lstm_chunk_scan_reference(*args)
        torch.cuda.synchronize()
        seq = args[3]
        past = torch.arange(T, device="cuda")[:, None] >= seq[None, :]
        zeros_past_seq = bool((outs[past] == 0).all())
        empty = seq == 0
        zero_state = bool((c[empty] == 0).all() and (h[empty] == 0).all())
        err = {
            "outs": (outs.float() - r_outs.float()).abs().max().item(),
            "c_fin": (c - r_c).abs().max().item(),
            "h_fin": (h - r_h).abs().max().item(),
        }
        iters = 20 if B >= 256 else 5
        ms = cuda_ms(lambda: lstm_scan.lstm_chunk_scan(*args), iters)
        replay_ms = graph_ms(lambda: lstm_scan.lstm_chunk_scan(*args), iters)
        plain_ms = cuda_ms(lambda: lstm_scan.lstm_chunk_scan_reference(*args), iters)
        times[name] = (ms, replay_ms, plain_ms)
        log(f"[2] {name} T={T} B={B} H={H}: max|diff| outs {err['outs']:.3g} "
            f"c_fin {err['c_fin']:.3g} h_fin {err['h_fin']:.3g}; "
            f"zeros past seq {zeros_past_seq}, zero state at seq 0 {zero_state}; "
            f"kernel {ms:.4f} ms (graph replay {replay_ms:.4f}), plain {plain_ms:.4f} ms")
        if (name, T, B, H, D) in FLAGSHIP_SHAPES:
            log(f"[2] {name}: " + against_bound("lstm_chunk_scan", name, T, B, H, ms,
                                                replay_ms))
        if not (zeros_past_seq and zero_state):
            raise AssertionError(f"{name}: masking is wrong")
        if not all(map(math.isfinite, err.values())):
            raise AssertionError(f"{name}: non-finite difference {err}")
        if err["outs"] > TOL_OUTS or max(err["c_fin"], err["h_fin"]) > TOL_FINALS:
            raise AssertionError(f"{name}: kernel and plain version disagree: {err}")
        worst = max(worst, *err.values())
    log(f"[2] tolerances: outs {TOL_OUTS}, finals {TOL_FINALS}")
    return worst, times


def requests(sizes, cfg, seed):
    rng = np.random.default_rng(seed)
    for n in sizes:
        feats = rng.integers(0, 256, (n, cfg.max_num_frames, cfg.total_feature_size),
                             dtype=np.uint8)
        yield feats, rng.integers(1, cfg.max_num_frames + 1, n).astype(np.int32)


def check_predictions(probs, n, num_classes, what):
    if probs.shape != (n, num_classes):
        raise AssertionError(f"{what}: shape {probs.shape}")
    if not np.all(np.isfinite(probs)) or probs.min() < 0 or probs.max() > 1:
        raise AssertionError(f"{what}: predictions not finite in [0, 1]")


def videos_per_s(predictor, feats, nf, repeats=3):
    predictor.predict(feats[:SERVE_BATCH], nf[:SERVE_BATCH])  # warm-up
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        predictor.predict(feats, nf)  # ends in the copy to the host
        rates.append(len(nf) / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2]


def phase_serving(smi):
    cfg = TrainConfig(compute_dtype="bfloat16")
    model = init_model(cfg, prng.prng_key(0), device="cuda")
    kernel_p = Predictor(cfg, model, serve_batch=SERVE_BATCH, device="cuda")
    plain_p = Predictor(cfg.replace(use_pallas_inference=False), model,
                        serve_batch=SERVE_BATCH, device="cuda")
    sizes = (256, 100, 513)
    batches = list(requests(sizes, cfg, seed=1))
    levels = 2 * cfg.lstm_layers  # wrapper calls per served chunk
    expected = levels * sum(math.ceil(n / SERVE_BATCH) for n in sizes)

    lstm_scan.lstm_chunk_scan.launches = 0
    served = [kernel_p.predict(feats, nf) for feats, nf in batches]
    torch.cuda.synchronize()
    launches = lstm_scan.lstm_chunk_scan.launches
    log(f"[3] student served {sizes}: {launches} kernel launches "
        f"(expected {expected})")
    if launches != expected:
        raise AssertionError(f"the kernel ran {launches} times, not {expected}")

    worst = 0.0
    for (feats, nf), probs in zip(batches, served):
        check_predictions(probs, len(nf), cfg.num_classes, "student")
        worst = max(worst, float(np.abs(probs - plain_p.predict(feats, nf)).max()))
    log(f"[3] predictions finite in [0, 1]; max|kernel - plain scan| {worst:.3g} "
        f"(tolerance {TOL_PREDICTIONS})")
    if worst > TOL_PREDICTIONS:
        raise AssertionError("the kernel path and the plain path disagree")

    feats, nf = next(requests((8 * SERVE_BATCH,), cfg, seed=2))
    rate = videos_per_s(kernel_p, feats, nf)
    plain_rate = videos_per_s(plain_p, feats, nf)
    log(f"[3] student bf16 serving, serve_batch {SERVE_BATCH}, {len(nf)} videos "
        f"per predict: kernel {rate:.1f} videos/s, plain scan {plain_rate:.1f} "
        f"videos/s ({smi})")

    teacher_k = Predictor(cfg, model, tower="teacher", serve_batch=SERVE_BATCH,
                          device="cuda")
    teacher_p = Predictor(cfg.replace(use_pallas_inference=False), model,
                          tower="teacher", serve_batch=SERVE_BATCH, device="cuda")
    feats, nf = next(requests((64,), cfg, seed=3))
    before = lstm_scan.lstm_chunk_scan.launches
    probs = teacher_k.predict(feats, nf)
    if lstm_scan.lstm_chunk_scan.launches - before != levels * math.ceil(64 / SERVE_BATCH):
        raise AssertionError("the teacher did not run through the kernel")
    check_predictions(probs, len(nf), cfg.num_classes, "teacher")
    t_err = float(np.abs(probs - teacher_p.predict(feats, nf)).max())
    log(f"[4] teacher served 64: predictions finite in [0, 1]; "
        f"max|kernel - plain scan| {t_err:.3g} (tolerance {TOL_PREDICTIONS})")
    if t_err > TOL_PREDICTIONS:
        raise AssertionError("the teacher's kernel and plain paths disagree")
    return launches


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| over max|want| (over 1 where want is all zero)."""
    scale = want.abs().max().item() or 1.0
    return (got.float() - want.float()).abs().max().item() / scale


def train_layer_case(T, B, H, D, gen):
    """One layer as the train path gives it: xs [B, T, D] at unit-norm
    scale, the full glorot kernel [D+H, 4H] f32, a bias, sequence lengths
    holding 0, T and mixed values, and cotangents of (outs as bf16
    values, c_fin, h_fin)."""
    dev = "cuda"
    limit = math.sqrt(6.0 / (D + H + 4 * H))
    xs = torch.randn(B, T, D, generator=gen, device=dev) / math.sqrt(D)
    kernel = (torch.rand(D + H, 4 * H, generator=gen, device=dev) * 2 - 1) * limit
    bias = torch.randn(4 * H, generator=gen, device=dev) * 0.1
    seq = torch.randint(0, T + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    seq[0], seq[-1] = 0, T
    cot = (torch.randn(T, B, H, generator=gen, device=dev).bfloat16().float(),
           torch.randn(B, H, generator=gen, device=dev),
           torch.randn(B, H, generator=gen, device=dev))
    return xs, kernel, bias, seq, cot


def layer_grads(xs, kernel, bias, seq, cot, use_kernel):
    """d loss / d (kernel, bias, xs) of loss = <outs, d_outs> + <c_fin,
    d_c> + <h_fin, d_h>, through LstmLayerTrain or through plain autograd
    of lstm_train_fwd_reference."""
    k, b, x = (t.clone().requires_grad_(True) for t in (kernel, bias, xs))
    D = xs.shape[-1]
    if use_kernel:
        outs, c, h = lstm_train.LstmLayerTrain.apply(k, b, x, seq, 1.0)
        outs = outs.transpose(0, 1)
    else:
        xp = torch.matmul(x.transpose(0, 1).bfloat16(), k[:D].bfloat16())
        outs, _, _, c, h = lstm_train.lstm_train_fwd_reference(xp, k[D:], b, seq)
    d_outs, d_c, d_h = cot
    loss = (outs.float() * d_outs).sum() + (c * d_c).sum() + (h * d_h).sum()
    return torch.autograd.grad(loss, (k, b, x))


def phase_train_kernels():
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = {"fwd": 0.0, "bwd": 0.0}
    times = {}
    for name, T, B, H, D in LAYER_SHAPES:
        xs, kernel, bias, seq, cot = train_layer_case(T, B, H, D, gen)
        xp = torch.matmul(xs.transpose(0, 1).bfloat16(), kernel[:D].bfloat16())
        w_h = kernel[D:]
        got = lstm_train.lstm_train_fwd(xp, w_h, bias, seq)
        want = lstm_train.lstm_train_fwd_reference(xp, w_h, bias, seq)
        torch.cuda.synchronize()
        fwd_err = {key: (g.float() - w.float()).abs().max().item()
                   for key, g, w in zip(("outs", "gates", "cs", "c_fin", "h_fin"),
                                        got, want)}
        past = torch.arange(T, device="cuda")[:, None] >= seq[None, :]
        zeros_past_seq = bool((got[0][past] == 0).all())

        gates, cs = got[1], got[2]
        dg = lstm_train.lstm_train_bwd(w_h, gates, cs, *cot, seq)
        dg_ref = lstm_train.lstm_train_bwd_reference(w_h, gates, cs, *cot, seq)
        torch.cuda.synchronize()
        dg_abs = (dg.float() - dg_ref.float()).abs().max().item()
        dg_rel = rel_err(dg, dg_ref)

        grads_k = layer_grads(xs, kernel, bias, seq, cot, use_kernel=True)
        grads_p = layer_grads(xs, kernel, bias, seq, cot, use_kernel=False)
        grad_err = {key: rel_err(g, w) for key, g, w in
                    zip(("d_kernel", "d_bias", "d_xs"), grads_k, grads_p)}
        del grads_k, grads_p

        iters = 10 if B >= 256 else 5
        args = (xp, w_h, bias, seq)
        bwd_args = (w_h, gates, cs, *cot, seq)
        ms = {
            "fwd": cuda_ms(lambda: lstm_train.lstm_train_fwd(*args), iters),
            "fwd_graph": graph_ms(lambda: lstm_train.lstm_train_fwd(*args), iters),
            "fwd_plain": cuda_ms(lambda: lstm_train.lstm_train_fwd_reference(*args), iters),
            "bwd": cuda_ms(lambda: lstm_train.lstm_train_bwd(*bwd_args), iters),
            "bwd_graph": graph_ms(lambda: lstm_train.lstm_train_bwd(*bwd_args), iters),
            "bwd_plain": cuda_ms(lambda: lstm_train.lstm_train_bwd_reference(*bwd_args), iters),
        }
        times[name] = ms
        log(f"[5] {name} T={T} B={B} H={H}: fwd max|diff| "
            + " ".join(f"{k} {v:.3g}" for k, v in fwd_err.items())
            + f"; zeros past seq {zeros_past_seq}; bwd dgates max|diff| {dg_abs:.3g} "
            f"({dg_rel:.3g} of max); LstmLayerTrain vs plain autograd, max|diff| "
            "of max: " + " ".join(f"{k} {v:.3g}" for k, v in grad_err.items()))
        log(f"[5] {name}: fwd kernel {ms['fwd']:.4f} ms (graph replay "
            f"{ms['fwd_graph']:.4f}), plain {ms['fwd_plain']:.4f} ms; bwd kernel "
            f"{ms['bwd']:.4f} ms (graph replay {ms['bwd_graph']:.4f}), plain "
            f"{ms['bwd_plain']:.4f} ms")
        if (name, T, B, H, D) in FLAGSHIP_SHAPES:
            for kernel, key in (("lstm_train_fwd", "fwd"), ("lstm_train_bwd", "bwd")):
                log(f"[5] {name}: " + against_bound(kernel, name, T, B, H, ms[key],
                                                    ms[key + "_graph"]))
        checks = [*fwd_err.values(), dg_abs, dg_rel, *grad_err.values()]
        if not all(map(math.isfinite, checks)):
            raise AssertionError(f"{name}: non-finite difference")
        if not zeros_past_seq:
            raise AssertionError(f"{name}: outs past seq are not zero")
        if fwd_err["outs"] > TOL_OUTS or max(
                fwd_err[k] for k in ("gates", "cs", "c_fin", "h_fin")) > TOL_TRAIN_F32:
            raise AssertionError(f"{name}: train fwd kernel and plain version disagree")
        if dg_rel > TOL_DGATES_REL:
            raise AssertionError(f"{name}: train bwd kernel and plain version disagree")
        if max(grad_err.values()) > TOL_GRAD_REL:
            raise AssertionError(f"{name}: LstmLayerTrain and plain autograd disagree")
        worst["fwd"] = max(worst["fwd"], *fwd_err.values())
        worst["bwd"] = max(worst["bwd"], dg_abs)
        del xs, kernel, xp, got, want, gates, cs, dg, dg_ref
    log(f"[5] tolerances: bf16 outs {TOL_OUTS}, f32 residuals and finals "
        f"{TOL_TRAIN_F32}, dgates {TOL_DGATES_REL} of max, gradients "
        f"{TOL_GRAD_REL} of max")
    return worst, times


def distill_batch(cfg, n, seed):
    """n uint8 videos [n, 300, 1152] with num_frames in 1..300 and about
    3 labels a row, on the card."""
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, (n, cfg.max_num_frames, cfg.total_feature_size),
                         dtype=np.uint8)
    labels = rng.random((n, cfg.num_classes)) < 3.0 / cfg.num_classes
    nf = rng.integers(1, cfg.max_num_frames + 1, n).astype(np.int32)
    return tuple(torch.from_numpy(a).cuda() for a in (feats, labels, nf))


def train_counts():
    return (lstm_train.lstm_train_fwd.launches, lstm_train.lstm_train_bwd.launches)


def timed_step(step, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, *batch)
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0


# Kinds of device work in a distill step, by kernel name; the first that
# matches wins, the rest is "other elementwise".
STEP_KINDS = (
    ("train backward kernels", ("lstm_bwd",)),
    ("train forward kernel", ("lstm_step_kernel",)),
    ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "splitK")),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    ("reductions", ("reduce",)),
)


def profile_distill_step(step, state, batch, smi) -> None:
    """One distill step under torch.profiler: wall time, device time and
    busy share, device time by kind (STEP_KINDS) and the largest kernels.
    The step advances `state` like any other."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {evt.key: evt.self_device_time_total / 1e3 for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and evt.self_device_time_total > 0}
    kinds = dict.fromkeys([kind for kind, _ in STEP_KINDS] + ["other elementwise"], 0.0)
    for name, ms in kernels.items():
        kind = next((k for k, keys in STEP_KINDS if any(s in name for s in keys)),
                    "other elementwise")
        kinds[kind] += ms
    device_ms = sum(kernels.values())
    log(f"[6] distill step under torch.profiler: wall {wall_ms:.1f} ms, device "
        f"{device_ms:.1f} ms (busy {device_ms / wall_ms:.3f}); by kind: " + "; ".join(
            f"{k} {v:.1f} ms ({v / max(device_ms, 1e-9):.3f})" for k, v in kinds.items())
        + f" ({smi})")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[6]   {ms:8.3f} ms  {name[:110]}")


def phase_distill(smi):
    cfg = TrainConfig(compute_dtype="bfloat16")
    B = cfg.batch_size
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt, prng.prng_key(0),
                               device="cuda")
    batch = distill_batch(cfg, B, seed=6)
    per_tower = 2 * cfg.lstm_layers  # train kernel launches of each kind

    k_ls, _, k_gt, k_gs = distill_loss_and_grads(cfg, state, *batch)
    p_ls, _, p_gt, p_gs = distill_loss_and_grads(cfg, state, *batch,
                                                 kernel_train_mode="off")
    loss_bad = [k for k in k_ls if abs(k_ls[k].item() - p_ls[k].item())
                > TOL_LOSS_REL * abs(p_ls[k].item()) + TOL_LOSS_ABS]
    log("[6] distill losses, kernel path / plain path: " + "; ".join(
        f"{k} {k_ls[k].item():.6g} / {p_ls[k].item():.6g}" for k in k_ls))
    grad_err = {f"{tower}.{n}": rel_err(g[n], p[n])
                for tower, g, p in (("teacher", k_gt, p_gt), ("student", k_gs, p_gs))
                for n in g}
    top = sorted(grad_err.items(), key=lambda kv: -kv[1])
    log(f"[6] gradients, kernel path vs plain path, max|diff| of max over "
        f"{len(grad_err)} tensors: worst " + ", ".join(
            f"{n} {v:.3g}" for n, v in top[:4]) + f"; median "
        f"{float(np.median(list(grad_err.values()))):.3g} (tolerances: losses "
        f"{TOL_LOSS_REL} relative + {TOL_LOSS_ABS}, gradients {TOL_GRAD_REL})")
    if loss_bad or not all(math.isfinite(v) for v in grad_err.values()):
        raise AssertionError(f"kernel and plain distill losses disagree: {loss_bad}")
    if top[0][1] > TOL_GRAD_REL:
        raise AssertionError(f"kernel and plain distill gradients disagree: {top[:4]}")
    del k_gt, k_gs, p_gt, p_gs

    step = build_distill_train_step(cfg, opt)
    lstm_scan.lstm_chunk_scan.launches = 0
    lstm_train.lstm_train_fwd.launches = 0
    lstm_train.lstm_train_bwd.launches = 0
    seconds = []
    for i in range(3):
        before = train_counts()
        state, metrics, sec = timed_step(step, state, batch)
        seconds.append(sec)
        delta = [a - b for a, b in zip(train_counts(), before)]
        losses = {k: metrics[k].item() for k in k_ls}
        log(f"[6] distill step {i + 1}: {sec * 1e3:.1f} ms, train launches "
            f"fwd {delta[0]} bwd {delta[1]}, teacher_label_loss "
            f"{losses['teacher_label_loss']:.6g}, total_student_loss "
            f"{losses['total_student_loss']:.6g}, lr {metrics['learning_rate'].item():.6g}")
        if delta != [2 * per_tower, 2 * per_tower]:
            raise AssertionError(f"a distill step made {delta} train launches, "
                                 f"not {2 * per_tower} of each")
        if not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"non-finite distill losses {losses}")
    launches = train_counts()
    if lstm_scan.lstm_chunk_scan.launches or state.global_step != 6:
        raise AssertionError("training used the forward-only kernel, or the "
                             f"global step is {state.global_step}, not 6")
    host = train_step_metrics(metrics["topk_val"].cpu().numpy(),
                              metrics["topk_idx"].cpu().numpy(),
                              batch[1].cpu().numpy(),
                              metrics["perr_precision"].cpu().numpy())
    log(f"[6] global_step {state.global_step}; teacher metrics of step 3: "
        + ", ".join(f"{k} {v:.4g}" for k, v in host.items()))
    if not all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in host.values()):
        raise AssertionError(f"teacher metrics out of [0, 1]: {host}")
    rate = B / float(np.median(seconds[1:]))
    profile_distill_step(step, state, batch, smi)

    plain_step = build_distill_train_step(cfg, opt, kernel_train_mode="off")
    before = train_counts()
    plain_seconds = [timed_step(plain_step, state, batch)[2] for _ in range(3)]
    if train_counts() != before:
        raise AssertionError("the plain path launched a train kernel")
    plain_rate = B / float(np.median(plain_seconds[1:]))
    log(f"[6] distill train, batch {B}, bf16: kernel path {rate:.1f} videos/s "
        f"(step {np.median(seconds[1:]) * 1e3:.1f} ms), plain path "
        f"{plain_rate:.1f} videos/s (step {np.median(plain_seconds[1:]) * 1e3:.1f} ms); "
        f"median of steps 2-3; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB ({smi})")

    sstate = student_state_from_distill(state, opt)
    finetune = build_finetune_step(cfg, opt)
    before = train_counts()
    sstate, fmetrics, sec = timed_step(finetune, sstate, batch)
    delta = [a - b for a, b in zip(train_counts(), before)]
    ce = fmetrics["student_label_loss"].item()
    log(f"[6] finetune step: {sec * 1e3:.1f} ms, train launches fwd {delta[0]} "
        f"bwd {delta[1]}, student_label_loss {ce:.6g}, global_step {sstate.global_step}")
    if delta != [per_tower, per_tower] or not math.isfinite(ce) or sstate.global_step != 1:
        raise AssertionError("the finetune step did not run through the train kernels")
    return launches, rate


def int8_layer_case(T, B, H, D, gen):
    """Inputs of one layer as the int8 path makes them: the int8 product
    of unit-norm rows of x and glorot weights quantized per column, stored
    bf16; Wh quantized the same way; a bias; sequence lengths holding 0, T
    and mixed values."""
    dev = "cuda"
    limit = math.sqrt(6.0 / (D + H + 4 * H))
    x = torch.randn(T, B, D, generator=gen, device=dev)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    w_x = (torch.rand(D, 4 * H, generator=gen, device=dev) * 2 - 1) * limit
    w_h = (torch.rand(H, 4 * H, generator=gen, device=dev) * 2 - 1) * limit
    bias = torch.randn(4 * H, generator=gen, device=dev) * 0.1
    seq = torch.randint(0, T + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    seq[0], seq[-1] = 0, T
    wx_q, wx_s = quantize.quantize_weight(w_x)
    wh_q, wh_s = quantize.quantize_weight(w_h)
    xp = quantize.int8_dot(x, wx_q, wx_s).to(torch.bfloat16)
    return xp, wh_q, wh_s, bias, seq


def near_tie_rows(width: int = 1024) -> torch.Tensor:
    """Rows of h [N, width] f32 (CPU) on which the int8 kernel's quantize
    must take its true-quotient fallback: random rows at the scales the
    model gives, and rows of values placed on, and a few ulps around,
    every half-way point n + 1/2 of the scale s, each row holding 127 s
    so that its scale is about s. tests/test_torch_kernel_layout.py holds
    the kernel's rule (read from its source) against them on the CPU;
    phase 7 holds the kernel itself against them."""
    rng = np.random.default_rng(0)
    rows = [np.tanh(rng.standard_normal(width) * s) for s in (0.01, 0.3, 1.0, 3.0)]
    rows += [rng.standard_normal(width) * 1e-6, np.zeros(width)]
    for s in (7.3e-3, 1.0 / 127, 0.0063):
        half = (np.arange(-127, 127) + 0.5) * s
        values = np.concatenate([half, half * (1 + 2e-7), half * (1 - 2e-7),
                                 np.nextafter(half.astype(np.float32), np.inf),
                                 np.nextafter(half.astype(np.float32), -np.inf)])
        for i in range(0, len(values), width - 1):
            chunk = values[i:i + width - 1]
            rows.append(np.concatenate([chunk, [127 * s], np.zeros(width - 1 - len(chunk))]))
    return torch.from_numpy(np.stack(rows).astype(np.float32))


INT8_STEP_KERNELS = ("lstm_int8_step_kernel", "quantize_rows_kernel")


def kernels_per_call(fn) -> int:
    """The int8 step and quantize kernels one call of `fn` launches, by
    torch.profiler's CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and any(k in evt.key for k in INT8_STEP_KERNELS))


def phase_int8_kernel():
    """The int8 kernel against its plain version at every layer shape; at
    the flagship shapes its times beside the bf16 scan's at the same
    shape; its quantize pass on rows made to sit on rounding ties."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    times = {}
    for name, T, B, H, D in LAYER_SHAPES:
        args = int8_layer_case(T, B, H, D, gen)
        tile = layout.int8_tile(B, layout.tma_width(H, 1))
        r_outs, r_c, r_h = lstm_scan_int8.lstm_chunk_scan_int8_reference(*args)
        seq = args[4]
        past = torch.arange(T, device="cuda")[:, None] >= seq[None, :]
        empty = seq == 0
        outs, c, h = lstm_scan_int8.lstm_chunk_scan_int8(*args)
        torch.cuda.synchronize()
        zeros_past_seq = bool((outs[past] == 0).all())
        zero_state = bool((c[empty] == 0).all() and (h[empty] == 0).all())
        err = {
            "outs": (outs.float() - r_outs.float()).abs().max().item(),
            "c_fin": (c - r_c).abs().max().item(),
            "h_fin": (h - r_h).abs().max().item(),
        }
        log(f"[7] {name} T={T} B={B} H={H}, tile {tile[0]}x{tile[1]}: max|diff| outs "
            f"{err['outs']:.3g} c_fin {err['c_fin']:.3g} h_fin {err['h_fin']:.3g}; zeros "
            f"past seq {zeros_past_seq}, zero state at seq 0 {zero_state}")
        if not (zeros_past_seq and zero_state):
            raise AssertionError(f"{name}: int8 masking is wrong")
        if not all(map(math.isfinite, err.values())):
            raise AssertionError(f"{name}: non-finite difference {err}")
        if err["outs"] > TOL_INT8_OUTS or max(err["c_fin"], err["h_fin"]) > TOL_INT8_FINALS:
            raise AssertionError(f"{name}: int8 kernel and plain version disagree: {err}")
        per_call = kernels_per_call(lambda: lstm_scan_int8.lstm_chunk_scan_int8(*args))
        log(f"[7] {name}: one call launches {per_call} step and quantize kernels "
            f"(T={T}: 2T)")
        if per_call != 2 * T:
            raise AssertionError(f"{name}: {per_call} kernels a call, not {2 * T}")
        iters = 20 if B >= 256 else 5
        ms = cuda_ms(lambda: lstm_scan_int8.lstm_chunk_scan_int8(*args), iters)
        replay_ms = graph_ms(lambda: lstm_scan_int8.lstm_chunk_scan_int8(*args), iters)
        plain_ms = cuda_ms(lambda: lstm_scan_int8.lstm_chunk_scan_int8_reference(*args),
                           iters)
        times[name] = (ms, replay_ms, plain_ms)
        log(f"[7] {name}: kernel {ms:.4f} ms (graph replay {replay_ms:.4f}), plain "
            f"{plain_ms:.4f} ms")
        if (name, T, B, H, D) in FLAGSHIP_SHAPES:
            xp, wh_q, wh_s, bias, _ = args
            bf16_args = (xp, (wh_q.float() * wh_s).bfloat16(), bias, seq)
            b_ms = cuda_ms(lambda: lstm_scan.lstm_chunk_scan(*bf16_args), iters)
            b_replay = graph_ms(lambda: lstm_scan.lstm_chunk_scan(*bf16_args), iters)
            log(f"[7] {name}: " + against_bound("lstm_chunk_scan_int8", name, T, B, H, ms,
                                                replay_ms))
            log(f"[7] {name}: bf16 scan at this shape {b_ms:.4f} ms (graph replay "
                f"{b_replay:.4f}); int8 / bf16: eager {ms / b_ms:.3f}, replay "
                f"{replay_ms / b_replay:.3f}")
            if name == "student_L1":
                pack_ms = cuda_ms(lambda: layout.pack_wh(wh_q, tile[1]), iters)
                log(f"[7] the Wh_q pack (layout.pack_wh, made once per weight tensor "
                    f"by the wrapper) at H={H}: {pack_ms:.4f} ms a pack")
        worst = max(worst, *err.values())
    log(f"[7] tolerances: outs {TOL_INT8_OUTS}, finals {TOL_INT8_FINALS}")

    rows = near_tie_rows()
    want_q, want_scale = lstm_scan_int8.quantize_rows_reference(rows)
    inv = torch.tensor(1.0) / want_scale
    by_product = int((torch.clamp(torch.round(rows * inv), -127, 127) != want_q).sum())
    h_q, h_scale = lstm_scan_int8.quantize_rows(rows.cuda())
    torch.cuda.synchronize()
    q_diff = int((h_q.cpu().float() != want_q).sum())
    s_diff = int((h_scale.cpu() != want_scale[:, 0]).sum())
    log(f"[7] quantize pass on {rows.shape[0]} near-tie rows of {rows.shape[1]}: "
        f"{by_product} values that the reciprocal product alone rounds otherwise; "
        f"the card's h_q differs from the plain version's at {q_diff}, h_scale at {s_diff}")
    if by_product == 0 or q_diff or s_diff:
        raise AssertionError("the int8 quantize pass does not round as the true quotient")
    return worst, times


def decode_host_pack(pack: np.ndarray, k: int):
    """(top-k values, indices, per-example CE, PERR) of a paired-index host
    pack (train/step._pack_host_outputs): two indices per f32 lane, bits
    31+30 set as the layout marker."""
    h = (k + 1) // 2
    words = np.ascontiguousarray(pack[:, k:k + h]).view(np.int32)
    if not (words < 0).all():
        raise AssertionError("the host pack's index lanes lack the paired marker")
    words = words & 0x3FFFFFFF
    idx = np.empty((pack.shape[0], 2 * h), np.int64)
    idx[:, 0::2] = words & 0xFFFF
    idx[:, 1::2] = words >> 16
    return pack[:, :k], idx[:, :k], pack[:, k + h], pack[:, k + h + 1]


def check_eval_outputs(out, labels, num_classes, what):
    """Finite predictions in [0, 1], and a host pack that decodes to the
    step's own top-k, per-example CE and PERR. Returns the host metrics."""
    check_predictions(out["predictions"].cpu().numpy(), labels.shape[0],
                      num_classes, what)
    k = out["topk_idx"].shape[1]
    vals, idx, loss, perr = decode_host_pack(out["host_pack"].cpu().numpy(), k)
    for name, got, want in (("topk_val", vals, out["topk_val"]),
                            ("topk_idx", idx, out["topk_idx"]),
                            ("per_example_loss", loss, out["per_example_loss"]),
                            ("perr_precision", perr, out["perr_precision"])):
        if not np.array_equal(got, want.cpu().numpy()):
            raise AssertionError(f"{what}: the host pack's {name} differs from the step's")
    return train_step_metrics(vals, idx, labels.cpu().numpy(), perr)


def phase_int8_serving(smi):
    cfg = TrainConfig(compute_dtype="bfloat16")
    model = init_model(cfg, prng.prng_key(0), device="cuda")
    int8_p = Predictor(cfg, model, serve_batch=SERVE_BATCH, device="cuda",
                       quantize="int8")
    plain_p = Predictor(cfg.replace(use_pallas_inference=False), model,
                        serve_batch=SERVE_BATCH, device="cuda", quantize="int8")
    bf16_p = Predictor(cfg, model, serve_batch=SERVE_BATCH, device="cuda")
    sizes = (256, 100, 513)
    batches = list(requests(sizes, cfg, seed=1))
    levels = 2 * cfg.lstm_layers  # wrapper calls per served chunk
    expected = levels * sum(math.ceil(n / SERVE_BATCH) for n in sizes)

    lstm_scan_int8.lstm_chunk_scan_int8.launches = 0
    lstm_scan.lstm_chunk_scan.launches = 0
    served = [int8_p.predict(feats, nf) for feats, nf in batches]
    torch.cuda.synchronize()
    launches = lstm_scan_int8.lstm_chunk_scan_int8.launches
    log(f"[8] student int8 served {sizes}: {launches} int8 kernel launches "
        f"(expected {expected}), {lstm_scan.lstm_chunk_scan.launches} bf16")
    if launches != expected or lstm_scan.lstm_chunk_scan.launches:
        raise AssertionError(f"the int8 kernel ran {launches} times, not {expected}")

    worst = to_bf16 = 0.0
    for (feats, nf), probs in zip(batches, served):
        check_predictions(probs, len(nf), cfg.num_classes, "int8 student")
        worst = max(worst, float(np.abs(probs - plain_p.predict(feats, nf)).max()))
        to_bf16 = max(to_bf16, float(np.abs(probs - bf16_p.predict(feats, nf)).max()))
    log(f"[8] predictions finite in [0, 1]; max|int8 kernel - plain int8 scan| "
        f"{worst:.3g} (tolerance {TOL_PREDICTIONS}); max|int8 - bf16 kernel path| "
        f"{to_bf16:.3g} (same weights; reported, not bounded)")
    if worst > TOL_PREDICTIONS:
        raise AssertionError("the int8 kernel path and the plain int8 path disagree")

    teacher_k = Predictor(cfg, model, tower="teacher", serve_batch=SERVE_BATCH,
                          device="cuda", quantize="int8")
    teacher_p = Predictor(cfg.replace(use_pallas_inference=False), model,
                          tower="teacher", serve_batch=SERVE_BATCH, device="cuda",
                          quantize="int8")
    feats, nf = next(requests((64,), cfg, seed=3))
    before = lstm_scan_int8.lstm_chunk_scan_int8.launches
    probs = teacher_k.predict(feats, nf)
    if (lstm_scan_int8.lstm_chunk_scan_int8.launches - before
            != levels * math.ceil(64 / SERVE_BATCH)):
        raise AssertionError("the int8 teacher did not run through the kernel")
    check_predictions(probs, len(nf), cfg.num_classes, "int8 teacher")
    t_err = float(np.abs(probs - teacher_p.predict(feats, nf)).max())
    log(f"[8] int8 teacher served 64: predictions finite in [0, 1]; "
        f"max|kernel - plain int8 scan| {t_err:.3g} (tolerance {TOL_PREDICTIONS})")
    if t_err > TOL_PREDICTIONS:
        raise AssertionError("the int8 teacher's kernel and plain paths disagree")

    feats, nf = next(requests((8 * SERVE_BATCH,), cfg, seed=2))
    rates = {}
    for name, p in (("int8", int8_p), ("bf16", bf16_p), ("int8", int8_p),
                    ("bf16", bf16_p)):
        rates.setdefault(name, []).append(videos_per_s(p, feats, nf))
    log(f"[8] student serving, serve_batch {SERVE_BATCH}, {len(nf)} videos per "
        f"predict, kernel paths, median of 3 in each of two turns: int8 "
        + ", ".join(f"{r:.1f}" for r in rates["int8"]) + " videos/s, bf16 "
        + ", ".join(f"{r:.1f}" for r in rates["bf16"]) + f" videos/s ({smi})")

    feats, labels, nf = distill_batch(cfg, SERVE_BATCH, seed=8)
    before = (lstm_scan_int8.lstm_chunk_scan_int8.launches,
              lstm_scan.lstm_chunk_scan.launches)
    out_q = build_quantized_eval_step(cfg)(int8_p.qparams, feats, labels, nf)
    out_b = build_eval_step(cfg)(model, feats, labels, nf)
    torch.cuda.synchronize()
    delta = (lstm_scan_int8.lstm_chunk_scan_int8.launches - before[0],
             lstm_scan.lstm_chunk_scan.launches - before[1])
    if delta != (levels, levels):
        raise AssertionError(f"the eval steps made {delta} int8/bf16 launches, "
                             f"not {levels} each")
    host_q = check_eval_outputs(out_q, labels, cfg.num_classes, "int8 eval step")
    host_b = check_eval_outputs(out_b, labels, cfg.num_classes, "bf16 eval step")
    idx_q, idx_b = out_q["topk_idx"].cpu().numpy(), out_b["topk_idx"].cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / len(a) for a, b in zip(idx_q, idx_b)]))
    log(f"[8] eval steps, batch {SERVE_BATCH}, kernel paths ({delta[0]} int8 and "
        f"{delta[1]} bf16 launches): top-20 overlap int8 vs bf16 {overlap:.4f}; "
        f"PERR int8 {host_q['perr']:.4g}, bf16 {host_b['perr']:.4g}; hit@1 int8 "
        f"{host_q['hit_at_one']:.4g}, bf16 {host_b['hit_at_one']:.4g}; host packs "
        f"decode to each step's own top-k, CE and PERR")
    return launches


# A width the wrappers zero-pad for TMA: to 104 units in bf16, 112 in int8.
ODD_CELLS = 100


def phase_routing():
    """At lstm_cells 100 the JAX model runs its Pallas kernels, and so does
    the port: a bf16 and an int8 Predictor serve through the kernels,
    held against the Predictors on the plain scans, and the distill
    losses and gradients through the train kernels against the plain
    path."""
    cfg = TrainConfig(compute_dtype="bfloat16", lstm_cells=ODD_CELLS)
    model = init_model(cfg, prng.prng_key(3), device="cuda")
    feats, nf = next(requests((64,), cfg, seed=9))
    levels = 2 * cfg.lstm_layers
    for quant, kernel in (("none", "lstm_chunk_scan"), ("int8", "lstm_chunk_scan_int8")):
        p = Predictor(cfg, model, serve_batch=SERVE_BATCH, device="cuda", quantize=quant)
        plain = Predictor(cfg.replace(use_pallas_inference=False), model,
                          serve_batch=SERVE_BATCH, device="cuda", quantize=quant)
        for fn in COUNTERS.values():
            fn.launches = 0
        probs = p.predict(feats, nf)
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in COUNTERS.items()}
        check_predictions(probs, len(nf), cfg.num_classes, f"lstm_cells {ODD_CELLS} {quant}")
        err = float(np.abs(probs - plain.predict(feats, nf)).max())
        log(f"[8] lstm_cells {ODD_CELLS}, quantize {quant}: served 64 videos, kernel "
            f"launches {counts}; max|kernel - plain scan| {err:.3g} (tolerance "
            f"{TOL_PREDICTIONS})")
        if counts != {name: levels if name == kernel else 0 for name in COUNTERS}:
            raise AssertionError(f"lstm_cells {ODD_CELLS} {quant}: launches {counts}")
        if err > TOL_PREDICTIONS:
            raise AssertionError(f"lstm_cells {ODD_CELLS} {quant}: the kernel path and "
                                 "the plain path disagree")

    cfg = cfg.replace(batch_size=32)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt, prng.prng_key(4), device="cuda")
    batch = distill_batch(cfg, cfg.batch_size, seed=10)
    before = train_counts()
    k_ls, _, k_gt, k_gs = distill_loss_and_grads(cfg, state, *batch)
    delta = [a - b for a, b in zip(train_counts(), before)]
    p_ls, _, p_gt, p_gs = distill_loss_and_grads(cfg, state, *batch,
                                                 kernel_train_mode="off")
    loss_bad = [k for k in k_ls if abs(k_ls[k].item() - p_ls[k].item())
                > TOL_LOSS_REL * abs(p_ls[k].item()) + TOL_LOSS_ABS]
    grad_err = max(rel_err(g[n], p[n]) for g, p in ((k_gt, p_gt), (k_gs, p_gs)) for n in g)
    log(f"[8] lstm_cells {ODD_CELLS}, distill batch {cfg.batch_size}: train launches fwd "
        f"{delta[0]} bwd {delta[1]}; losses kernel / plain " + "; ".join(
            f"{k} {k_ls[k].item():.6g} / {p_ls[k].item():.6g}" for k in k_ls)
        + f"; gradients max|diff| of max, worst {grad_err:.3g}")
    if delta != [2 * levels, 2 * levels]:
        raise AssertionError(f"lstm_cells {ODD_CELLS}: {delta} train launches")
    if loss_bad or not math.isfinite(grad_err) or grad_err > TOL_GRAD_REL:
        raise AssertionError(f"lstm_cells {ODD_CELLS}: kernel and plain distill disagree "
                             f"({loss_bad}, {grad_err})")


# ------------------------------------------- phase 9: the five binaries
#
# 9a is scripts/fidelity_check.py through the port's binaries: its data
# (10 synthetic videos a split at flagship widths), its canonical flags
# (:143-157) and its bands against the reference's golden log (GOLDEN and
# check_trajectory, :38-41 and :67-110). Two flags are added that change
# no number: every tick writes the summaries (the device histograms) and
# every step saves a checkpoint through the async saver.
FIDELITY_FLAGS = [
    "--feature_names", "rgb, audio", "--feature_sizes", "1024, 128",
    "--model", "HierarchicalLstmModel", "--batch_size", "5",
    "--num_inputs_to_lstm", "20", "--lstm_layers", "2", "--every_n", "10",
    "--num_epochs", "2", "--num_readers", "2", "--scan_unroll", "1",
]
FIDELITY_VIDEOS = 10
GOLDEN = {
    2: {"teacher": 1914.09, "l_rep": 1.16, "l_pred": 0.01, "l_ce": 1914.1},
    4: {"teacher": 1908.12, "l_rep": 1.52, "l_pred": 0.01, "l_ce": 1913.41},
}
STEP_RE = re.compile(r"training step (\d+)\|.*Teacher_Loss: ([\d.]+)\| "
                     r"L_REP: ([\d.]+)\| L_PRED: ([\d.]+)\| L_CE: ([\d.]+)")
EVAL_RATE_RE = re.compile(r"Average examples processed in one second ([\d.]+)")
# int8 against bf16 epoch metrics of one checkpoint: tests/test_quantize.py's
# deploy-gate bar on Hit@1, PERR and GAP.
TOL_INT8_EPOCH = 2e-3
EPOCH_KEYS = ("avg_hit_at_one", "avg_perr", "gap")
# 9b: the flagship at the reference's batch of 256 (every flag at its
# default): 512 training videos in 4 shards over 2 epochs, 600 eval videos
# in 4 shards (a padded final batch).
SCALE_TRAIN, SCALE_EVAL, SHARDS = 512, 600, 4
COUNTERS = {
    "lstm_train_fwd": lstm_train.lstm_train_fwd,
    "lstm_train_bwd": lstm_train.lstm_train_bwd,
    "lstm_chunk_scan": lstm_scan.lstm_chunk_scan,
    "lstm_chunk_scan_int8": lstm_scan_int8.lstm_chunk_scan_int8,
}


class LogCapture(logging.Handler):
    """The matches of `pattern` in the messages of one logger."""

    def __init__(self, logger_name: str, pattern: re.Pattern):
        super().__init__()
        self.logger = logging.getLogger(logger_name)
        self.pattern = pattern
        self.matches = []

    def emit(self, record):
        m = self.pattern.search(record.getMessage())
        if m:
            self.matches.append(m.groups())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def run_binary(tag: str, main_fn, argv, expected):
    """`main_fn(argv)` with every kernel count set to 0 just before it and
    read just after; each count must equal `expected` (0 where not named).
    Returns (the binary's result, its seconds, the counts)."""
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = main_fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    log(f"[9] {tag}: {seconds:.3f} s; kernel launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    want = {name: expected.get(name, 0) for name in COUNTERS}
    if counts != want:
        raise AssertionError(f"{tag}: kernel launches {counts}, expected {want}")
    return result, seconds, counts


def check_trajectory(steps) -> None:
    """scripts/fidelity_check.py's bands (:67-110) on the logged steps."""
    s2, s4 = steps.get(2), steps.get(4)
    if not (s2 and s4):
        raise AssertionError(f"steps 2 and 4 not logged (got {sorted(steps)})")
    log(f"[9] step 2: {s2} (golden {GOLDEN[2]}); step 4: {s4} (golden {GOLDEN[4]})")
    drop = s2["teacher"] - s4["teacher"]
    checks = [
        (abs(s2["teacher"] - GOLDEN[2]["teacher"]) < 2.0,
         f"step-2 Teacher_Loss {s2['teacher']:.2f} within 2.0 of {GOLDEN[2]['teacher']}"),
        (abs(s2["l_ce"] - GOLDEN[2]["l_ce"]) < 2.0,
         f"step-2 L_CE {s2['l_ce']:.2f} within 2.0 of {GOLDEN[2]['l_ce']}"),
        (1.0 < drop < 20.0, f"step-4 teacher CE decrease {drop:.2f} in (1, 20)"),
        (s4["l_ce"] < s2["l_ce"], f"step-4 L_CE {s4['l_ce']:.2f} < step-2 {s2['l_ce']:.2f}"),
        (0.0 < s2["l_rep"] < 3.0, f"step-2 L_REP {s2['l_rep']:.2f} in (0, 3)"),
        (s4["l_rep"] > s2["l_rep"], f"L_REP grows {s2['l_rep']:.2f} -> {s4['l_rep']:.2f}"),
        (s2["l_pred"] < 0.2 and s4["l_pred"] < 0.2,
         f"L_PRED near zero ({s2['l_pred']}, {s4['l_pred']})"),
    ]
    for ok, msg in checks:
        log(f"[9]   [{'ok' if ok else 'FAIL'}] {msg}")
    if not all(ok for ok, _ in checks):
        raise AssertionError("the fidelity bands of scripts/fidelity_check.py failed")


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flat_leaves(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def check_same_student(trained_path: str, converted_path: str) -> int:
    """Every student parameter of the converted file bit-equal to the
    trained file's. Returns the number of tensors compared."""
    trained = flat_leaves(msgpack_io.load(trained_path)["params_student"])
    converted = flat_leaves(msgpack_io.load(converted_path)["params_student"])
    if trained.keys() != converted.keys():
        raise AssertionError("the converted student has other parameters")
    for name, value in trained.items():
        other = converted[name]
        if other.dtype != value.dtype or not np.array_equal(
                other.view(np.uint8), value.view(np.uint8)):
            raise AssertionError(f"converted student {name} is not bit-equal")
    return len(trained)


def read_scalars(logdir: str, tag: str):
    """{step: value} of the scalar summary `tag` in logdir's events files."""
    out = {}
    for path in sorted(glob.glob(os.path.join(logdir, "events.out.tfevents.*"))):
        for record in port_data.TFRecordReader(path):
            step, value = 0, None
            for fn, _, v in port_data.iter_fields(record):
                if fn == 2:  # Event.step
                    step = v
                elif fn == 5:  # Event.summary -> Summary.value
                    for _, _, sv in port_data.iter_fields(bytes(v)):
                        fields = {f: x for f, _, x in port_data.iter_fields(bytes(sv))}
                        if bytes(fields.get(1, b"")).decode() == tag and 2 in fields:
                            value = struct.unpack("<f", bytes(fields[2]))[0]
            if value is not None:
                out[step] = value
    return out


def check_epochs(base, quant, epoch_id, what):
    for name, data in (("bf16", base), ("int8", quant)):
        if data["epoch_id"] != epoch_id or not np.isfinite(data["avg_loss"]):
            raise AssertionError(f"{what} {name}: epoch {data['epoch_id']}, "
                                 f"avg_loss {data['avg_loss']}")
    diffs = {key: abs(base[key] - quant[key]) for key in EPOCH_KEYS}
    diffs["mAP"] = abs(float(np.mean(base["aps"])) - float(np.mean(quant["aps"])))
    log(f"[9] {what} epoch metrics bf16 / int8: " + "; ".join(
        f"{k} {base[k]:.6g} / {quant[k]:.6g}" for k in EPOCH_KEYS + ("avg_loss",))
        + f"; mAP {np.mean(base['aps']):.6g} / {np.mean(quant['aps']):.6g}; |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
        + f" (tolerance {TOL_INT8_EPOCH} on {', '.join(EPOCH_KEYS)})")
    if max(diffs[k] for k in EPOCH_KEYS) > TOL_INT8_EPOCH:
        raise AssertionError(f"{what}: int8 and bf16 epoch metrics differ: {diffs}")


def phase_pipeline_fidelity(root: str):
    """9a: train -> validate -> convert -> finetune -> eval (bf16, int8)."""
    data_dir = os.path.join(root, "yt8m")
    os.makedirs(data_dir)
    for split, seed in (("train", 0), ("validate", 1)):
        port_data.write_synthetic_frame_shard(
            os.path.join(data_dir, f"{split}-0000.tfrecord"),
            num_videos=FIDELITY_VIDEOS, seed=seed)
    train_pattern = os.path.join(data_dir, "train*.tfrecord")
    eval_pattern = os.path.join(data_dir, "validate*.tfrecord")
    train_dir = os.path.join(root, "model_train") + "/"
    levels = 4  # wrapper calls per tower forward: 2 levels x 2 layers
    batches = FIDELITY_VIDEOS // 5  # a split per epoch at batch 5
    seconds = {}

    with LogCapture("train", STEP_RE) as capture:
        state, seconds["train"], _ = run_binary(
            "9a train", train_cli.main, FIDELITY_FLAGS + [
                "--train_dir", train_dir, "--train_data_pattern", train_pattern,
                "--start_new_model", "true", "--save_summaries_secs", "0",
                "--save_model_secs", "0"],
            {"lstm_train_fwd": 2 * levels * 2 * batches,
             "lstm_train_bwd": 2 * levels * 2 * batches})
    steps = {int(m[0]): dict(zip(("teacher", "l_rep", "l_pred", "l_ce"),
                                 map(float, m[1:]))) for m in capture.matches}
    check_trajectory(steps)
    trained = checkpoint.latest_checkpoint(train_dir)
    want_step = 2 * 2 * batches  # 2 epochs, the step advances 2 a batch
    if state.global_step != want_step or not trained.endswith(
            f"model.ckpt-{want_step}.msgpack"):
        raise AssertionError(f"train ended at {state.global_step}, {trained}")
    # written for each lagged step inside the loop: all but the last
    summaries = read_scalars(train_dir, "label_loss")
    if sorted(summaries) != list(range(2, want_step, 2)):
        raise AssertionError(f"summaries written at steps {sorted(summaries)}")
    del state

    epoch, seconds["validate"], _ = run_binary(
        "9a validate", validate_cli.main, FIDELITY_FLAGS + [
            "--train_dir", train_dir, "--eval_data_pattern", eval_pattern,
            "--run_once", "true"],
        {"lstm_chunk_scan": 2 * levels * batches})
    if epoch["epoch_id"] != want_step or not np.isfinite(epoch["avg_loss"]):
        raise AssertionError(f"validate epoch {epoch}")

    converted, seconds["convert"], _ = run_binary(
        "9a convert", convert_cli.main, FIDELITY_FLAGS + ["--train_dir", train_dir], {})
    finetune_dir = train_dir.replace("train", "") + "finetune/"
    if converted != os.path.join(finetune_dir, "model.ckpt-0.msgpack"):
        raise AssertionError(f"convert wrote {converted}")
    n = check_same_student(trained, converted)
    log(f"[9] converted student bit-equal to the trained one ({n} tensors); "
        f"files: distill {os.path.getsize(trained)} B, student "
        f"{os.path.getsize(converted)} B")

    _, seconds["finetune"], _ = run_binary(
        "9a finetune", finetune_cli.main, FIDELITY_FLAGS + [
            "--train_dir", finetune_dir, "--train_data_pattern", train_pattern,
            "--num_epochs", "1", "--save_summaries_secs", "0"],
        {"lstm_train_fwd": levels * batches, "lstm_train_bwd": levels * batches})
    tuned = checkpoint.latest_checkpoint(finetune_dir)
    if not tuned.endswith(f"model.ckpt-{batches}.msgpack"):
        raise AssertionError(f"finetune wrote {tuned}")

    runs = {}
    for quant, kernel in (("none", "lstm_chunk_scan"), ("int8", "lstm_chunk_scan_int8")):
        runs[quant], seconds[f"eval {quant}"], _ = run_binary(
            f"9a eval --quantize {quant}", eval_cli.main, FIDELITY_FLAGS + [
                "--train_dir", finetune_dir, "--eval_data_pattern", eval_pattern,
                "--run_once", "true", "--quantize", quant],
            {kernel: levels * batches})
    check_epochs(runs["none"], runs["int8"], batches, "9a eval")
    log("[9] 9a stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))
    return {"data_dir": data_dir, "eval_pattern": eval_pattern, "trained": trained,
            "finetune_dir": finetune_dir, "batches": batches}


# 9c: the inference binaries on 9a's finetuned student and validate shards.
# cli.infer's rows against format_lines of Predictor.from_checkpoint on the
# same videos: the same forward in other calls, so probabilities within
# 1e-5 (the CSV prints 6 decimals) and the same classes wherever
# neighbouring probabilities are more than 1e-5 apart. int8 rows against
# bf16 rows at PERF.md section 2's prediction bar.
TOL_CSV = 1e-5
TOL_INT8_PREDICTIONS = 1e-3
INFER_LINE_RE = re.compile(r"num examples processed: (\d+) elapsed seconds: ([\d.]+)")


def read_csv(path: str):
    """[(video_id, [(class, prob), ...])] of a Kaggle CSV, in file order."""
    with open(path) as f:
        header, *lines = f.read().splitlines()
    if header != "VideoId,LabelConfidencePairs":
        raise AssertionError(f"{path}: header {header!r}")
    rows = []
    for line in lines:
        vid, pairs = line.split(",", 1)
        tokens = pairs.split(" ")
        rows.append((vid, [(int(c), float(p)) for c, p in zip(tokens[0::2], tokens[1::2])]))
    return rows


def check_csv_shape(path: str, video_ids, top_k: int, what: str):
    rows = read_csv(path)
    if [vid for vid, _ in rows] != list(video_ids):
        raise AssertionError(f"{what}: the CSV's videos are not the shards' in order")
    if any(len(pairs) != top_k for _, pairs in rows):
        raise AssertionError(f"{what}: a row without {top_k} pairs")
    return rows


def check_rows_against_predictor(rows, probs, top_k: int) -> float:
    """cli.infer's rows against the Predictor's probabilities of the same
    videos. Returns the largest probability difference."""
    worst = 0.0
    for (vid, pairs), p in zip(rows, probs):
        order = np.argsort(-p, kind="stable")[:top_k + 1]
        want = p[order].astype(np.float64)
        got = np.array([prob for _, prob in pairs])
        worst = max(worst, float(np.abs(got - want[:top_k]).max()))
        for r, (cls, _) in enumerate(pairs):
            apart = [abs(want[r] - want[q]) for q in (r - 1, r + 1) if 0 <= q <= top_k]
            if min(apart) > TOL_CSV and cls != int(order[r]):
                raise AssertionError(f"{vid}: rank {r} is class {cls}, the Predictor's "
                                     f"{int(order[r])}")
    if worst > TOL_CSV:
        raise AssertionError(f"cli.infer's probabilities differ from the Predictor's by {worst}")
    return worst


def check_int8_rows(bf16_rows, int8_rows) -> float:
    """Each class in both rows within TOL_INT8_PREDICTIONS; a class in one
    row only sits within that bar of the other row's last probability."""
    worst = 0.0
    for (vid, a), (_, b) in zip(bf16_rows, int8_rows):
        da, db = dict(a), dict(b)
        for c in set(da) | set(db):
            if c in da and c in db:
                diff = abs(da[c] - db[c])
            else:
                mine, other = (da[c], b) if c in da else (db[c], a)
                diff = max(0.0, mine - other[-1][1])
            worst = max(worst, diff)
    if worst > TOL_INT8_PREDICTIONS:
        raise AssertionError(f"int8 and bf16 CSVs differ by {worst}")
    return worst


def to_string(main_fn, out: io.StringIO):
    """`main_fn` with its standard output written to `out`."""

    def call(argv):
        with contextlib.redirect_stdout(out):
            return main_fn(argv)

    return call


def phase_pipeline_infer(root: str, fidelity: dict):
    """9c: cli.infer bf16 and int8, cli.inference_bias, cli.max_ensemble,
    cli.inspect_checkpoint and cli.hash_check."""
    finetune_dir, eval_pattern = fidelity["finetune_dir"], fidelity["eval_pattern"]
    cfg = flags.config_from_args(flags.base_parser("").parse_args(FIDELITY_FLAGS))
    levels, batches, top_k = 2 * cfg.lstm_layers, fidelity["batches"], cfg.top_k
    loader = port_data.FrameDataLoader(
        eval_pattern, batch_size=FIDELITY_VIDEOS, feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list, max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes, num_epochs=1, shuffle=False)
    (batch,) = list(loader)
    argv = FIDELITY_FLAGS + ["--train_dir", finetune_dir, "--input_data_pattern", eval_pattern]
    csv = {name: os.path.join(root, f"pred_{name}.csv") for name in ("bf16", "int8", "bias")}
    for name, quant, kernel in (("bf16", "none", "lstm_chunk_scan"),
                                ("int8", "int8", "lstm_chunk_scan_int8")):
        run_binary(f"9c infer --quantize {quant}", infer_cli.main,
                   argv + ["--output_file", csv[name], "--quantize", quant],
                   {kernel: levels * batches})
    run_binary("9c inference_bias", inference_bias_cli.main,
               argv + ["--output_file", csv["bias"], "--tensor_name",
                       "classifier/experts/b", "--alpha_bias", "2"],
               {"lstm_chunk_scan": levels * batches})
    rows = {name: check_csv_shape(path, batch.video_ids, top_k, f"9c {name}")
            for name, path in csv.items()}
    predictor = Predictor.from_checkpoint(finetune_dir, cfg, serve_batch=cfg.batch_size,
                                          device="cuda")
    probs = predictor.predict(batch.features, batch.num_frames)
    del predictor
    want = list(ensemble.format_lines(batch.video_ids, probs, top_k))
    worst = check_rows_against_predictor(rows["bf16"], probs, top_k)
    same = sum(line == w for line, w in zip(open(csv["bf16"]).read().splitlines()[1:],
                                              (w.rstrip("\n") for w in want)))
    int8_worst = check_int8_rows(rows["bf16"], rows["int8"])
    moved = max(abs(p - q) for (_, a), (_, b) in zip(rows["bf16"], rows["bias"])
                for (_, p), (_, q) in zip(a, b))
    log(f"[9] 9c cli.infer bf16 against format_lines(Predictor.predict) of the same "
        f"{len(probs)} videos: max|diff| {worst:.3g} (tolerance {TOL_CSV}), {same} of "
        f"{len(want)} rows byte-equal; int8 against bf16 max|diff| {int8_worst:.3g} "
        f"(tolerance {TOL_INT8_PREDICTIONS}); inference_bias (alpha 2) moved the "
        f"probabilities by up to {moved:.3g}")

    merged = os.path.join(root, "ensemble.csv")
    run_binary("9c max_ensemble", max_ensemble_cli.main, [
        "--preds_pattern", os.path.join(root, "pred_*.csv"), "--output_file", merged,
        "--num_classes", str(cfg.num_classes), "--top_k", str(top_k)], {})
    inputs = [dict(pairs) for name in ("bf16", "bias", "int8") for _, pairs in rows[name]]
    for i, (vid, pairs) in enumerate(check_csv_shape(merged, batch.video_ids, top_k,
                                                     "9c max_ensemble")):
        for c, p in pairs:
            best = max(d.get(c, 0.0) for d in inputs[i::len(rows["bf16"])])
            if abs(p - best) > 1e-6:
                raise AssertionError(f"max_ensemble {vid} class {c}: {p}, max {best}")

    out = io.StringIO()
    run_binary("9c inspect_checkpoint", to_string(inspect_checkpoint_cli.main, out),
               ["--file_name", fidelity["trained"]], {})
    listed = [line for line in out.getvalue().splitlines() if line.startswith("tensor_name: ")]
    leaves = flat_leaves(msgpack_io.load(fidelity["trained"]))
    if len(listed) != len(leaves):
        raise AssertionError(f"inspect_checkpoint listed {len(listed)} of {len(leaves)} leaves")

    shard = sorted(glob.glob(eval_pattern))[0]
    manifests = {}
    for name, digest in (("good", hashlib.md5(open(shard, "rb").read()).hexdigest()),
                         ("bad", "0" * 32)):
        manifests[name] = os.path.join(root, f"manifest_{name}.json")
        with open(manifests[name], "w") as f:
            json.dump({os.path.basename(shard): digest}, f)
    codes = {name: run_binary(f"9c hash_check ({name} manifest)",
                              to_string(hash_check_cli.main, io.StringIO()),
                              ["--manifest", path, "--data_dir", os.path.dirname(shard)],
                              {})[0]
             for name, path in manifests.items()}
    if codes != {"good": 0, "bad": 1}:
        raise AssertionError(f"hash_check returned {codes}")
    log(f"[9] 9c max_ensemble rows are the per-class max of the three CSVs; "
        f"inspect_checkpoint listed all {len(leaves)} leaves; hash_check 0 on the "
        f"shard's md5, 1 on a wrong one")


def phase_pipeline_scale(root: str, smi: str, step_rate: float):
    """9b: cli.train at batch 256, checkpoint I/O of its state, cli.eval
    bf16 and int8 of its student."""
    data_dir = os.path.join(root, "scale")
    os.makedirs(data_dir)
    for split, videos, seed in (("train", SCALE_TRAIN, 10), ("validate", SCALE_EVAL, 20)):
        for s in range(SHARDS):
            port_data.write_synthetic_frame_shard(
                os.path.join(data_dir, f"{split}-{s:04d}.tfrecord"),
                num_videos=videos // SHARDS, seed=seed + s)
    cfg = TrainConfig()
    B, levels = cfg.batch_size, 2 * cfg.lstm_layers
    train_steps = 2 * SCALE_TRAIN // B
    train_dir = os.path.join(root, "scale_train") + "/"
    seconds = {}
    state, seconds["train"], _ = run_binary(
        "9b train", train_cli.main, [
            "--train_dir", train_dir, "--num_epochs", "2", "--start_new_model", "true",
            "--train_data_pattern", os.path.join(data_dir, "train*.tfrecord")],
        {"lstm_train_fwd": 2 * levels * train_steps,
         "lstm_train_bwd": 2 * levels * train_steps})
    if state.global_step != 2 * train_steps:
        raise AssertionError(f"train ended at step {state.global_step}")
    rates = read_scalars(train_dir, "global_step/Examples/Second")
    if sorted(rates) != list(range(2, 2 * train_steps + 1, 2)):
        raise AssertionError(f"Examples/Second logged at steps {sorted(rates)}")
    # each value is B over the host time from one step's launch to the
    # next; over the steps after the first, videos over summed time
    later = [rates[s] for s in sorted(rates)[1:]]
    steady = len(later) * B / sum(B / r for r in later)
    log(f"[9] 9b cli.train batch {B}, {train_steps} steps: Examples/Second by step "
        + ", ".join(f"{s}: {v:.1f}" for s, v in sorted(rates.items()))
        + f"; after the first step {steady:.1f} videos/s (videos over summed "
        f"time) against phase 6's step-level {step_rate:.1f} "
        f"({steady / step_rate:.3f}) ({smi})")

    trained = checkpoint.latest_checkpoint(train_dir)
    io_dir = os.path.join(root, "io")
    t0 = time.perf_counter()
    path = checkpoint.save_checkpoint(io_dir, state, state.global_step)
    save_s = time.perf_counter() - t0
    saver = checkpoint.AsyncCheckpointSaver()
    times = []
    for step in (1, 2):
        t0 = time.perf_counter()
        saver.save(os.path.join(io_dir, "async"), state, step)
        returned = time.perf_counter() - t0
        saver.wait()
        times.append((returned, time.perf_counter() - t0))
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    template = init_distill_state(cfg, opt, prng.prng_key(1), device="cuda")
    t0 = time.perf_counter()
    checkpoint.restore_checkpoint(path, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for tower in ("teacher", "student"):
        want = getattr(state, tower).state_dict()
        for name, value in getattr(template, tower).state_dict().items():
            if not torch.equal(value, want[name]):
                raise AssertionError(f"restored {tower}.{name} differs")
    size = os.path.getsize(path)
    log(f"[9] 9b checkpoint of the distill state: {size / 2**30:.3f} GiB "
        f"({size} B, same as the CLI's: {size == os.path.getsize(trained)}); "
        f"save {save_s:.3f} s ({size / save_s / 2**30:.2f} GiB/s); async save "
        + ", ".join(f"main thread {a:.3f} s, written after {b:.3f} s" for a, b in times)
        + f"; restore into a card state {restore_s:.3f} s "
        f"({size / restore_s / 2**30:.2f} GiB/s), every tensor bit-equal ({smi})")
    del state, template, saver

    eval_batches = math.ceil(SCALE_EVAL / B)
    runs, rates = {}, {"none": [], "int8": []}
    kernels = {"none": "lstm_chunk_scan", "int8": "lstm_chunk_scan_int8"}
    for turn, quant in enumerate(("none", "int8", "int8", "none")):  # in turns
        with LogCapture("eval", EVAL_RATE_RE) as capture:
            runs.setdefault(quant, []).append(run_binary(
                f"9b eval --quantize {quant}", eval_cli.main, [
                    "--train_dir", train_dir, "--run_once", "true", "--quantize", quant,
                    "--eval_data_pattern", os.path.join(data_dir, "validate*.tfrecord")],
                {kernels[quant]: levels * eval_batches}))
        (rate,) = [float(m[0]) for m in capture.matches]
        rates[quant].append(rate)
        seconds[f"eval {quant} ({turn + 1})"] = runs[quant][-1][1]
    check_epochs(runs["none"][0][0], runs["int8"][0][0], 2 * train_steps, "9b eval")
    log(f"[9] 9b cli.eval batch {B}, {SCALE_EVAL} videos ({eval_batches} batches, "
        "the last padded), in turns bf16, int8, int8, bf16: the CLI's examples/s "
        f"bf16 {rates['none'][0]:.1f} and {rates['none'][1]:.1f}, int8 "
        f"{rates['int8'][0]:.1f} and {rates['int8'][1]:.1f} ({smi})")
    infer_rates(root, data_dir, train_dir, smi, levels)
    log("[9] 9b stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items()))

    serve_cfg = TrainConfig(compute_dtype="bfloat16")
    feats, nf = next(requests((64,), serve_cfg, seed=4))
    for tower in ("student", "teacher"):
        predictor, _, _ = run_binary(
            f"9b Predictor.from_checkpoint(tower={tower!r})",
            lambda d: Predictor.from_checkpoint(d, serve_cfg, tower=tower,
                                                serve_batch=SERVE_BATCH, device="cuda"),
            train_dir, {})
        lstm_scan.lstm_chunk_scan.launches = 0
        probs = predictor.predict(feats, nf)
        torch.cuda.synchronize()
        check_predictions(probs, len(nf), serve_cfg.num_classes, f"{tower} from checkpoint")
        if lstm_scan.lstm_chunk_scan.launches != levels:
            raise AssertionError(f"the {tower} from the checkpoint made "
                                 f"{lstm_scan.lstm_chunk_scan.launches} launches")
        log(f"[9] {tower} from {os.path.basename(trained)} served 64 videos: "
            f"{levels} kernel launches, predictions finite in [0, 1]")


# cli.infer's rate: 20 batches of 256, the 4 eval shards of 9b (600 videos)
# linked in turn until they hold 5120 (duplicate ids are rows like any other)
INFER_BATCHES = 20


def infer_rates(root: str, data_dir: str, train_dir: str, smi: str, levels: int):
    """cli.infer bf16 and int8 in turns over INFER_BATCHES batches of 256 of
    9b's student, each rate from its own "num examples processed" lines,
    and cli.eval bf16 over the same shards beside them."""
    infer_dir = os.path.join(root, "infer")
    os.makedirs(infer_dir)
    shards = sorted(glob.glob(os.path.join(data_dir, "validate*.tfrecord")))
    B = TrainConfig().batch_size
    videos, i = 0, 0
    while videos < INFER_BATCHES * B:
        os.symlink(shards[i % len(shards)], os.path.join(infer_dir, f"test-{i:04d}.tfrecord"))
        videos += SCALE_EVAL // SHARDS
        i += 1
    batches = math.ceil(videos / B)
    pattern = os.path.join(infer_dir, "test-*.tfrecord")
    kernels = {"none": "lstm_chunk_scan", "int8": "lstm_chunk_scan_int8"}
    rates = {"none": [], "int8": []}
    for quant in ("none", "int8", "int8", "none"):
        out = os.path.join(infer_dir, f"pred_{quant}.csv")
        with LogCapture("infer", INFER_LINE_RE) as capture:
            run_binary(f"9b infer --quantize {quant}", infer_cli.main, [
                "--train_dir", train_dir, "--input_data_pattern", pattern,
                "--output_file", out, "--quantize", quant],
                {kernels[quant]: levels * batches})
        done = [(int(n), float(t)) for n, t in capture.matches]
        if len(done) != batches or done[-1][0] != videos:
            raise AssertionError(f"cli.infer logged {done[-1:]} of {len(done)} batches")
        with open(out) as f:
            if sum(1 for _ in f) != videos + 1:
                raise AssertionError("cli.infer wrote another number of rows")
        # all videos over the last line's time, and the batches after the
        # first over the time after it (the first holds the warm-up)
        rates[quant].append((videos / done[-1][1],
                             (videos - done[0][0]) / (done[-1][1] - done[0][1])))
    with LogCapture("eval", EVAL_RATE_RE) as capture:
        run_binary("9b eval --quantize none (the infer shards)", eval_cli.main, [
            "--train_dir", train_dir, "--run_once", "true", "--eval_data_pattern", pattern],
            {"lstm_chunk_scan": levels * batches})
    (eval_rate,) = [float(m[0]) for m in capture.matches]
    log(f"[9] 9b cli.infer batch {B}, {videos} videos ({batches} batches), in turns "
        "bf16, int8, int8, bf16, videos/s (all, after the first batch): bf16 "
        + ", ".join(f"{a:.1f} ({b:.1f})" for a, b in rates["none"]) + "; int8 "
        + ", ".join(f"{a:.1f} ({b:.1f})" for a, b in rates["int8"])
        + f"; cli.eval bf16 on the same shards {eval_rate:.1f} examples/s ({smi})")


def phase_pipeline(smi: str, step_rate: float) -> None:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    try:
        fidelity = phase_pipeline_fidelity(root)
        phase_pipeline_infer(root, fidelity)
        phase_pipeline_scale(root, smi, step_rate)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------- phase 10: the library yardstick
#
# cuDNN's LSTM layer computes what one of the port's layers computes: the
# x @ Wx product and the recurrence, full length. PyTorch sends an RNN to
# cuDNN only in f16, f32 or f64 (bf16 takes its native loop of GEMMs), so
# the yardstick runs in f16, at the tensor cores' bf16 rate. Agreement of
# cuDNN's f16 outputs with the port's bf16 ones, over the largest |out|:
# the two round h to 11 and 8 significant bits every step (5e-3 and less
# expected), where a wrong gate order gives 0.2 and more.
TOL_CUDNN_REL = 0.1


def cudnn_layer(kernel, bias, D, H, forget_bias=1.0):
    """torch.nn.LSTM(D, H) in f16 holding the TF1 layer (kernel [D+H, 4H],
    gates i, j, f, o; forget_bias inside the f sigmoid): cuDNN's gate
    order is i, f, g, o and its biases sum, so the columns are permuted
    and the forget bias is folded into b_ih."""
    i, j, f, o = (torch.arange(g * H, (g + 1) * H, device=kernel.device) for g in range(4))
    perm = torch.cat([i, f, j, o])
    b = bias.clone()
    b[2 * H:3 * H] += forget_bias
    lstm = torch.nn.LSTM(D, H).to(device="cuda", dtype=torch.float16)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(kernel[:D, perm].t())
        lstm.weight_hh_l0.copy_(kernel[D:, perm].t())
        lstm.bias_ih_l0.copy_(b[perm])
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()
    return lstm


def phase_library(smi):
    """cuDNN's layer (inference forward, training forward, backward) beside
    the port's (x @ Wx + lstm_chunk_scan; LstmLayerTrain forward, backward)
    at the flagship layer shapes, every sequence full length. Returns
    {name: {what: ms}}."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    library = {}
    for name, T, B, H, D in FLAGSHIP_SHAPES:
        xs, kernel, bias, _, _ = train_layer_case(T, B, H, D, gen)
        seq = torch.full((B,), T, dtype=torch.int32, device="cuda")
        x16 = xs.transpose(0, 1).contiguous().half().requires_grad_(True)
        lstm = cudnn_layer(kernel, bias, D, H)
        if not torch.backends.cudnn.is_acceptable(x16):
            raise AssertionError("cuDNN does not take the f16 input")
        wx, wh = kernel[:D].bfloat16(), kernel[D:].bfloat16()
        x_bf = xs.transpose(0, 1).bfloat16().contiguous()

        def port_infer():
            with torch.no_grad():
                return lstm_scan.lstm_chunk_scan(torch.matmul(x_bf, wx), wh, bias, seq)

        def cudnn_infer():
            with torch.no_grad():
                return lstm(x16)

        k, b, x = (t.clone().requires_grad_(True) for t in (kernel, bias, xs))
        port_out = lstm_train.LstmLayerTrain.apply(k, b, x, seq, 1.0)
        port_cot = [torch.randn_like(t, dtype=torch.float32).to(t.dtype) for t in port_out]
        port_wrt = (k, b, x)
        c_out, (c_h, c_c) = lstm(x16)
        c_cot = [port_cot[0].transpose(0, 1).half(), port_cot[2][None].half(),
                 port_cot[1][None].half()]
        c_wrt = (x16, *lstm.parameters())

        outs, _, _ = port_infer()
        c_ref, _ = cudnn_infer()
        rel = rel_err(c_ref, outs)
        iters = 10 if B >= 1024 else 20
        timed = {
            "cudnn_infer": cudnn_infer,
            "port_infer": port_infer,
            "cudnn_train_fwd": lambda: lstm(x16),
            "port_train_fwd": lambda: lstm_train.LstmLayerTrain.apply(k, b, x, seq, 1.0),
            "cudnn_bwd": lambda: torch.autograd.grad(
                [c_out, c_h, c_c], c_wrt, c_cot, retain_graph=True),
            "port_bwd": lambda: torch.autograd.grad(
                port_out, port_wrt, port_cot, retain_graph=True),
        }
        # the median of three runs in turns: a single run of cuDNN's
        # backward spread 2.5x between calls
        runs = {key: [] for key in timed}
        for _ in range(3):
            for key, fn in timed.items():
                runs[key].append(cuda_ms(fn, iters))
        ms = {key: float(np.median(v)) for key, v in runs.items()}
        library[name] = ms
        log(f"[10] {name} T={T} B={B} H={H} D={D}, full length: cuDNN f16 layer "
            f"inference {ms['cudnn_infer']:.4f} ms, training forward "
            f"{ms['cudnn_train_fwd']:.4f} ms, backward {ms['cudnn_bwd']:.4f} ms; the "
            f"port's layer {ms['port_infer']:.4f}, {ms['port_train_fwd']:.4f}, "
            f"{ms['port_bwd']:.4f} ms (cuDNN / port "
            f"{ms['cudnn_infer'] / ms['port_infer']:.2f}, "
            f"{ms['cudnn_train_fwd'] / ms['port_train_fwd']:.2f}, "
            f"{ms['cudnn_bwd'] / ms['port_bwd']:.2f}); cuDNN outs vs the port's, "
            f"max|diff| of max {rel:.3g} ({smi})")
        if not rel <= TOL_CUDNN_REL:
            raise AssertionError(f"{name}: cuDNN's layer computes another function ({rel})")
        del xs, kernel, x16, lstm, k, b, x, port_out, c_out, c_h, c_c
    log("[10] lstm_chunk_scan_int8: no PyTorch call computes it on CUDA")
    return library


# ------------------------------------------ phase 11: the convergence gate
#
# The port's scripts/acceptance_run.py at its recipe (the flagship in bf16,
# 30 epochs at batch 128 over 2048 learnable videos, then the held-out
# 512) through cli.train and cli.validate on the card; its bands decide.


def phase_gate(smi: str) -> None:
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_gate")
    shutil.rmtree(workdir, ignore_errors=True)
    for fn in COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        result = acceptance_run.run(workdir, device="cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in COUNTERS.items()}
    epoch = result["epoch"]
    steps = result["steps"]
    log(f"[11] gate: train GAP >= {acceptance_run.CONVERGED_GAP} first at step "
        f"{result['first_converged_step']}; last logged {result['last']} of "
        f"{len(steps)} logged steps; held-out student Hit@1 {epoch.get('avg_hit_at_one'):.4f}, "
        f"PERR {epoch.get('avg_perr'):.4f}, GAP {epoch.get('gap'):.4f}, mAP "
        f"{result['map']:.4f}; trajectory sha1 {result['trajectory_sha1']} "
        f"({result['trajectory_steps']} steps); launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items())
        + f"; wall {wall:.1f} s (" + ", ".join(
            f"{k} {v:.1f} s" for k, v in result["seconds"].items()) + f") ({smi})")
    batches = acceptance_run.NUM_EPOCHS * acceptance_run.TRAIN_VIDEOS // 128
    levels = 4  # wrapper calls per tower forward: 2 levels x 2 layers
    want = {"lstm_train_fwd": 2 * levels * batches, "lstm_train_bwd": 2 * levels * batches,
            "lstm_chunk_scan": 2 * levels * acceptance_run.HELDOUT_VIDEOS // 128,
            "lstm_chunk_scan_int8": 0}
    if counts != want:
        raise AssertionError(f"gate: kernel launches {counts}, expected {want}")
    if steps != list(range(2, 2 * batches + 1, 2)):
        raise AssertionError(f"gate: logged steps {steps[:3]}..{steps[-3:]} ({len(steps)})")
    acceptance_run.check_bands(result)
    log("[11] acceptance bands: OK")


def jax_package_files():
    """The files under the JAX package's directory (beside this script),
    or None where there is none."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "efficientvideoclassification_youtube8m_tpu")
    if not os.path.isdir(root):
        return None
    return sorted(os.path.join(d, f) for d, _, files in os.walk(root) for f in files)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    jax_files = jax_package_files()
    smi = phase_card()
    worst, times = phase_kernel()
    launches = phase_serving(smi)
    train_worst, train_times = phase_train_kernels()
    train_launches, step_rate = phase_distill(smi)
    int8_worst, int8_times = phase_int8_kernel()
    int8_launches = phase_int8_serving(smi)
    phase_routing()
    phase_pipeline(smi, step_rate)
    library = phase_library(smi)["student_L1"]
    phase_gate(smi)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "msgpack", "efficientvideoclassification_youtube8m_tpu"))
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    if jax_package_files() != jax_files:
        raise AssertionError("the run wrote into the JAX package's directory")
    log("[11] no module of jax, flax, msgpack or the JAX package loaded; nothing "
        "written into the JAX package's directory")
    # The line's times are at student_L1 (T=6, B=1280, H=1024), the
    # student's first layer at batch 256. "ms" and "plain_ms" are eager
    # calls, "graph_ms" the kernel's graph replay. library_ms is cuDNN's
    # whole layer there (phase 10), which also does the x @ Wx product
    # (and in the backward the weight and input gradients); the port's
    # layer of the same scope is "port_layer_ms".
    _, T, B, H, _ = LAYER_SHAPES[0]
    train_ms = train_times["student_L1"]
    rows = [
        ("lstm_chunk_scan", "lstm_chunk_scan.cu", "72", launches, worst,
         *times["student_L1"], library["cudnn_infer"], library["port_infer"]),
        ("lstm_train_fwd", "lstm_train.cu", "230", train_launches[0], train_worst["fwd"],
         train_ms["fwd"], train_ms["fwd_graph"], train_ms["fwd_plain"],
         library["cudnn_train_fwd"], library["port_train_fwd"]),
        ("lstm_train_bwd", "lstm_train.cu", "333", train_launches[1], train_worst["bwd"],
         train_ms["bwd"], train_ms["bwd_graph"], train_ms["bwd_plain"],
         library["cudnn_bwd"], library["port_bwd"]),
        ("lstm_chunk_scan_int8", "lstm_chunk_scan_int8.cu", "475", int8_launches,
         int8_worst, *int8_times["student_L1"], None, None),
    ]
    kernels = []
    for name, source, line, count, err, k_ms, replay_ms, p_ms, lib_ms, layer_ms in rows:
        b = bounds.bound(name, T, B, H)
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC + source,
            "replaces": PALLAS + line, "launches": count, "max_abs_err": err,
            "ms": k_ms, "graph_ms": replay_ms, "plain_ms": p_ms, "bound_ms": b["ms"],
            "bound_by": b["bound_by"], "library_ms": lib_ms, "port_layer_ms": layer_ms})
    log(f"[1] card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
