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
     student and teacher layer shapes, a ragged one and the two layers of
     the LSTM baseline's eval (`LstmModel`, 300 steps at batch 256), with
     times, each beside its bound (ops/kernels/bounds.py), its share of
     the bound, its TFLOP/s and the earlier design's time from PERF.md;
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
     counts set to 0 just before it and checked just after: (a) the
     port's scripts/fidelity_check.py's run (10 synthetic videos a split
     at flagship widths, batch 5, its canonical flags and its bands
     against the reference's golden log), then validate, convert (the student
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
     exact train-kernel launch counts;
 12. the model zoo at the flagship's widths, batch 256, bf16 (the
     reference's DBoF flags; NetVLAD and NeXtVLAD at the JAX package's
     defaults): (a) FrameLevelLogisticModel, DbofModel, NetVLADModel and
     NeXtVLADModel through cli.finetune --start_new_model (4 steps) and
     cli.eval (600 videos) with their own rate lines, and one finetune
     step of each on the card against the CPU from one init; (b) the
     flagship with the LogisticModel, SingleHiddenLayerModelDropout
     (keep 0.5) and SplitSingleHiddenLayerModel heads: kernel path
     against plain path (phase 6's bars; the same dropout masks), 8 + 8
     train launches a step, step times, then cli.train with the dropout
     head on 9b's shards; (c) 2048 aggregated videos through cli.finetune,
     cli.eval and cli.infer --frame_features=False for three video-level
     models, then cli.train_ensemble and cli.inference_ensemble over
     their CSVs, the ensemble's rows on the card against the same head
     run on the CPU. Phase 9's directory lives until the end;
 13. checkpoint interop at the flagship's width: (a) cli.train 2 steps
     from the JAX package's seed-0 init on 9b's shards, cli.export_tf of
     both towers (TF-V2 bundles), then Predictor.from_checkpoint over the
     bundles' directories (bf16 and int8, teacher and student; a teacher
     of the student-only bundle refused), cli.validate and cli.eval over
     them, each against the msgpack checkpoint of the same step bit for
     bit with its kernel launches; the bundle imported into a card state
     and exported again, byte for byte the first export; export and
     import GiB/s; (b) the student's finetune state at
     --moe_num_mixtures 13 (6.35 GiB with its Adam slots, three leaves
     over flax's 2**30-byte limit) saved in flax's chunked form and
     restored into another card state bit for bit, with GiB/s;
 14. data-parallel runs: (a) cli.train 4 steps in one process and in an
     NCCL group of one rank joined from MASTER_ADDR/RANK/WORLD_SIZE,
     parameters and Adam slots compared to the last bit, the step rates
     in turns and the all-reduce of one step under the profiler; (b) two
     gloo ranks sharing the card (subprocesses of this script,
     `--dp-worker`) at lstm_cells 256, batch 64: one distill step and one
     synced-BN DBoF finetune step against one process on the whole batch
     (phase 6's bars on the gradients of an SGD step), and eval rows
     gathered over the ranks against one process's rows; (c) the Chrome
     trace phase 6 wrote through utils/profiling.trace names
     lstm_step_kernel and lstm_bwd_step_kernel;
 15. gloo groups of ranks sharing the card (`--mesh-worker`): (a)
     data- and sequence-parallel Predictors against one process; (b)
     tensor-parallel steps, cli.train and cli.eval at --model_parallelism 2
     against one process;
 16. (a) `--steps_per_dispatch 4` against 1 on 9b's checkpoint and its 21
     batches of 256 (the last stack padded with dummy batches): cli.eval
     bf16 and int8 and cli.validate (every epoch metric bit-equal but
     avg_loss, within 1e-6 relative) and cli.infer (device-top-k rows
     within 1e-5 of the host ranking's), each with its own rate line and
     kernel launches; (b) cli.train --checkpoint_format orbax for 2 steps,
     its directory restored into a card state bit for bit as a msgpack
     save and restore of the same state, with save and restore GiB/s;
     cli.eval, inspect_checkpoint and Predictor.from_checkpoint over the
     directory against the msgpack file; the committed JAX-written orbax
     directories (tests/fixtures/orbax_jax) read bit for bit through the
     card's libzstd;
 17. the port's bash drivers as a user runs them (scripts/run_train.sh,
     run_validate.sh, run_convert_model.sh, run_finetune.sh, run_eval.sh
     at their default directories, which chain, over 9b's shards joined
     into one file a split), each exiting 0 and leaving its checkpoint,
     backup and log file; each driver's argv (recorded by a fake python)
     again in this process with its exact kernel launches (train 16 + 16,
     validate 24, finetune 8 + 8, eval 12), the finetuned leaves, the
     epoch lines and summaries and the train losses bit-equal to the
     drivers'; then run_train_multihost.sh as one rank writing an orbax
     directory, its losses equal to run_train.sh's; each driver's wall
     and `time` seconds;
 18. the YouTube-8M LSTM baseline (`--model LstmModel`, 2 x 1024 cells,
     MoE of 2 over 4716 classes) at its published widths through
     cli.eval, cli.validate and cli.infer at batch 256 over two batches of
     full-frame videos (300 frames, every_n 1), each with the scan's
     launch count set to 0 just before it and checked just after (2, 4
     and 2 calls a batch), cli.eval's epoch traced for its 600 kernel
     steps a batch;
 19. Gated NetVLAD (`--model GatedNetVLADModel`, 333.2 M parameters at
     the constructor's published widths) through cli.eval, cli.validate
     and cli.infer at batch 256 over two batches of full-frame videos,
     each traced: its four `gnetvlad.*` spans once a forward, inside
     `step.eval`. Last, no module of jax, flax, msgpack or the JAX
     package is loaded and nothing was written into the JAX package's
     directory.

Any failure raises, so the exit code is not 0. The line before the last
is {"kernels": [...]}; the last is {"ok": true, "device": {...}}. With no
CUDA device the script stops before it measures anything.
"""

from __future__ import annotations

import contextlib
import copy
import datetime
import glob
import hashlib
import io
import json
import logging
import math
import mmap
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch import data as port_data
from efficientvideoclassification_youtube8m_torch import ensemble
from efficientvideoclassification_youtube8m_torch.cli import convert as convert_cli
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import export_tf as export_tf_cli
from efficientvideoclassification_youtube8m_torch.cli import finetune as finetune_cli
from efficientvideoclassification_youtube8m_torch.cli import flags
from efficientvideoclassification_youtube8m_torch.cli import hash_check as hash_check_cli
from efficientvideoclassification_youtube8m_torch.cli import infer as infer_cli
from efficientvideoclassification_youtube8m_torch.cli import inference_bias as inference_bias_cli
from efficientvideoclassification_youtube8m_torch.cli import (
    inference_ensemble as inference_ensemble_cli,
)
from efficientvideoclassification_youtube8m_torch.cli import (
    inspect_checkpoint as inspect_checkpoint_cli,
)
from efficientvideoclassification_youtube8m_torch.cli import max_ensemble as max_ensemble_cli
from efficientvideoclassification_youtube8m_torch.cli import train as train_cli
from efficientvideoclassification_youtube8m_torch.cli import train_ensemble as train_ensemble_cli
from efficientvideoclassification_youtube8m_torch.cli import validate as validate_cli
from efficientvideoclassification_youtube8m_torch.data import native, tf_checkpoint
from efficientvideoclassification_youtube8m_torch.metrics.eval_util import (
    train_step_metrics,
)
from efficientvideoclassification_youtube8m_torch.ops.kernels import _build
from efficientvideoclassification_youtube8m_torch.ops.kernels import bounds, layout
from efficientvideoclassification_youtube8m_torch.ops import prng, quantize
from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan
from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan_int8
from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_train
from efficientvideoclassification_youtube8m_torch.models import frame_level
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.ops.collectives import BUCKET_BYTES
from efficientvideoclassification_youtube8m_torch.parallel.mesh import (
    create_mesh,
    shard_state,
)
from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (
    DISTILL_SCALARS,
    build_sharded_distill_step,
    build_sharded_finetune_step,
)
from efficientvideoclassification_youtube8m_torch.serving import (
    Predictor,
    TrainConfig,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.train import (
    checkpoint,
    msgpack_io,
    orbax_io,
    tf_export,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import (
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    StudentState,
    init_distill_state,
    params_of,
    state_tree,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.scripts import acceptance_run, fidelity_check
from efficientvideoclassification_youtube8m_torch.utils import profiling
from efficientvideoclassification_youtube8m_torch.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_torch.train.step import (
    build_distill_train_step,
    build_eval_step,
    build_finetune_step,
    build_quantized_eval_step,
    distill_loss_and_grads,
)

CSRC = "efficientvideoclassification_youtube8m_torch/ops/csrc/"
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_trace")
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
# The two layers of the LSTM baseline's eval at batch 256 (`LstmModel`,
# the benchmark's lstm_eval.b256): 300 steps, D_in 1152 and then 1024.
LSTM_EVAL_SHAPES = [
    ("lstm_eval_L1", 300, 256, 1024, 1152),
    ("lstm_eval_L2", 300, 256, 1024, 1024),
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


def check_scan_case(name, T, B, H, D, gen, tag: str = "2"):
    """The forward-only kernel against its plain version on one layer's
    inputs (`layer_case`): the masking, and the outputs and finals within
    TOL_OUTS and TOL_FINALS. Returns (the inputs, the differences)."""
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
    log(f"[{tag}] {name} T={T} B={B} H={H}: max|diff| outs {err['outs']:.3g} "
        f"c_fin {err['c_fin']:.3g} h_fin {err['h_fin']:.3g}; "
        f"zeros past seq {zeros_past_seq}, zero state at seq 0 {zero_state}")
    if not (zeros_past_seq and zero_state):
        raise AssertionError(f"{name}: masking is wrong")
    if not all(map(math.isfinite, err.values())):
        raise AssertionError(f"{name}: non-finite difference {err}")
    if err["outs"] > TOL_OUTS or max(err["c_fin"], err["h_fin"]) > TOL_FINALS:
        raise AssertionError(f"{name}: kernel and plain version disagree: {err}")
    return args, err


def phase_kernel():
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    times = {}
    for name, T, B, H, D in LAYER_SHAPES + LSTM_EVAL_SHAPES:
        args, err = check_scan_case(name, T, B, H, D, gen)
        iters = 20 if B >= 256 else 5
        ms = cuda_ms(lambda: lstm_scan.lstm_chunk_scan(*args), iters)
        replay_ms = graph_ms(lambda: lstm_scan.lstm_chunk_scan(*args), iters)
        plain_ms = cuda_ms(lambda: lstm_scan.lstm_chunk_scan_reference(*args), iters)
        times[name] = (ms, replay_ms, plain_ms)
        log(f"[2] {name}: kernel {ms:.4f} ms (graph replay {replay_ms:.4f}), "
            f"plain {plain_ms:.4f} ms")
        if (name, T, B, H, D) in FLAGSHIP_SHAPES + LSTM_EVAL_SHAPES:
            log(f"[2] {name}: " + against_bound("lstm_chunk_scan", name, T, B, H, ms,
                                                replay_ms))
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


def distill_batch(cfg, n, seed, min_frames: int = 1):
    """n uint8 videos [n, 300, 1152] with num_frames in min_frames..300
    and about 3 labels a row, on the card."""
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, (n, cfg.max_num_frames, cfg.total_feature_size),
                         dtype=np.uint8)
    labels = rng.random((n, cfg.num_classes)) < 3.0 / cfg.num_classes
    nf = rng.integers(min_frames, cfg.max_num_frames + 1, n).astype(np.int32)
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


def profile_distill_step(step, state, batch, smi, logdir: str) -> str:
    """One distill step under torch.profiler, through the port's
    `utils/profiling.trace`: wall time, device time and busy share, device
    time by kind (STEP_KINDS) and the largest kernels. The step advances
    `state` like any other. Returns the Chrome trace written into
    `logdir` (phase 14c reads it)."""
    torch.cuda.synchronize()
    with profiling.trace(logdir, device="cuda") as trace:
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {evt.key: evt.self_device_time_total / 1e3
               for evt in trace.profile.key_averages()
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
    return trace.path


def distill_kernel_vs_plain(cfg, state, batch, tag: str):
    """`distill_loss_and_grads` on the kernel path and on the plain path
    from the same state and batch (the same dropout keys): the loss
    scalars within TOL_LOSS_REL + TOL_LOSS_ABS, every gradient within
    TOL_GRAD_REL of its max. Returns (the kernel path's losses, the
    gradient errors worst first, the kernel path's train launches)."""
    before = train_counts()
    k_ls, _, k_gt, k_gs = distill_loss_and_grads(cfg, state, *batch)
    delta = [a - b for a, b in zip(train_counts(), before)]
    p_ls, _, p_gt, p_gs = distill_loss_and_grads(cfg, state, *batch,
                                                 kernel_train_mode="off")
    loss_bad = [k for k in k_ls if abs(k_ls[k].item() - p_ls[k].item())
                > TOL_LOSS_REL * abs(p_ls[k].item()) + TOL_LOSS_ABS]
    log(f"[{tag}] distill losses, kernel path / plain path: " + "; ".join(
        f"{k} {k_ls[k].item():.6g} / {p_ls[k].item():.6g}" for k in k_ls))
    grad_err = {f"{tower}.{n}": rel_err(g[n], p[n])
                for tower, g, p in (("teacher", k_gt, p_gt), ("student", k_gs, p_gs))
                for n in g}
    top = sorted(grad_err.items(), key=lambda kv: -kv[1])
    log(f"[{tag}] gradients, kernel path vs plain path, max|diff| of max over "
        f"{len(grad_err)} tensors: worst " + ", ".join(
            f"{n} {v:.3g}" for n, v in top[:4]) + f"; median "
        f"{float(np.median(list(grad_err.values()))):.3g}; train launches of the kernel "
        f"path fwd {delta[0]} bwd {delta[1]} (tolerances: losses {TOL_LOSS_REL} "
        f"relative + {TOL_LOSS_ABS}, gradients {TOL_GRAD_REL})")
    if loss_bad or not all(math.isfinite(v) for v in grad_err.values()):
        raise AssertionError(f"[{tag}] kernel and plain distill losses disagree: {loss_bad}")
    if top[0][1] > TOL_GRAD_REL:
        raise AssertionError(f"[{tag}] kernel and plain distill gradients disagree: {top[:4]}")
    return k_ls, top, delta


def phase_distill(smi):
    cfg = TrainConfig(compute_dtype="bfloat16")
    B = cfg.batch_size
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt, prng.prng_key(0),
                               device="cuda")
    batch = distill_batch(cfg, B, seed=6)
    per_tower = 2 * cfg.lstm_layers  # train kernel launches of each kind

    k_ls, _, delta = distill_kernel_vs_plain(cfg, state, batch, "6")
    if delta != [2 * per_tower, 2 * per_tower]:
        raise AssertionError(f"the kernel path made {delta} train launches")

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
    trace_path = profile_distill_step(step, state, batch, smi, TRACE_DIR)

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
    return launches, rate, trace_path


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


def check_int8_case(name, T, B, H, D, gen, tag: str = "7"):
    """The int8 kernel against its plain version on one layer's inputs
    (`int8_layer_case`): the masking, and the outputs and finals within
    TOL_INT8_OUTS and TOL_INT8_FINALS. Returns (the inputs, the tile, the
    differences)."""
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
    log(f"[{tag}] {name} T={T} B={B} H={H}, tile {tile[0]}x{tile[1]}: max|diff| outs "
        f"{err['outs']:.3g} c_fin {err['c_fin']:.3g} h_fin {err['h_fin']:.3g}; zeros "
        f"past seq {zeros_past_seq}, zero state at seq 0 {zero_state}")
    if not (zeros_past_seq and zero_state):
        raise AssertionError(f"{name}: int8 masking is wrong")
    if not all(map(math.isfinite, err.values())):
        raise AssertionError(f"{name}: non-finite difference {err}")
    if err["outs"] > TOL_INT8_OUTS or max(err["c_fin"], err["h_fin"]) > TOL_INT8_FINALS:
        raise AssertionError(f"{name}: int8 kernel and plain version disagree: {err}")
    return args, tile, err


def phase_int8_kernel():
    """The int8 kernel against its plain version at every layer shape; at
    the flagship shapes its times beside the bf16 scan's at the same
    shape; its quantize pass on rows made to sit on rounding ties."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    times = {}
    for name, T, B, H, D in LAYER_SHAPES:
        args, tile, err = check_int8_case(name, T, B, H, D, gen)
        seq = args[4]
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
# 9a is the port's scripts/fidelity_check.py through the port's binaries:
# its data (10 synthetic videos a split at flagship widths), its canonical
# flags and its bands against the reference's golden log
# (fidelity_check.GOLDEN, STEP_RE and check_trajectory, the JAX script's).
# Two flags are added that change no number: every tick writes the
# summaries (the device histograms) and every step saves a checkpoint
# through the async saver.
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
    """The matches of `pattern` in the messages of one logger, which logs
    at INFO while it is captured."""

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
        self.level_before = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level_before)


def run_binary(tag: str, main_fn, argv, expected, phase: str = "9"):
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
    log(f"[{phase}] {tag}: {seconds:.3f} s; kernel launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items()))
    want = {name: expected.get(name, 0) for name in COUNTERS}
    if counts != want:
        raise AssertionError(f"{tag}: kernel launches {counts}, expected {want}")
    return result, seconds, counts


def flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(flat_leaves(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def same_leaves(a: dict, b: dict, what: str) -> int:
    """Every leaf of two trees bit-equal (dtype, shape and bytes). Returns
    the number of leaves compared."""
    a, b = flat_leaves(a), flat_leaves(b)
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: other leaves")
    for name, value in a.items():
        value, other = np.asarray(value), np.asarray(b[name])
        if other.dtype != value.dtype or other.shape != value.shape or not np.array_equal(
                value.reshape(-1).view(np.uint8), other.reshape(-1).view(np.uint8)):
            raise AssertionError(f"{what}: {name} is not bit-equal")
    return len(a)


def check_same_student(trained_path: str, converted_path: str) -> int:
    """Every student parameter of the converted file bit-equal to the
    trained file's. Returns the number of tensors compared."""
    return same_leaves(msgpack_io.load(trained_path)["params_student"],
                       msgpack_io.load(converted_path)["params_student"],
                       "the converted student")


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
            num_videos=fidelity_check.NUM_VIDEOS, seed=seed)
    train_pattern = os.path.join(data_dir, "train*.tfrecord")
    eval_pattern = os.path.join(data_dir, "validate*.tfrecord")
    train_dir = os.path.join(root, "model_train") + "/"
    levels = 4  # wrapper calls per tower forward: 2 levels x 2 layers
    batches = fidelity_check.NUM_VIDEOS // 5  # a split per epoch at batch 5
    seconds = {}

    with LogCapture("train", fidelity_check.STEP_RE) as capture:
        state, seconds["train"], _ = run_binary(
            "9a train", train_cli.main, fidelity_check.FLAGS + [
                "--train_dir", train_dir, "--train_data_pattern", train_pattern,
                "--start_new_model", "true", "--save_summaries_secs", "0",
                "--save_model_secs", "0"],
            {"lstm_train_fwd": 2 * levels * 2 * batches,
             "lstm_train_bwd": 2 * levels * 2 * batches})
    steps = {int(m[0]): dict(zip(("teacher", "l_rep", "l_pred", "l_ce"),
                                 map(float, m[1:]))) for m in capture.matches}
    log("[9] the bands of scripts/fidelity_check.py on steps 2 and 4:")
    if not fidelity_check.check_trajectory(steps):
        raise AssertionError("the fidelity bands of scripts/fidelity_check.py failed")
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
        "9a validate", validate_cli.main, fidelity_check.FLAGS + [
            "--train_dir", train_dir, "--eval_data_pattern", eval_pattern,
            "--run_once", "true"],
        {"lstm_chunk_scan": 2 * levels * batches})
    if epoch["epoch_id"] != want_step or not np.isfinite(epoch["avg_loss"]):
        raise AssertionError(f"validate epoch {epoch}")

    converted, seconds["convert"], _ = run_binary(
        "9a convert", convert_cli.main, fidelity_check.FLAGS + ["--train_dir", train_dir], {})
    finetune_dir = convert_cli.finetune_dir(train_dir)
    if converted != os.path.join(finetune_dir, "model.ckpt-0.msgpack"):
        raise AssertionError(f"convert wrote {converted}")
    n = check_same_student(trained, converted)
    log(f"[9] converted student bit-equal to the trained one ({n} tensors); "
        f"files: distill {os.path.getsize(trained)} B, student "
        f"{os.path.getsize(converted)} B")

    _, seconds["finetune"], _ = run_binary(
        "9a finetune", finetune_cli.main, fidelity_check.FLAGS + [
            "--train_dir", finetune_dir, "--train_data_pattern", train_pattern,
            "--num_epochs", "1", "--save_summaries_secs", "0"],
        {"lstm_train_fwd": levels * batches, "lstm_train_bwd": levels * batches})
    tuned = checkpoint.latest_checkpoint(finetune_dir)
    if not tuned.endswith(f"model.ckpt-{batches}.msgpack"):
        raise AssertionError(f"finetune wrote {tuned}")

    runs = {}
    for quant, kernel in (("none", "lstm_chunk_scan"), ("int8", "lstm_chunk_scan_int8")):
        runs[quant], seconds[f"eval {quant}"], _ = run_binary(
            f"9a eval --quantize {quant}", eval_cli.main, fidelity_check.FLAGS + [
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


def rows_within(rows_a, rows_b, tol: float, what: str) -> float:
    """Each class in both rows of a video within `tol`; a class in one
    row only sits within `tol` of the other row's last probability.
    Returns the largest difference."""
    if [vid for vid, _ in rows_a] != [vid for vid, _ in rows_b]:
        raise AssertionError(f"{what}: the CSVs hold other videos")
    worst = 0.0
    for (vid, a), (_, b) in zip(rows_a, rows_b):
        da, db = dict(a), dict(b)
        for c in set(da) | set(db):
            if c in da and c in db:
                diff = abs(da[c] - db[c])
            else:
                mine, other = (da[c], b) if c in da else (db[c], a)
                diff = max(0.0, mine - other[-1][1])
            worst = max(worst, diff)
    if worst > tol:
        raise AssertionError(f"{what}: the CSVs differ by {worst} (tolerance {tol})")
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
    cfg = flags.config_from_args(flags.base_parser("").parse_args(fidelity_check.FLAGS))
    levels, batches, top_k = 2 * cfg.lstm_layers, fidelity["batches"], cfg.top_k
    loader = port_data.FrameDataLoader(
        eval_pattern, batch_size=fidelity_check.NUM_VIDEOS, feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list, max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes, num_epochs=1, shuffle=False)
    (batch,) = list(loader)
    argv = fidelity_check.FLAGS + ["--train_dir", finetune_dir,
                                   "--input_data_pattern", eval_pattern]
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
    int8_worst = rows_within(rows["bf16"], rows["int8"], TOL_INT8_PREDICTIONS,
                             "9c int8 against bf16")
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


def write_scale_shards(root: str) -> str:
    """9b's shards under root/scale: SHARDS of each split. Returns the
    directory."""
    data_dir = os.path.join(root, "scale")
    os.makedirs(data_dir)
    for split, videos, seed in (("train", SCALE_TRAIN, 10), ("validate", SCALE_EVAL, 20)):
        for s in range(SHARDS):
            port_data.write_synthetic_frame_shard(
                os.path.join(data_dir, f"{split}-{s:04d}.tfrecord"),
                num_videos=videos // SHARDS, seed=seed + s)
    return data_dir


def phase_pipeline_scale(root: str, smi: str, step_rate: float):
    """9b: cli.train at batch 256, checkpoint I/O of its state, cli.eval
    bf16 and int8 of its student."""
    data_dir = write_scale_shards(root)
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


def phase_pipeline(root: str, smi: str, step_rate: float) -> None:
    fidelity = phase_pipeline_fidelity(root)
    phase_pipeline_infer(root, fidelity)
    phase_pipeline_scale(root, smi, step_rate)


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


# ------------------------------------------------- phase 12: the model zoo
#
# At the flagship's widths (D = 1152, 4716 classes, MoE 2, every_n 10,
# batch 256, bf16) and the reference's DBoF flags (cluster 8192, hidden
# 1024, 30 frames, max pooling, batch norm), NetVLAD and NeXtVLAD at the
# JAX package's defaults (64 clusters, hidden 1024; expansion 2, 8 groups):
# every TrainConfig default. 12b reads phase 9b's frame shards; 12a writes
# its own, alike but with at least every_n frames a video (YT8M videos
# hold 120 or more): FrameLevelLogisticModel divides by the student's
# frame count, which is 0 below every_n frames, and then gives NaN, in the
# JAX package and the reference alike (tests/test_torch_zoo.py).
ZOO_MODELS = ("FrameLevelLogisticModel", "DbofModel", "NetVLADModel", "NeXtVLADModel")
ZOO_HEADS = (("LogisticModel", 1.0), ("SingleHiddenLayerModelDropout", 0.5),
             ("SplitSingleHiddenLayerModel", 1.0))
ZOO_CPU_VIDEOS = 8
# 12a, one finetune step of the card against the CPU from one init: the
# label loss within 1e-3 relative; a parameter within 2.1 learning rates
# (TF-Adam's first step moves an element by about lr whatever its
# gradient, so a gradient element that rounds to the other sign on the
# other device moves 2 lr apart) with at most ZOO_SHARE_BAR of the elements
# beyond a tenth of lr; the moving statistics within 1e-6 absolute (the
# means of centred activations are ~1e-11, rounding alone, so no relative
# bar holds them; the variances are ~1).
TOL_ZOO_LOSS_REL = 1e-3
ZOO_PARAM_LRS = 2.1
ZOO_SHARE_BAR = 1e-3
TOL_ZOO_STATS = 1e-6
FINETUNE_STEP_RE = re.compile(r"training step (\d+)\|.*L_CE: (\S+)")
# 12c: 2048 aggregated videos (mean_rgb 1024 + mean_audio 128) in 4 shards
AGG_VIDEOS, AGG_SHARDS = 2048, 4
AGG_FLAGS = ["--frame_features", "false", "--feature_names", "mean_rgb, mean_audio"]
AGG_MODELS = ("LogisticModel", "MoeModel", "SingleHiddenLayerModel")
ENSEMBLE_HEADS = ("LinearRegressionEnsemble", "IndependentClassEnsemble")


def zoo_step_card_vs_cpu(model_name: str, smi: str) -> None:
    """12a: one `build_finetune_step` step of `model_name` on the card and
    on the CPU from one init (drawn on the card, copied) and one batch of
    ZOO_CPU_VIDEOS videos."""
    cfg = TrainConfig(model=model_name, compute_dtype="bfloat16")
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    card = init_model(cfg, prng.split(prng.prng_key(cfg.seed))[1], device="cuda")
    models = {"card": card, "cpu": copy.deepcopy(card).cpu()}
    batch = distill_batch(cfg, ZOO_CPU_VIDEOS, seed=12, min_frames=cfg.every_n)
    step = build_finetune_step(cfg, opt)
    out = {}
    for where, model in models.items():
        state = StudentState(model, opt.init(params_of(model)), 0, cfg.dropout)
        _, metrics = step(state, *(t.to(next(model.parameters()).device) for t in batch))
        out[where] = (metrics["student_label_loss"].item(),
                      {n: p.detach().cpu() for n, p in params_of(model).items()})
    (loss_card, card_p), (loss_cpu, cpu_p) = out["card"], out["cpu"]
    lr = cfg.base_learning_rate
    stats = [n for n in card_p if n.endswith(("moving_mean", "moving_var"))]
    worst = max(float((card_p[n] - cpu_p[n]).abs().max()) for n in card_p if n not in stats)
    beyond = sum(int(((card_p[n] - cpu_p[n]).abs() > lr / 10).sum()) for n in card_p
                 if n not in stats)
    total = sum(card_p[n].numel() for n in card_p if n not in stats)
    stats_err = max((float((card_p[n] - cpu_p[n]).abs().max()) for n in stats), default=0.0)
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"[12] 12a {model_name}: one finetune step of {ZOO_CPU_VIDEOS} videos, card / "
        f"CPU: label loss {loss_card:.6g} / {loss_cpu:.6g} (relative {loss_err:.3g}, bar "
        f"{TOL_ZOO_LOSS_REL}); parameters max|diff| {worst:.3g} (bar {ZOO_PARAM_LRS} lr = "
        f"{ZOO_PARAM_LRS * lr:.3g}), {beyond} of {total} elements beyond lr/10 (bar "
        f"{ZOO_SHARE_BAR} of them); {len(stats)} moving statistics, max|diff| "
        f"{stats_err:.3g} (bar {TOL_ZOO_STATS}) ({smi})")
    if (loss_err > TOL_ZOO_LOSS_REL or worst > ZOO_PARAM_LRS * lr
            or beyond > ZOO_SHARE_BAR * total or stats_err > TOL_ZOO_STATS
            or (model_name == "DbofModel") != bool(stats)):
        raise AssertionError(f"12a {model_name}: the card and the CPU disagree")


def run_finetune_eval(tag: str, name: str, argv, train_pattern: str, eval_pattern: str,
                      steps: int, expected=None):
    """cli.finetune --start_new_model, then cli.eval --run_once of its
    checkpoint, with their own rate lines. Returns (the eval epoch, the
    finetune's steady videos/s, the eval's examples/s)."""
    B = TrainConfig().batch_size
    train_dir = argv[argv.index("--train_dir") + 1]
    with LogCapture("finetune", FINETUNE_STEP_RE) as capture:
        run_binary(f"{tag} finetune {name}", finetune_cli.main, argv + [
            "--start_new_model", "true", "--train_data_pattern", train_pattern],
            expected or {}, phase="12")
    losses = [(int(n), float(v)) for n, v in capture.matches]
    if [n for n, _ in losses] != list(range(1, steps + 1)) or not all(
            math.isfinite(v) for _, v in losses):
        raise AssertionError(f"{tag} {name}: finetune logged {losses}")
    # its own Examples/Second by step; after the first, videos over summed time
    rates = read_scalars(train_dir, "global_step/Examples/Second")
    if sorted(rates) != list(range(1, steps + 1)):
        raise AssertionError(f"{tag} {name}: Examples/Second at steps {sorted(rates)}")
    later = [rates[s] for s in sorted(rates)[1:]]
    steady = len(later) * B / sum(B / r for r in later)
    with LogCapture("eval", EVAL_RATE_RE) as capture:
        epoch, _, _ = run_binary(f"{tag} eval {name}", eval_cli.main, argv + [
            "--run_once", "true", "--eval_data_pattern", eval_pattern], expected or {},
            phase="12")
    (eval_rate,) = [float(m[0]) for m in capture.matches]
    if epoch["epoch_id"] != steps or not all(
            math.isfinite(epoch[k]) and 0.0 <= epoch[k] <= 1.0 for k in EPOCH_KEYS):
        raise AssertionError(f"{tag} {name}: eval epoch {epoch}")
    log(f"[12] {tag} {name}: cli.finetune L_CE by step " + ", ".join(
        f"{n}: {v}" for n, v in losses) + "; Examples/Second by step " + ", ".join(
        f"{n}: {v:.1f}" for n, v in sorted(rates.items()))
        + f"; after the first step {steady:.1f} videos/s; cli.eval " + ", ".join(
        f"{k} {epoch[k]:.4f}" for k in EPOCH_KEYS) + f", {eval_rate:.1f} examples/s")
    return epoch, steady, eval_rate


def phase_zoo_frames(root: str, smi: str) -> dict:
    """12a: each frame model of the zoo through cli.finetune (4 steps over
    512 training videos, 2 epochs) and cli.eval (600 videos), then one
    finetune step on the card against the CPU."""
    data_dir = os.path.join(root, "zoo_frames")
    os.makedirs(data_dir)
    for split, videos, seed in (("train", SCALE_TRAIN, 40), ("validate", SCALE_EVAL, 50)):
        for s in range(SHARDS):
            port_data.write_synthetic_frame_shard(
                os.path.join(data_dir, f"{split}-{s:04d}.tfrecord"),
                num_videos=videos // SHARDS, seed=seed + s,
                min_frames=TrainConfig().every_n)
    train_pattern = os.path.join(data_dir, "train*.tfrecord")
    eval_pattern = os.path.join(data_dir, "validate*.tfrecord")
    steps = 2 * SCALE_TRAIN // TrainConfig().batch_size
    rates = {}
    for name in ZOO_MODELS:
        train_dir = os.path.join(root, f"zoo_{name}") + "/"
        _, rates[name], eval_rate = run_finetune_eval(
            "12a", name, ["--model", name, "--train_dir", train_dir, "--num_epochs", "2"],
            train_pattern, eval_pattern, steps)
        rates[f"{name} eval"] = eval_rate
        shutil.rmtree(train_dir)
        zoo_step_card_vs_cpu(name, smi)
    log("[12] 12a videos/s at batch 256 (finetune after its first step; eval): " + "; ".join(
        f"{name} {rates[name]:.1f}, {rates[name + ' eval']:.1f}" for name in ZOO_MODELS)
        + f" ({smi})")
    return rates


def phase_zoo_heads(root: str, smi: str) -> dict:
    """12b: the flagship with other heads on the train kernels: kernel
    path against plain path from one init (the same dropout masks), three
    steps of build_distill_train_step with their launches and times; then
    cli.train 4 steps with SingleHiddenLayerModelDropout."""
    per_step = 2 * 2 * TrainConfig().lstm_layers  # towers x levels x layers
    step_ms = {}
    for head, keep in ZOO_HEADS:
        cfg = TrainConfig(compute_dtype="bfloat16", video_level_classifier_model=head,
                          dropout=keep)
        opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
        state = init_distill_state(cfg, opt, prng.prng_key(0), device="cuda")
        batch = distill_batch(cfg, cfg.batch_size, seed=6)
        log(f"[12] 12b {head} (keep {keep}): one distill step, kernel path against "
            "plain path")
        _, _, delta = distill_kernel_vs_plain(cfg, state, batch, "12")
        if delta != [per_step, per_step]:
            raise AssertionError(f"12b {head}: the kernel path made {delta} train launches")
        step = build_distill_train_step(cfg, opt)
        seconds = []
        for i in range(3):
            before = train_counts()
            state, metrics, sec = timed_step(step, state, batch)
            seconds.append(sec)
            launches = [a - b for a, b in zip(train_counts(), before)]
            if launches != [per_step, per_step] or not math.isfinite(
                    metrics["total_student_loss"].item()):
                raise AssertionError(f"12b {head} step {i + 1}: launches {launches}, "
                                     f"loss {metrics['total_student_loss'].item()}")
        step_ms[head] = float(np.median(seconds[1:])) * 1e3
        log(f"[12] 12b {head} (keep {keep}): {per_step} + {per_step} train launches a "
            "step; steps " + ", ".join(
                f"{s * 1e3:.1f}" for s in seconds) + f" ms, median of steps 2-3 "
            f"{step_ms[head]:.1f} ms, {cfg.batch_size / step_ms[head] * 1e3:.1f} videos/s; "
            f"losses of step 3: teacher_label_loss "
            f"{metrics['teacher_label_loss'].item():.6g}, total_student_loss "
            f"{metrics['total_student_loss'].item():.6g} ({smi})")
        del state, step
    train_dir = os.path.join(root, "zoo_train") + "/"
    steps = 2 * SCALE_TRAIN // TrainConfig().batch_size
    with LogCapture("train", fidelity_check.STEP_RE) as capture:
        state, seconds, _ = run_binary("12b train SingleHiddenLayerModelDropout", train_cli.main, [
            "--train_dir", train_dir, "--num_epochs", "2", "--start_new_model", "true",
            "--train_data_pattern", os.path.join(root, "scale", "train*.tfrecord"),
            "--video_level_classifier_model", "SingleHiddenLayerModelDropout",
            "--dropout", "0.5"],
            {"lstm_train_fwd": per_step * steps, "lstm_train_bwd": per_step * steps},
            phase="12")
    if state.global_step != 2 * steps or len(capture.matches) != steps or not all(
            math.isfinite(float(v)) for m in capture.matches for v in m[1:]):
        raise AssertionError(f"12b cli.train: step {state.global_step}, {capture.matches}")
    log(f"[12] 12b cli.train SingleHiddenLayerModelDropout --dropout 0.5, {steps} steps in "
        f"{seconds:.3f} s: Teacher_Loss / L_REP / L_PRED / L_CE by step " + "; ".join(
            f"{m[0]}: " + " / ".join(m[1:]) for m in capture.matches))
    del state
    shutil.rmtree(train_dir)
    return {"step_ms": step_ms, "train_launches": per_step * steps}


def phase_zoo_aggregated(root: str, smi: str) -> dict:
    """12c: aggregated shards through cli.finetune, cli.eval and cli.infer
    --frame_features=False for three video-level models, then
    cli.train_ensemble and cli.inference_ensemble over their K = 3
    CSVs, the ensemble's rows on the card against the same head
    checkpoint run on the CPU."""
    agg_dir = os.path.join(root, "aggregated")
    os.makedirs(agg_dir)
    video_ids = sorted(
        video.video_id for s in range(AGG_SHARDS)
        for video in port_data.write_synthetic_aggregated_shard(
            os.path.join(agg_dir, f"agg-{s:04d}.tfrecord"),
            num_videos=AGG_VIDEOS // AGG_SHARDS, seed=30 + s))
    pattern = os.path.join(agg_dir, "agg-*.tfrecord")
    B = TrainConfig().batch_size
    steps = AGG_VIDEOS // B
    top_k = TrainConfig().top_k

    def sorted_rows(path, what):
        """The CSV's rows by video id (the readers interleave the shards)."""
        rows = sorted(read_csv(path))
        if [vid for vid, _ in rows] != video_ids or any(len(p) != top_k for _, p in rows):
            raise AssertionError(f"{what}: not one row of {top_k} pairs a video")
        return rows

    preds_dir = os.path.join(root, "aggregated_preds")
    os.makedirs(preds_dir)
    rates = {}
    for name in AGG_MODELS:
        train_dir = os.path.join(root, f"agg_{name}") + "/"
        argv = AGG_FLAGS + ["--model", name, "--train_dir", train_dir, "--num_epochs", "1"]
        _, rates[f"{name} finetune"], rates[f"{name} eval"] = run_finetune_eval(
            "12c", name, argv, pattern, pattern, steps)
        out = os.path.join(preds_dir, f"pred_{name}.csv")
        with LogCapture("infer", INFER_LINE_RE) as capture:
            _, seconds, _ = run_binary(f"12c infer {name}", infer_cli.main, argv + [
                "--input_data_pattern", pattern, "--output_file", out], {}, phase="12")
        done = [(int(n), float(t)) for n, t in capture.matches]
        sorted_rows(out, f"12c infer {name}")
        # its own last progress line (elapsed seconds printed to 0.01)
        rates[f"{name} infer"] = done[-1][0] / max(done[-1][1], 0.01)
        log(f"[12] 12c cli.infer {name}: {done[-1][0]} videos at {done[-1][1]:.2f} s of "
            f"its own clock, {rates[name + ' infer']:.1f} videos/s; {seconds:.3f} s for the "
            f"whole binary ({smi})")
    for head in ENSEMBLE_HEADS:
        head_path = os.path.join(root, f"head_{head}.msgpack")
        argv = AGG_FLAGS + ["--preds_pattern", os.path.join(preds_dir, "pred_*.csv"),
                            "--head_checkpoint", head_path]
        _, seconds, _ = run_binary(f"12c train_ensemble {head}", train_ensemble_cli.main,
                                   argv + ["--model", head, "--num_epochs", "1",
                                           "--train_data_pattern", pattern], {},
                                   phase="12")
        rows = {}
        for where in ("card", "cpu"):
            out = os.path.join(root, f"ensemble_{head}_{where}.csv")
            run_binary(f"12c inference_ensemble {head} ({where})", inference_ensemble_cli.main,
                       argv + ["--input_data_pattern", pattern, "--output_file", out]
                       + (["--device", "cpu"] if where == "cpu" else []), {}, phase="12")
            rows[where] = sorted_rows(out, f"12c inference_ensemble {head}")
        worst = rows_within(rows["card"], rows["cpu"], TOL_CSV, f"12c {head} card against CPU")
        log(f"[12] 12c {head} over K = 3 CSVs: trained in {seconds:.3f} s; "
            f"inference_ensemble rows on the card against the CPU, {len(rows['card'])} "
            f"videos: max|diff| {worst:.3g} (tolerance {TOL_CSV})")
    log("[12] 12c aggregated rates, videos/s at batch 256 (finetune after its first step; "
        "eval; infer): " + "; ".join(
            f"{name} {rates[name + ' finetune']:.1f}, {rates[name + ' eval']:.1f}, "
            f"{rates[name + ' infer']:.1f}" for name in AGG_MODELS) + f" ({smi})")
    return rates


def phase_zoo(root: str, smi: str) -> dict:
    t0 = time.perf_counter()
    frames = phase_zoo_frames(root, smi)
    heads = phase_zoo_heads(root, smi)
    aggregated = phase_zoo_aggregated(root, smi)
    log(f"[12] phase 12 wall {time.perf_counter() - t0:.1f} s")
    return {"frames": frames, "aggregated": aggregated, **heads}


# -------------------------------- phase 13: checkpoint interop on the card

INTEROP_SERVE = 300  # videos a Predictor serves in 13a: two chunks of 256


def bundle_bytes(prefix: str) -> int:
    return sum(os.path.getsize(prefix + s) for s in (".index", ".data-00000-of-00001"))


def same_bundle(a: str, b: str) -> bool:
    return all(open(a + s, "rb").read() == open(b + s, "rb").read()
               for s in (".index", ".data-00000-of-00001"))


def same_epoch(a: dict, b: dict) -> bool:
    """Every value of two epoch-metric dicts equal (the per-class APs of
    classes without positives are NaN in both)."""
    return sorted(a) == sorted(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]),
                       equal_nan=np.asarray(a[k]).dtype.kind == "f") for k in a)


def phase_interop(root: str, smi: str) -> dict:
    """13a: the flagship's TF-V2 interop. cli.train 2 steps from the JAX
    package's seed-0 init; cli.export_tf of both towers; Predictor
    (bf16, int8; teacher, student), cli.validate and cli.eval over the
    bundles' directories against the msgpack checkpoint of the same step,
    bit for bit; import, re-export and byte-compare; export and import
    GiB/s."""
    data_dir = os.path.join(root, "scale")
    cfg = TrainConfig()
    B, levels = cfg.batch_size, 2 * cfg.lstm_layers
    steps = SCALE_TRAIN // B
    train_dir = os.path.join(root, "interop_train") + "/"
    state, _, _ = run_binary("13a cli.train from the seed-0 init", train_cli.main, [
        "--train_dir", train_dir, "--num_epochs", "1", "--start_new_model", "true",
        "--train_data_pattern", os.path.join(data_dir, "train*.tfrecord")],
        {"lstm_train_fwd": 2 * levels * steps, "lstm_train_bwd": 2 * levels * steps},
        phase="13")
    step = state.global_step
    if step != 2 * steps:
        raise AssertionError(f"13a cli.train ended at step {step}")
    del state
    msgpack_path = checkpoint.latest_checkpoint(train_dir)
    bundles = {}
    for tower in ("distill", "student"):
        out_dir = os.path.join(root, f"interop_{tower}")
        bundles[tower], seconds, _ = run_binary(
            f"13a cli.export_tf --tower {tower}", export_tf_cli.main, [
                "--train_dir", train_dir, "--tower", tower,
                "--output_prefix", os.path.join(out_dir, "model.ckpt")], {}, phase="13")
        if bundles[tower] != os.path.join(out_dir, f"model.ckpt-{step}"):
            raise AssertionError(f"13a export named {bundles[tower]}")
        reader = tf_checkpoint.TFCheckpointReader(bundles[tower])
        log(f"[13] 13a {tower} bundle {os.path.basename(bundles[tower])}: "
            f"{len(reader.variable_names())} tensors, {bundle_bytes(bundles[tower])} B, "
            f"cli.export_tf {seconds:.3f} s in all")

    serve_cfg = TrainConfig(compute_dtype="bfloat16")
    (feats, nf), = requests((INTEROP_SERVE,), serve_cfg, seed=13)
    chunks = math.ceil(INTEROP_SERVE / SERVE_BATCH)
    counters = {"none": lstm_scan.lstm_chunk_scan, "int8": lstm_scan_int8.lstm_chunk_scan_int8}
    launches = {}
    for tower, quant in (("student", "none"), ("teacher", "none"), ("student", "int8"),
                         ("teacher", "int8")):
        probs = {}
        for where, directory in (("bundle", os.path.dirname(bundles["distill"])),
                                 ("msgpack", train_dir),
                                 ("student bundle", os.path.dirname(bundles["student"]))):
            if where == "student bundle" and tower == "teacher":
                try:
                    Predictor.from_checkpoint(directory, serve_cfg, tower="teacher",
                                              device="cuda")
                except ValueError as e:
                    log(f"[13] 13a the teacher of the student-only bundle: ValueError ({e})")
                    continue
                raise AssertionError("13a a student-only bundle served a teacher")
            predictor = Predictor.from_checkpoint(directory, serve_cfg, tower=tower,
                                                  serve_batch=SERVE_BATCH, device="cuda",
                                                  quantize=quant)
            counters[quant].launches = 0
            probs[where] = predictor.predict(feats, nf)
            torch.cuda.synchronize()
            launches[f"{tower} {quant}"] = counters[quant].launches
            if counters[quant].launches != levels * chunks:
                raise AssertionError(f"13a {tower} {quant} from the {where}: "
                                     f"{counters[quant].launches} launches")
            del predictor
        check_predictions(probs["bundle"], INTEROP_SERVE, serve_cfg.num_classes,
                          f"13a {tower} {quant}")
        same = {w: bool(np.array_equal(p, probs["msgpack"])) for w, p in probs.items()}
        log(f"[13] 13a Predictor {tower} {'bf16' if quant == 'none' else quant} over "
            f"{INTEROP_SERVE} videos: {levels * chunks} kernel launches each; predictions "
            "bit-equal to the msgpack checkpoint's: " + ", ".join(
                f"{w} {s}" for w, s in same.items()))
        if not all(same.values()):
            raise AssertionError(f"13a {tower} {quant}: bundle predictions differ")

    eval_batches = math.ceil(SCALE_EVAL / B)
    pattern = os.path.join(data_dir, "validate*.tfrecord")
    epochs = {}
    for name, main_fn, directory, expected in (
            ("validate over the bundle", validate_cli.main, os.path.dirname(bundles["distill"]),
             2 * levels * eval_batches),
            ("validate over the msgpack", validate_cli.main, train_dir, 2 * levels * eval_batches),
            ("eval over the student bundle", eval_cli.main,
             os.path.dirname(bundles["student"]), levels * eval_batches),
            ("eval over the msgpack", eval_cli.main, train_dir, levels * eval_batches)):
        # one batch order in every run: the epoch sums are compared bit for bit
        epochs[name], _, _ = run_binary(f"13a cli.{name}", main_fn, [
            "--train_dir", directory, "--run_once", "true", "--eval_data_pattern", pattern,
            "--deterministic_input", "true"], {"lstm_chunk_scan": expected}, phase="13")
    for kind in ("validate", "eval"):
        a = epochs[f"{kind} over the {'bundle' if kind == 'validate' else 'student bundle'}"]
        b = epochs[f"{kind} over the msgpack"]
        log(f"[13] 13a cli.{kind} epoch metrics, bundle / msgpack: " + "; ".join(
            f"{k} {a[k]:.6g} / {b[k]:.6g}" for k in EPOCH_KEYS + ("avg_loss",))
            + f"; every value bit-equal: {same_epoch(a, b)}")
        if not same_epoch(a, b) or a["epoch_id"] != step:
            raise AssertionError(f"13a cli.{kind}: the bundle's epoch metrics differ")

    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt, prng.prng_key(1), device="cuda")
    checkpoint.restore_checkpoint(msgpack_path, state)
    torch.cuda.synchronize()
    again = os.path.join(root, "interop_again", f"model.ckpt-{step}")
    t0 = time.perf_counter()
    tf_export.export_tf_checkpoint(again, state)
    export_s = time.perf_counter() - t0
    size = bundle_bytes(again)
    del state
    template = init_distill_state(cfg, opt, prng.prng_key(2), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore_checkpoint(bundles["distill"], template)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    roundtrip = os.path.join(root, "interop_roundtrip", f"model.ckpt-{step}")
    tf_export.export_tf_checkpoint(roundtrip, template)
    same = same_bundle(roundtrip, bundles["distill"]) and same_bundle(again, bundles["distill"])
    log(f"[13] 13a distill bundle {size} B ({size / 2**30:.3f} GiB): export of a card state "
        f"{export_s:.3f} s ({size / export_s / 2**30:.2f} GiB/s), import into a card state "
        f"{import_s:.3f} s ({size / import_s / 2**30:.2f} GiB/s); import then re-export "
        f"byte-equal to cli.export_tf's bundle: {same} ({smi})")
    if not same:
        raise AssertionError("13a the re-exported bundle differs from the export")
    del template
    for d in ("interop_again", "interop_roundtrip", "interop_distill", "interop_student"):
        shutil.rmtree(os.path.join(root, d))
    shutil.rmtree(train_dir)
    return {"export_gib_s": size / export_s / 2**30, "import_gib_s": size / import_s / 2**30,
            "bundle_bytes": size, "launches": launches}


def phase_chunked(root: str, smi: str) -> dict:
    """13b: the student's finetune state at --moe_num_mixtures 13, whose
    MoE gate weights and their Adam moments are over flax's 2**30-byte
    chunk limit: saved in flax's chunked form and restored into another
    card state, bit for bit."""
    cfg = TrainConfig(moe_num_mixtures=13)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)

    def student_state(seed):
        student = init_model(cfg, prng.prng_key(seed), device="cuda")
        return StudentState(student=student, opt_student=opt.init(params_of(student)),
                            global_step=0, dropout_keep_prob=cfg.dropout)

    state = student_state(2)
    gen = torch.Generator(device="cuda").manual_seed(13)
    for key in ("mu", "nu"):
        for t in state.opt_student[key].values():
            t.normal_(generator=gen)
    state.opt_student["count"], state.global_step = 3, 7
    leaves = list(params_of(state.student).values()) + [
        t for key in ("mu", "nu") for t in state.opt_student[key].values()]
    reckoned = sum(t.numel() * 4 for t in leaves)
    over = sum(t.numel() * 4 > msgpack_io.MAX_CHUNK_SIZE for t in leaves)
    directory = os.path.join(root, "chunked")
    os.makedirs(directory)
    free = shutil.disk_usage(directory).free
    log(f"[13] 13b student finetune state at --moe_num_mixtures 13: {len(leaves)} "
        f"float32 leaves, {reckoned} B ({reckoned / 2**30:.3f} GiB) reckoned, {over} over "
        f"the {msgpack_io.MAX_CHUNK_SIZE}-byte chunk limit; {free / 2**30:.1f} GiB free")
    if free < 1.5 * reckoned:
        raise AssertionError(f"13b needs {1.5 * reckoned / 2**30:.1f} GiB free on disk")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save_checkpoint(directory, state, state.global_step)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        marks, at = 0, mm.find(msgpack_io.CHUNKED.encode())
        while at >= 0:
            marks += 1
            at = mm.find(msgpack_io.CHUNKED.encode(), at + 1)
    if marks != over or over == 0:
        raise AssertionError(f"13b {marks} chunked leaves in the file, {over} expected")
    template = student_state(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.restore_checkpoint(path, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    want = state_tree_tensors(state)
    got = state_tree_tensors(template)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    if bad or template.global_step != 7 or template.opt_student["count"] != 3:
        raise AssertionError(f"13b restored leaves differ: {bad[:5]}")
    log(f"[13] 13b {os.path.basename(path)}: {size} B ({size / 2**30:.3f} GiB), {marks} "
        f"leaves chunked as flax chunks them; save {save_s:.3f} s "
        f"({size / save_s / 2**30:.2f} GiB/s), restore into a card state {restore_s:.3f} s "
        f"({size / restore_s / 2**30:.2f} GiB/s); all {len(want)} tensors bit-equal ({smi})")
    os.remove(path)
    return {"bytes": size, "save_gib_s": size / save_s / 2**30,
            "restore_gib_s": size / restore_s / 2**30}


def state_tree_tensors(state) -> dict:
    """The state's parameters and optimizer slots by path."""
    out = {f"student.{n}": t for n, t in state.student.state_dict().items()}
    for key in ("mu", "nu"):
        out.update({f"{key}.{n}": t for n, t in state.opt_student[key].items()})
    return out


# ------------------------------- phase 14: data-parallel and the trace

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def step_rates(steps, state, batch, per_step, turns: int = 3):
    """Each (name, step) of `steps` timed in turns, `turns` times, each
    step making `per_step` launches of each train kernel; videos/s by the
    median of the turns after the first. Returns (rates, state)."""
    seconds = {name: [] for name, _ in steps}
    for _ in range(turns):
        for name, fn in steps:
            before = train_counts()
            state, _, sec = timed_step(fn, state, batch)
            seconds[name].append(sec)
            launches = [a - b for a, b in zip(train_counts(), before)]
            if launches != [per_step, per_step]:
                raise AssertionError(f"the {name} step made {launches} train launches")
    return {k: batch[0].shape[0] / float(np.median(v[1:])) for k, v in seconds.items()}, state


def phase_world_one(root: str, smi: str) -> dict:
    """14a: cli.train at flagship width for 4 steps in a group of one
    rank on NCCL, initialized from the environment, against the same run
    in one process; then the data-parallel step's all-reduce under the
    profiler and its rate against the single-process step's."""
    data_dir = os.path.join(root, "scale")
    cfg = TrainConfig(compute_dtype="bfloat16")  # cli.train's default
    levels = 2 * cfg.lstm_layers
    steps = 2 * SCALE_TRAIN // cfg.batch_size
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    batch = distill_batch(cfg, cfg.batch_size, seed=6)
    plain_step = build_distill_train_step(cfg, opt)
    fresh = init_distill_state(cfg, opt, prng.prng_key(0), device="cuda")
    t_cpu = time.process_time()
    t_wall = time.perf_counter()
    before, fresh = step_rates([("plain", plain_step)], fresh, batch, 2 * levels)
    log(f"[14] 14a a fresh state's step before the runs: {before['plain']:.1f} videos/s "
        f"(process CPU over wall {(time.process_time() - t_cpu) / (time.perf_counter() - t_wall):.2f}, "
        f"{threading.active_count()} threads, "
        f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved)")
    del fresh
    argv = ["--num_epochs", "2", "--start_new_model", "true", "--deterministic_input", "true",
            "--train_data_pattern", os.path.join(data_dir, "train*.tfrecord")]
    expected = {"lstm_train_fwd": 2 * levels * steps, "lstm_train_bwd": 2 * levels * steps}
    single, single_s, _ = run_binary("14a cli.train, one process", train_cli.main, argv + [
        "--train_dir", os.path.join(root, "world1_single")], expected, phase="14")
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1"}
    os.environ.update(env)
    try:
        grouped, grouped_s, counts = run_binary(
            "14a cli.train, an NCCL group of one rank", train_cli.main, argv + [
                "--train_dir", os.path.join(root, "world1_group")], expected, phase="14")
        backend = torch.distributed.get_backend()
        if backend != "nccl" or torch.distributed.get_world_size() != 1:
            raise AssertionError(f"14a the group is {backend} of "
                                 f"{torch.distributed.get_world_size()}")
        diffs = {}
        for tower in ("teacher", "student"):
            want = getattr(single, tower).state_dict()
            for name, t in getattr(grouped, tower).state_dict().items():
                diffs[f"{tower}.{name}"] = (t.float() - want[name].float()).abs().max().item()
            for key in ("mu", "nu"):
                want = getattr(single, f"opt_{tower}")[key]
                for name, t in getattr(grouped, f"opt_{tower}")[key].items():
                    diffs[f"opt_{tower}.{key}.{name}"] = (t - want[name]).abs().max().item()
        worst = max(diffs.items(), key=lambda kv: kv[1])
        log(f"[14] 14a {steps} steps, global step {grouped.global_step} / "
            f"{single.global_step}: the group of one against one process, "
            f"{len(diffs)} tensors, largest |diff| {worst[1]:.3g} ({worst[0]}); "
            f"cli.train {grouped_s:.3f} s against {single_s:.3f} s")
        if worst[1] != 0.0 or grouped.global_step != single.global_step:
            raise AssertionError(f"14a the group of one differs from one process: {worst}")
        del single
        dp_step = build_sharded_distill_step(cfg, opt, create_mesh(device="cuda"))
        t_cpu = time.process_time()
        t_wall = time.perf_counter()
        rate, grouped = step_rates([("group", dp_step), ("plain", plain_step)], grouped,
                                   batch, 2 * levels)
        log(f"[14] 14a steps in turns on cli.train's state, median of turns 2-3: group of "
            f"one {rate['group']:.1f} videos/s, one process {rate['plain']:.1f} videos/s "
            f"({rate['group'] / rate['plain']:.3f}); process CPU over wall "
            f"{(time.process_time() - t_cpu) / (time.perf_counter() - t_wall):.2f}, "
            f"{threading.active_count()} threads, "
            f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved ({smi})")
        with profiling.trace(os.path.join(root, "world1_trace"), device="cuda") as t:
            grouped, _ = dp_step(grouped, *batch)
        events = [e for e in t.profile.key_averages()
                  if "nccl" in e.key.lower() or "allreduce" in e.key.lower()]
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        calls = [e for e in events if e.key == "nccl:all_reduce"]
        host_ms = sum(e.cpu_time_total for e in calls) / 1e3
        ncalls = sum(e.count for e in calls)
        log(f"[14] 14a one data-parallel step under the profiler: {ncalls} NCCL all-reduce "
            f"calls (gradient buckets of {BUCKET_BYTES // 2**20} MiB, the loss scalars): "
            f"device time {device_ms:.3f} ms, host time {host_ms:.3f} ms a step; events "
            + ", ".join(sorted({e.key[:40] for e in events})) + f" ({smi})")
        if ncalls < 2:
            raise AssertionError(f"14a the profile shows {ncalls} all-reduce calls")
    finally:
        distributed.shutdown()
        for key in env:
            os.environ.pop(key, None)
    for d in ("world1_single", "world1_group", "world1_trace"):
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    return {"allreduce_ms": device_ms, "allreduce_host_ms": host_ms, "rate": rate,
            "launches": counts}


# 14b: two ranks on one card over gloo (NCCL refuses two ranks on one
# device) at a reduced width; the bars are phase 6's (gradients, recovered
# from one SGD step as (before - after) / lr, within TOL_GRAD_REL of their
# max; losses TOL_LOSS_REL + TOL_LOSS_ABS).
DP_CFG = dict(lstm_cells=256, batch_size=64, compute_dtype="bfloat16",
              optimizer="GradientDescentOptimizer")
DP_DBOF = dict(DP_CFG, model="DbofModel", sync_batch_norm=True)
DP_SEEDS = {"distill": 31, "dbof": 32, "eval": 33}


def even_sampler(x, nf, k, rng):
    return frame_level.sample_even_frames(x, nf, k)


def dp_cases(mesh, rows, cases=("distill", "dbof", "eval")) -> dict:
    """The 14b cases on `mesh` (`rows` picks this rank's slice of a global
    batch): a distill step and a synced-BN DBoF finetune step by SGD
    (their recovered gradients, moving statistics and losses), and the
    eval rows of a bf16 student (gathered over the mesh's ranks)."""
    out = {}
    for case in [c for c in cases if c != "eval"]:
        cfg = TrainConfig(**(DP_CFG if case == "distill" else DP_DBOF))
        opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
        state = init_distill_state(cfg, opt, prng.prng_key(0), device="cuda")
        if case == "dbof":
            state = student_state_from_distill(state, opt)
        towers = ("teacher", "student") if case == "distill" else ("student",)
        before = {f"{t}.{n}": p.detach().clone() for t in towers
                  for n, p in params_of(getattr(state, t)).items()}
        batch = rows(distill_batch(cfg, cfg.batch_size, seed=DP_SEEDS[case]))
        build = build_sharded_distill_step if case == "distill" else build_sharded_finetune_step
        state, metrics = build(cfg, opt, mesh)(state, *batch)
        after = {f"{t}.{n}": p.detach() for t in towers
                 for n, p in params_of(getattr(state, t)).items()}
        for name, p in before.items():
            if "moving_" in name:  # written by their average, not by SGD
                out[f"{case}/stat/{name}"] = after[name].float().cpu().numpy()
            else:
                out[f"{case}/grad/{name}"] = (
                    (p - after[name]) / cfg.base_learning_rate).float().cpu().numpy()
        out.update({f"{case}/loss/{k}": np.float64(v.item()) for k, v in metrics.items()
                    if k in DISTILL_SCALARS})
        del state
    if "eval" in cases:
        cfg = TrainConfig(**DP_CFG)
        student = init_model(cfg, prng.prng_key(4), device="cuda")
        feats, labels, nf = rows(distill_batch(cfg, cfg.batch_size, seed=DP_SEEDS["eval"]))
        out_eval = build_eval_step(cfg)(student, feats, labels, nf)
        gathered = distributed.gather_step_outputs(out_eval, labels.cpu().numpy(), 0)
        out.update({f"eval/{k}": v for k, v in gathered.items()})
    return out


def dp_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of 14b (`python3 chip_smoke.py --dp-worker RANK PORT DIR`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", 2, rank, device=torch.device("cuda", 0),
                           backend="gloo", timeout=datetime.timedelta(seconds=300))
    frame_level.sample_random_frames = even_sampler
    probe = torch.full((4,), float(rank + 1), device="cuda")
    torch.distributed.all_reduce(probe)
    if probe.tolist() != [3.0] * 4:
        raise AssertionError(f"gloo all_reduce of a CUDA tensor gave {probe.tolist()}")
    mesh = create_mesh(device="cuda")

    def rows(batch):
        n = batch[0].shape[0] // 2
        return tuple(t[rank * n:(rank + 1) * n] for t in batch)

    out = dp_cases(mesh, rows)
    out.update({f"launches/{k}": np.int64(fn.launches) for k, fn in COUNTERS.items()})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    distributed.shutdown()
    print(f"DP_WORKER_OK {rank} backend gloo, CUDA tensors all-reduced", flush=True)


def phase_two_ranks(root: str, smi: str) -> dict:
    """14b: two gloo ranks sharing the card against one process."""
    out_dir = os.path.join(root, "two_ranks")
    os.makedirs(out_dir)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", str(rank), str(port),
         out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise AssertionError("14b a rank timed out")
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"DP_WORKER_OK {rank}" not in text:
            raise AssertionError(f"14b rank {rank} failed:\n{text[-4000:]}")
    wall = time.perf_counter() - t0
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in (0, 1)]
    if sorted(ranks[0]) != sorted(ranks[1]) or not all(
            np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0]):
        raise AssertionError("14b the two ranks hold different results")
    got = ranks[0]
    # a distill step: 2 towers x 2 levels x 2 layers of each train kernel;
    # the DBoF step none; the eval step 2 levels x 2 layers of the scan
    want_launches = {"lstm_train_fwd": 8, "lstm_train_bwd": 8, "lstm_chunk_scan": 4,
                     "lstm_chunk_scan_int8": 0}
    launches = {k: int(got.pop(f"launches/{k}")) for k in COUNTERS}
    ranks[1] = {k: v for k, v in ranks[1].items() if not k.startswith("launches/")}
    if launches != want_launches:
        raise AssertionError(f"14b a rank's kernel launches {launches}, not {want_launches}")
    original = frame_level.sample_random_frames
    frame_level.sample_random_frames = even_sampler
    try:
        whole = dp_cases(create_mesh(device="cuda"), lambda batch: batch)
        halves = [dp_cases(create_mesh(device="cuda"),
                           lambda batch, r=r: tuple(t[r * 32:(r + 1) * 32] for t in batch),
                           cases=("eval",))
                  for r in (0, 1)]
    finally:
        frame_level.sample_random_frames = original
    report = {}
    for case in ("distill", "dbof"):
        grads = {k: v for k, v in whole.items() if k.startswith(f"{case}/grad/")}
        # a gradient that cancels analytically (an offset whose shift the
        # next batch norm removes) is rounding noise in both runs: each
        # tensor is held against its own max or 1e-3 of the step's largest
        # gradient, whichever is larger
        floor = 1e-3 * max(float(np.abs(v).max()) for v in grads.values())
        errs = {k: float(np.abs(got[k] - v).max()) / max(float(np.abs(v).max()), floor)
                for k, v in grads.items()}
        floored = [k.split("/")[-1] for k, v in grads.items()
                   if float(np.abs(v).max()) < floor]
        stats = [float(np.abs(got[k] - whole[k]).max()) for k in whole
                 if k.startswith(f"{case}/stat/")]
        losses = {k: (got[k], whole[k]) for k in whole if k.startswith(f"{case}/loss/")}
        bad = [k for k, (a, b) in losses.items()
               if abs(a - b) > TOL_LOSS_REL * abs(b) + TOL_LOSS_ABS]
        worst = max(errs.items(), key=lambda kv: kv[1])
        report[case] = worst[1]
        log(f"[14] 14b {case}: two gloo ranks on one card (32 videos each) against one "
            f"process on the 64: losses " + "; ".join(
                f"{k.split('/')[-1]} {a:.6g} / {b:.6g}" for k, (a, b) in losses.items())
            + f"; gradients over {len(errs)} tensors, worst {worst[0]} {worst[1]:.3g} of "
            f"its max (under the floor of {floor:.3g}: {floored or 'none'})"
            + (f"; moving statistics max|diff| {max(stats):.3g}" if stats else "")
            + f" (bars: losses {TOL_LOSS_REL} + {TOL_LOSS_ABS}, gradients {TOL_GRAD_REL})")
        if bad or worst[1] > TOL_GRAD_REL or (stats and max(stats) > 1e-3):
            raise AssertionError(f"14b {case}: the two ranks miss the bars ({bad}, {worst})")
    for key in [k for k in got if k.startswith("eval/")]:
        want = np.concatenate([h[key] for h in halves])
        if not np.array_equal(got[key], want):
            raise AssertionError(f"14b gathered {key} differs from the single-process rows")
    spread = float(np.abs(got["eval/topk_val"] - whole["eval/topk_val"]).max())
    log(f"[14] 14b eval: {got['eval/topk_val'].shape[0]} gathered rows bit-equal to one "
        f"process's rows of the same two halves; top-k values against the whole batch in one "
        f"call max|diff| {spread:.3g} (the kernels' row tiles differ); both ranks' outputs "
        f"identical; {wall:.1f} s for the two ranks ({smi})")
    shutil.rmtree(out_dir)
    return report


def phase_trace(trace_path: str) -> None:
    """14c: the Chrome trace phase 6 wrote through utils/profiling.trace
    names the train kernels."""
    with open(trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    found = {k: any(k in n for n in names) for k in ("lstm_step_kernel",
                                                     "lstm_bwd_step_kernel")}
    log(f"[14] 14c {os.path.basename(trace_path)} ({os.path.getsize(trace_path)} B, "
        f"{len(names)} event names): " + ", ".join(f"{k} {v}" for k, v in found.items()))
    if not all(found.values()):
        raise AssertionError(f"14c the trace lacks {found}")
    shutil.rmtree(os.path.dirname(trace_path))


# ------------------------------ phase 15: serving and training over a mesh
#
# Gloo ranks share the one card, spawned as 14b's are (`python3
# chip_smoke.py --mesh-worker GROUP RANK WORLD PORT ROOT`): NCCL refuses
# two ranks on one device, so nothing here is a speed of tensor or
# sequence parallelism, only its correctness at the flagship's widths.
# Each rank holds its path against one process on the same card: 15a the
# data- and sequence-parallel Predictors against the one-process Predictor
# on the same request (TOL_PREDICTIONS); 15b one SGD distill step on a
# (data 1, model 2) mesh with the default min_dim, so that the MoE head
# is sharded and the LSTMs run in the train kernels on every rank, and a
# (2, 2) mesh at 14b's reduced width, against the one-process step from
# the same init (14b's bars on the recovered gradients and the losses);
# then cli.train --model_parallelism 2 for 2 SGD steps over 9b's shards,
# held against one process's cli.train on the same rows (the same bars,
# the logged losses beside their 2-decimal rounding), and its checkpoint
# through cli.eval under model 2 and model 1.
MESH_GROUPS = {"pair": 2, "quad": 4, "five": 5}
# the new shapes of the forward kernel on these paths: the teacher's L1
# split over 2 and 4 ranks (10 and 5 of its 20 chunks), the student's L1
# over 5 (one chunk of 6 frames), and the 128-row halves of data-parallel
# serving (L2 at 256 rows is phase 2's)
MESH_SHAPES = [
    ("sp_teacher_L1_2", 15, 2560, 1024, 1152),
    ("sp_teacher_L1_4", 15, 1280, 1024, 1152),
    ("sp_student_L1_5", 6, 256, 1024, 1152),
    ("dp_student_L1", 6, 640, 1024, 1152),
    ("dp_student_L2", 5, 128, 1024, 4096),
]
# the int8 kernel's shapes on data-parallel int8 serving: the same halves
MESH_INT8_SHAPES = [
    ("dp_int8_student_L1", 6, 640, 1024, 1152),
    ("dp_int8_student_L2", 5, 128, 1024, 4096),
]
# cli.train at model 2 and in one process: 2 SGD steps (the parameter
# change is the gradient) over 9b's shards in one order
TP_TRAIN_FLAGS = ["--num_epochs", "1", "--start_new_model", "true",
                  "--deterministic_input", "true", "--optimizer", "GradientDescentOptimizer"]
# the train log prints each loss rounded to 2 decimals
LOG_ROUNDING = 1e-2
# cli.eval of one checkpoint under model 2 and model 1: the rank metrics
# (Hit@1, PERR, GAP) within 1e-3, the loss within 1e-5 relative
TOL_TP_EPOCH = 1e-3
TP_CFG = dict(compute_dtype="bfloat16", optimizer="GradientDescentOptimizer")


def counted(fn):
    """(fn(), the kernel launches it made), the counts set to 0 before."""
    for f in COUNTERS.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in COUNTERS.items()}


def mesh_serve(cfg, mesh, cases) -> dict:
    """Each (tag, tower, kwargs) of `cases`: the Predictor over `mesh`
    against the one-process Predictor on the same 256-video request."""
    models = {"student": init_model(cfg, prng.prng_key(4), device="cuda").eval(),
              "teacher": init_model(cfg, prng.prng_key(5), device="cuda").eval()}
    feats, nf = next(requests([SERVE_BATCH], cfg, seed=41))
    out = {}
    for tag, tower, kw in cases:
        quant = {"quantize": kw["quantize"]} if "quantize" in kw else {}
        want = Predictor(cfg, models[tower], tower, SERVE_BATCH, device="cuda",
                         **quant).predict(feats, nf)
        t0 = time.perf_counter()
        got, launches = counted(lambda: Predictor(
            cfg, models[tower], tower, SERVE_BATCH, device="cuda", mesh=mesh,
            **kw).predict(feats, nf))
        out[tag] = {"err": float(np.abs(got - want).max()), "shape": list(got.shape),
                    "finite": bool(np.isfinite(got).all()), "launches": launches,
                    "s": time.perf_counter() - t0}
    return out


def recovered_grads(cfg, state, before) -> dict:
    """An SGD step's gradients, (before - after) / lr, whole."""
    after = flat_leaves(state_tree(state))
    return {k: (v - after[k]) / cfg.base_learning_rate for k, v in before.items()
            if "/moving_" not in k}


def tp_step(cfg, mesh, batch) -> dict:
    """One SGD distill step of `cfg` from the seed-0 init on `mesh` (its
    data index's rows of `batch`), held on rank 0 against one process on
    the whole batch: the loss scalars within TOL_LOSS_REL + TOL_LOSS_ABS,
    each recovered gradient within TOL_GRAD_REL of its max (floored at
    1e-3 of the step's largest, as in 14b)."""
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    n = batch[0].shape[0] // mesh.data
    rows = tuple(t[mesh.data_index * n:(mesh.data_index + 1) * n] for t in batch)
    state = shard_state(init_distill_state(cfg, opt, prng.prng_key(0), device="cuda"), mesh)
    before = {k: v.clone() for k, v in flat_leaves(state_tree(state)).items()
              if k.startswith("params_")}
    t0 = time.perf_counter()
    (state, metrics), launches = counted(
        lambda: build_sharded_distill_step(cfg, opt, mesh)(state, *rows))
    seconds = time.perf_counter() - t0
    grads = recovered_grads(cfg, state, before)
    out = {"launches": launches, "s": seconds,
           "losses": {k: metrics[k].item() for k in DISTILL_SCALARS},
           "sharded": sorted(state.teacher.model_shards.names)}
    del state, before
    if mesh.rank == 0:
        one = init_distill_state(cfg, opt, prng.prng_key(0), device="cuda")
        before = {k: v.clone() for k, v in flat_leaves(state_tree(one)).items()
                  if k.startswith("params_")}
        one, want_metrics = build_distill_train_step(cfg, opt)(one, *batch)
        want = recovered_grads(cfg, one, before)
        floor = 1e-3 * max(v.abs().max().item() for v in want.values())
        errs = {k: (grads[k] - v).abs().max().item() / max(v.abs().max().item(), floor)
                for k, v in want.items()}
        worst = max(errs.items(), key=lambda kv: kv[1])
        out.update(grad_worst=list(worst), tensors=len(errs),
                   want_losses={k: want_metrics[k].item() for k in DISTILL_SCALARS})
    return out


def tp_train_argv(root: str, train_dir: str) -> list:
    return TP_TRAIN_FLAGS + ["--train_dir", train_dir, "--train_data_pattern",
                             os.path.join(root, "scale", "train*.tfrecord")]


def tp_binaries(root: str) -> dict:
    """cli.train --model_parallelism 2 for 2 steps over 9b's shards (its
    logged losses), and its checkpoint through cli.eval under model 2 and
    model 1."""
    data_dir = os.path.join(root, "scale")
    train_dir = os.path.join(root, "tp_train") + "/"
    out = {}
    t0 = time.perf_counter()
    with LogCapture("train", fidelity_check.STEP_RE) as steps:
        state, out["train_launches"] = counted(lambda: train_cli.main(
            tp_train_argv(root, train_dir) + ["--model_parallelism", "2"]))
    out["train_s"] = time.perf_counter() - t0
    out["steps"] = steps.matches
    out["global_step"] = state.global_step
    out["sharded"] = sorted(state.teacher.model_shards.names)
    del state
    for model in ("2", "1"):
        t0 = time.perf_counter()
        epoch, out[f"eval{model}_launches"] = counted(lambda: eval_cli.main([
            "--train_dir", train_dir, "--run_once", "true", "--model_parallelism", model,
            "--eval_data_pattern", os.path.join(data_dir, "validate*.tfrecord")]))
        out[f"eval{model}_s"] = time.perf_counter() - t0
        out[f"eval{model}"] = {k: float(epoch[k]) for k in
                               ("avg_hit_at_one", "avg_perr", "gap", "avg_loss")}
    return out


def mesh_worker(group: str, rank: int, world: int, port: int, root: str) -> None:
    """One rank of phase 15 (`python3 chip_smoke.py --mesh-worker GROUP
    RANK WORLD PORT ROOT`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.basicConfig(level=logging.WARNING)
    distributed.initialize(f"localhost:{port}", world, rank, device=torch.device("cuda", 0),
                           backend="gloo", timeout=datetime.timedelta(seconds=300))
    cfg = TrainConfig(compute_dtype="bfloat16")
    out = {}
    if group == "pair":
        out["serve"] = mesh_serve(cfg, create_mesh(device="cuda"), [
            ("dp_bf16_2", "student", {}),
            ("dp_int8_2", "student", {"quantize": "int8"}),
            ("sp_teacher_2", "teacher", {"sequence_parallel": True})])
        tp_cfg = TrainConfig(**TP_CFG)
        out["tp_1x2"] = tp_step(tp_cfg, create_mesh(model=2, device="cuda"),
                                distill_batch(tp_cfg, tp_cfg.batch_size, seed=51))
        out["cli"] = tp_binaries(root)
    elif group == "quad":
        out["serve"] = mesh_serve(cfg, create_mesh(device="cuda"), [
            ("sp_teacher_4", "teacher", {"sequence_parallel": True})])
        small = TrainConfig(**DP_CFG)
        out["tp_2x2"] = tp_step(small, create_mesh(model=2, device="cuda"),
                                distill_batch(small, small.batch_size, seed=52))
    else:
        out["serve"] = mesh_serve(cfg, create_mesh(device="cuda"), [
            ("sp_student_5", "student", {"sequence_parallel": True})])
    with open(os.path.join(root, "mesh", f"{group}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.shutdown()
    print(f"MESH_WORKER_OK {group} {rank}", flush=True)


def run_group(group: str, root: str) -> list:
    """Spawn the ranks of one phase-15 group; their results."""
    world, port = MESH_GROUPS[group], free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker", group, str(rank),
         str(world), str(port), root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise AssertionError(f"15 a rank of {group} timed out")
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"MESH_WORKER_OK {group} {rank}" not in text:
            raise AssertionError(f"15 {group} rank {rank} failed:\n{text[-4000:]}")
    results = []
    for rank in range(world):
        with open(os.path.join(root, "mesh", f"{group}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def check_tp_step(tag: str, ranks: list) -> dict:
    """15b's bars on a `tp_step` result, rank 0 holding the comparison;
    every rank reports the same losses."""
    got = ranks[0]
    losses = got["losses"]
    if any(r["losses"] != losses for r in ranks):
        raise AssertionError(f"15b {tag}: the ranks report different losses")
    bad = [k for k, v in got["want_losses"].items()
           if abs(losses[k] - v) > TOL_LOSS_REL * abs(v) + TOL_LOSS_ABS]
    name, worst = got["grad_worst"]
    log(f"[15] 15b {tag}: {got['s']:.2f} s for the step; losses (mesh / one process) "
        + "; ".join(f"{k} {losses[k]:.6g} / {v:.6g}" for k, v in got["want_losses"].items())
        + f"; recovered gradients over {got['tensors']} tensors, worst {name} {worst:.3g} "
        f"of its max; sharded leaves {got['sharded']}; launches {got['launches']} "
        f"(bars: losses {TOL_LOSS_REL} + {TOL_LOSS_ABS}, gradients {TOL_GRAD_REL})")
    if bad or worst > TOL_GRAD_REL or not got["sharded"]:
        raise AssertionError(f"15b {tag}: the mesh step misses the bars ({bad}, {worst})")
    if got["launches"]["lstm_train_fwd"] != 8 or got["launches"]["lstm_train_bwd"] != 8:
        raise AssertionError(f"15b {tag}: train kernel launches {got['launches']}")
    return got["launches"]


def logged_losses(steps) -> dict:
    """{step: (Teacher_Loss, L_REP, L_PRED, L_CE)} of fidelity_check.STEP_RE's
    matches."""
    return {int(m[0]): tuple(map(float, m[1:])) for m in steps}


def check_tp_train(root: str, cli: dict) -> dict:
    """15b: one process's cli.train on the same rows as the model-2 run:
    its logged losses within TOL_LOSS_REL + TOL_LOSS_ABS + LOG_ROUNDING,
    and each tensor's change from the init (2 SGD steps: the learning
    rate times the gradients' sum) within TOL_GRAD_REL of its max,
    floored at 1e-3 of the largest, as `tp_step` holds one step."""
    one_dir = os.path.join(root, "tp_one") + "/"
    argv = tp_train_argv(root, one_dir)
    with LogCapture("train", fidelity_check.STEP_RE) as steps:
        _, seconds, counts = run_binary("15b cli.train, one process", train_cli.main, argv,
                                        cli["train_launches"], phase="15")
    want, got = logged_losses(steps.matches), logged_losses(cli["steps"])
    if not want or sorted(want) != sorted(got):
        raise AssertionError(f"15b logged steps: one process {sorted(want)}, "
                             f"model 2 {sorted(got)}")
    loss_bad = [(s, g, w) for s in want for g, w in zip(got[s], want[s])
                if abs(g - w) > TOL_LOSS_REL * abs(w) + TOL_LOSS_ABS + LOG_ROUNDING]
    cfg = flags.config_from_args(flags.base_parser("").parse_args(argv))
    init = init_distill_state(cfg, make_optimizer(cfg.optimizer, cfg.clip_gradient_norm),
                              device="cuda")  # cli.train's init
    init = {k: v.detach().cpu().numpy() for k, v in flat_leaves(state_tree(init)).items()
            if k.startswith("params_")}
    one = flat_leaves(msgpack_io.load(checkpoint.latest_checkpoint(one_dir)))
    tp = flat_leaves(msgpack_io.load(checkpoint.latest_checkpoint(
        os.path.join(root, "tp_train"))))
    change = {k: v - one[k] for k, v in init.items() if "/moving_" not in k}
    floor = 1e-3 * max(np.abs(v).max() for v in change.values())
    errs = {k: np.abs((init[k] - tp[k]) - v).max() / max(np.abs(v).max(), floor)
            for k, v in change.items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    log(f"[15] 15b cli.train --model_parallelism 2 against one process on the same rows "
        f"(one process {seconds:.2f} s, launches {counts}): logged losses (model 2 / one "
        f"process) " + "; ".join(f"step {s} {got[s]} / {want[s]}" for s in sorted(want))
        + f"; parameter change over {len(errs)} tensors, worst {worst[0]} {worst[1]:.3g} "
        f"of its max (bars: losses {TOL_LOSS_REL} + {TOL_LOSS_ABS} + the log's rounding "
        f"{LOG_ROUNDING}, change {TOL_GRAD_REL})")
    if loss_bad or worst[1] > TOL_GRAD_REL:
        raise AssertionError(f"15b cli.train at model 2 misses the bars: {loss_bad}, {worst}")
    shutil.rmtree(one_dir, ignore_errors=True)
    return {"worst": worst, "losses": got}


def phase_mesh(root: str, smi: str) -> dict:
    """Phase 15: 15a serving over a mesh, 15b tensor parallelism."""
    gen = torch.Generator().manual_seed(15)
    worst_kernel = 0.0
    for name, T, B, H, D in MESH_SHAPES:
        _, err = check_scan_case(name, T, B, H, D, gen, tag="15")
        worst_kernel = max(worst_kernel, *err.values())
    gen8 = torch.Generator(device="cuda").manual_seed(15)
    worst_int8 = 0.0
    for name, T, B, H, D in MESH_INT8_SHAPES:
        _, _, err = check_int8_case(name, T, B, H, D, gen8, tag="15")
        worst_int8 = max(worst_int8, *err.values())
    os.makedirs(os.path.join(root, "mesh"))
    launches = {}
    t0 = time.perf_counter()
    groups, seconds = {}, {}
    for g in ("five", "quad", "pair"):
        t1 = time.perf_counter()
        groups[g] = run_group(g, root)
        seconds[g] = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    log(f"[15] group wall seconds, spawn to the last rank's exit: " + ", ".join(
        f"{g} ({MESH_GROUPS[g]} ranks) {s:.1f}" for g, s in seconds.items()))
    for group, ranks in groups.items():
        for tag in ranks[0]["serve"]:
            cases = [r["serve"][tag] for r in ranks]
            err = max(c["err"] for c in cases)
            kernel = "lstm_chunk_scan_int8" if "int8" in tag else "lstm_chunk_scan"
            counts = cases[0]["launches"]
            launches[tag] = counts
            log(f"[15] 15a {tag} ({len(ranks)} ranks): every rank's [256, 4716] within "
                f"{err:.3g} of the one-process Predictor (bar {TOL_PREDICTIONS}); "
                f"{cases[0]['s']:.2f} s; launches a rank {counts}")
            if (err > TOL_PREDICTIONS or not all(c["finite"] for c in cases)
                    or any(c["shape"] != [SERVE_BATCH, 4716] for c in cases)):
                raise AssertionError(f"15a {tag}: {cases}")
            if counts[kernel] != 4 or sum(counts.values()) != 4:
                raise AssertionError(f"15a {tag}: kernel launches {counts}")
    launches["tp_1x2"] = check_tp_step("(data 1, model 2) at flagship width, batch 256",
                                       [r["tp_1x2"] for r in groups["pair"]])
    launches["tp_2x2"] = check_tp_step("(2, 2) at lstm_cells 256, batch 64",
                                       [r["tp_2x2"] for r in groups["quad"]])
    cli = groups["pair"][0]["cli"]
    check_tp_train(root, cli)
    evals = (cli["eval2"], cli["eval1"])
    diff = max(abs(evals[0][k] - evals[1][k]) for k in EPOCH_KEYS)
    loss_rel = abs(evals[0]["avg_loss"] - evals[1]["avg_loss"]) / abs(evals[1]["avg_loss"])
    log(f"[15] 15b cli.train --model_parallelism 2: {cli['global_step']} global steps in "
        f"{cli['train_s']:.2f} s, launches {cli['train_launches']}, sharded "
        f"{cli['sharded']}; cli.eval of its checkpoint under model 2 {evals[0]} "
        f"({cli['eval2_s']:.2f} s, launches {cli['eval2_launches']}) and model 1 "
        f"{evals[1]} ({cli['eval1_s']:.2f} s, launches {cli['eval1_launches']}): "
        f"max|diff| {diff:.3g} on {', '.join(EPOCH_KEYS)} (bar {TOL_TP_EPOCH}), "
        f"avg_loss {loss_rel:.3g} relative (bar 1e-5)")
    if (cli["global_step"] != 4 or diff > TOL_TP_EPOCH or loss_rel > 1e-5
            or cli["train_launches"]["lstm_train_fwd"] != 16):
        raise AssertionError(f"15b the binaries at model 2: {cli}")
    if min(cli["eval2_launches"]["lstm_chunk_scan"], cli["eval1_launches"]["lstm_chunk_scan"]) < 1:
        raise AssertionError("15b cli.eval ran no forward kernel")
    launches.update(tp_cli_train=cli["train_launches"], tp_cli_eval2=cli["eval2_launches"],
                    tp_cli_eval1=cli["eval1_launches"])
    shutil.rmtree(os.path.join(root, "tp_train"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "mesh"), ignore_errors=True)
    log(f"[15] forward kernel at the mesh paths' new shapes: worst |diff| {worst_kernel:.3g} "
        f"(bars: outs {TOL_OUTS}, finals {TOL_FINALS}); int8 kernel at data-parallel int8 "
        f"serving's: worst |diff| {worst_int8:.3g} (bars: outs {TOL_INT8_OUTS}, finals "
        f"{TOL_INT8_FINALS}); {wall:.1f} s for the three gloo "
        f"groups of 5, 4 and 2 ranks on one card; correctness only, no speed of tensor or "
        f"sequence parallelism ({smi})")
    return launches


# ----------------------- phase 16: K-stacked dispatch and orbax checkpoints

# --steps_per_dispatch K against K = 1 on 9b's 21 batches of 256 (a partial
# last group: 5 groups of 4 and one of 1, which runs its one batch),
# both in one video order (--deterministic_input: racing readers batch
# the videos otherwise from run to run). Each batch runs in the same
# kernels at the same shapes either way, so the rank metrics and every AP
# are bit-equal; the mean loss may sum in another order (the JAX CLI
# tests' ulp allowance, tests/test_pipeline_e2e.py).
STACK_K = 4
STACK_LOSS_RTOL = 1e-6
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "orbax_jax")


def stacked_runs(tag, main_fn, logger_name, argv_of, per_batch, batches, pattern):
    """`main_fn(argv_of(k))` at K = 1 and at STACK_K over the same shards,
    each with its kernel launches (`per_batch` launches of a batch, one
    run a batch at every K) and the matches of `pattern` in its own log
    lines. Returns {k: (result, counts, matches)}."""
    out = {}
    for k, count in ((1, batches), (STACK_K, batches)):
        with LogCapture(logger_name, pattern) as capture:
            result, _, counts = run_binary(
                f"16a {tag} --steps_per_dispatch {k}", main_fn,
                argv_of(k) + ["--steps_per_dispatch", str(k)],
                {name: n * count for name, n in per_batch.items()}, phase="16")
        out[k] = (result, counts, capture.matches)
    return out


def check_stacked_epoch(tag, runs) -> float:
    """Every epoch metric of K and 1 bit-equal but avg_loss, which must
    agree to STACK_LOSS_RTOL; returns avg_loss's relative difference."""
    got, want = runs[STACK_K][0], runs[1][0]
    rest = [k for k in want if k != "avg_loss"]
    if sorted(got) != sorted(want) or not same_epoch(
            {k: got[k] for k in rest}, {k: want[k] for k in rest}):
        differ = [k for k in rest if not same_epoch({k: got[k]}, {k: want[k]})]
        raise AssertionError(f"{tag}: K={STACK_K} epoch metrics {differ} differ "
                             "from K=1")
    rel = abs(got["avg_loss"] - want["avg_loss"]) / abs(want["avg_loss"])
    if rel > STACK_LOSS_RTOL:
        raise AssertionError(f"{tag}: avg_loss {got['avg_loss']} against "
                             f"{want['avg_loss']} ({rel:.3g} relative)")
    return rel


def phase_stacked(root: str, smi: str) -> dict:
    """16a: cli.eval bf16 and int8, cli.validate and cli.infer at K = 4
    against K = 1 on 9b's checkpoint and its 21-batch infer shards."""
    train_dir = os.path.join(root, "scale_train") + "/"
    pattern = os.path.join(root, "infer", "test-*.tfrecord")
    videos = len(read_csv(os.path.join(root, "infer", "pred_none.csv")))
    batches = math.ceil(videos / TrainConfig().batch_size)
    levels = 2 * TrainConfig().lstm_layers
    eval_argv = ["--train_dir", train_dir, "--run_once", "true",
                 "--eval_data_pattern", pattern, "--deterministic_input", "true"]
    launches = {}
    for tag, main_fn, logger_name, extra, per_batch in (
            ("eval bf16", eval_cli.main, "eval", [], {"lstm_chunk_scan": levels}),
            ("eval int8", eval_cli.main, "eval", ["--quantize", "int8"],
             {"lstm_chunk_scan_int8": levels}),
            ("validate", validate_cli.main, "validate", [],
             {"lstm_chunk_scan": 2 * levels})):
        runs = stacked_runs(tag, main_fn, logger_name, lambda k: eval_argv + extra,
                            per_batch, batches, EVAL_RATE_RE)
        rel = check_stacked_epoch(tag, runs)
        rates = {k: float(r[2][0][0]) for k, r in runs.items()}
        launches[tag] = runs[STACK_K][1]
        log(f"[16] 16a {tag}, {videos} videos ({batches} batches): K={STACK_K} epoch "
            f"metrics bit-equal to K=1 but avg_loss ({rel:.3g} relative); the CLI's "
            f"examples/s K=1 {rates[1]:.1f}, K={STACK_K} {rates[STACK_K]:.1f} ({smi})")
    csv = {k: os.path.join(root, "infer", f"pred_k{k}.csv") for k in (1, STACK_K)}
    runs = stacked_runs("infer bf16", infer_cli.main, "infer", lambda k: [
        "--train_dir", train_dir, "--input_data_pattern", pattern,
        "--deterministic_input", "true", "--output_file", csv[k]],
        {"lstm_chunk_scan": levels}, batches, INFER_LINE_RE)
    rows = {k: read_csv(path) for k, path in csv.items()}
    if len(rows[1]) != videos:
        raise AssertionError(f"cli.infer wrote {len(rows[1])} rows of {videos}")
    worst = rows_within(rows[STACK_K], rows[1], TOL_CSV, f"16a infer K={STACK_K}")
    same = 0
    for (vid, a), (_, b) in zip(rows[STACK_K], rows[1]):
        for r, ((ca, pa), (cb, pb)) in enumerate(zip(a, b)):
            near = [abs(pb - b[q][1]) for q in (r - 1, r + 1) if 0 <= q < len(b)]
            if ca != cb and min(near) > TOL_CSV:
                raise AssertionError(f"{vid}: rank {r} is class {ca} at K={STACK_K}, "
                                     f"{cb} at K=1")
        same += a == b
    rates = {k: int(r[2][-1][0]) / float(r[2][-1][1]) for k, r in runs.items()}
    launches["infer bf16"] = runs[STACK_K][1]
    log(f"[16] 16a infer bf16, {videos} videos: K={STACK_K} rows (device top-k) "
        f"within {worst:.3g} of K=1 (host ranking), the same classes where "
        f"neighbours are {TOL_CSV} apart, {same} of {videos} rows byte-equal; "
        f"videos/s K=1 {rates[1]:.1f}, K={STACK_K} {rates[STACK_K]:.1f} ({smi})")
    return launches


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_orbax(root: str, smi: str) -> dict:
    """16b: cli.train --checkpoint_format orbax for 2 steps on 9b's train
    shards; its directory restored into a card state bit for bit as a
    msgpack save and restore of the same state; cli.eval,
    inspect_checkpoint and Predictor.from_checkpoint over the directory
    against the msgpack file; save and restore GiB/s; the committed
    JAX-written directories read on the card."""
    cfg = TrainConfig()
    levels = 2 * cfg.lstm_layers
    orbax_dir = os.path.join(root, "orbax_train") + "/"
    state, train_s, counts = run_binary(
        "16b train --checkpoint_format orbax", train_cli.main, [
            "--train_dir", orbax_dir, "--num_epochs", "1", "--start_new_model", "true",
            "--checkpoint_format", "orbax",
            "--train_data_pattern", os.path.join(root, "scale", "train*.tfrecord")],
        {"lstm_train_fwd": 2 * levels * 2, "lstm_train_bwd": 2 * levels * 2},
        phase="16")
    path = checkpoint.latest_checkpoint(orbax_dir)
    if not os.path.isdir(path) or state.global_step != 4:  # 2 a step: both towers
        raise AssertionError(f"cli.train left {path} at step {state.global_step}")
    msgpack_dir = os.path.join(root, "orbax_msgpack") + "/"
    msg = checkpoint.save_checkpoint(msgpack_dir, state, state.global_step)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    restored = {}
    for name, src in (("orbax", path), ("msgpack", msg)):
        template = init_distill_state(cfg, opt, prng.prng_key(3), device="cuda")
        t0 = time.perf_counter()
        checkpoint.restore_checkpoint(src, template)
        torch.cuda.synchronize()
        restored[name] = (template, time.perf_counter() - t0)
    for tower in ("teacher", "student"):
        want = getattr(state, tower).state_dict()
        for name, (template, _) in restored.items():
            for key, value in getattr(template, tower).state_dict().items():
                if not torch.equal(value, want[key]):
                    raise AssertionError(f"{name}: restored {tower}.{key} differs")
    for slots in ("opt_teacher", "opt_student"):
        a, b = (getattr(restored[n][0], slots) for n in ("orbax", "msgpack"))
        for key in ("mu", "nu"):
            for name, t in a[key].items():
                if not torch.equal(t, b[key][name]):
                    raise AssertionError(f"{slots}.{key}.{name}: orbax != msgpack")
    size = dir_bytes(path)
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(os.path.join(root, "orbax_io"), state, 2,
                               backend="orbax")
    save_s = time.perf_counter() - t0
    restore_s = restored["orbax"][1]
    del restored, state
    log(f"[16] 16b cli.train --checkpoint_format orbax {train_s:.3f} s; its "
        f"directory {size} B ({size / 2**30:.3f} GiB, the msgpack file "
        f"{os.path.getsize(msg)} B): save {save_s:.3f} s ({size / save_s / 2**30:.2f} "
        f"GiB/s), restore into a card state {restore_s:.3f} s "
        f"({size / restore_s / 2**30:.2f} GiB/s); parameters and Adam slots "
        f"bit-equal to the msgpack save and restore ({smi})")
    eval_pattern = os.path.join(root, "scale", "validate*.tfrecord")
    epochs, listings = {}, {}
    for name, train_dir in (("orbax", orbax_dir), ("msgpack", msgpack_dir)):
        epochs[name], _, _ = run_binary(
            f"16b eval over the {name} checkpoint", eval_cli.main, [
                "--train_dir", train_dir, "--run_once", "true",
                "--deterministic_input", "true", "--eval_data_pattern", eval_pattern],
            {"lstm_chunk_scan": levels * math.ceil(SCALE_EVAL / cfg.batch_size)},
            phase="16")
        out = io.StringIO()
        to_string(inspect_checkpoint_cli.main, out)(
            ["--file_name", checkpoint.latest_checkpoint(train_dir)])
        listings[name] = out.getvalue()
    if not same_epoch(epochs["orbax"], epochs["msgpack"]):
        raise AssertionError("cli.eval over the orbax directory differs")
    if listings["orbax"] != listings["msgpack"]:
        raise AssertionError("inspect_checkpoint lists the directory otherwise")
    serve_cfg = TrainConfig(compute_dtype="bfloat16")
    feats, nf = next(requests((64,), serve_cfg, seed=6))
    probs = {}
    for name, train_dir in (("orbax", orbax_dir), ("msgpack", msgpack_dir)):
        predictor, _, _ = run_binary(
            f"16b Predictor.from_checkpoint over the {name} checkpoint",
            lambda d: Predictor.from_checkpoint(d, serve_cfg, serve_batch=SERVE_BATCH,
                                                device="cuda"), train_dir, {},
            phase="16")
        lstm_scan.lstm_chunk_scan.launches = 0
        probs[name] = predictor.predict(feats, nf)
        if lstm_scan.lstm_chunk_scan.launches != levels:
            raise AssertionError(f"the {name} Predictor made "
                                 f"{lstm_scan.lstm_chunk_scan.launches} launches")
    check_predictions(probs["orbax"], len(nf), cfg.num_classes, "orbax Predictor")
    if not np.array_equal(probs["orbax"], probs["msgpack"]):
        raise AssertionError("the Predictor over the orbax directory differs")
    log(f"[16] 16b cli.eval over the directory equals cli.eval over the msgpack "
        f"file (every metric); inspect_checkpoint lists "
        f"{listings['orbax'].count('tensor_name:')} tensors as for the file; "
        f"Predictor.from_checkpoint over it serves 64 videos in {levels} launches, "
        "bit-equal to the file's")
    for name in ("one", "two"):
        base = os.path.join(FIXTURES, name)
        want = dict(np.load(os.path.join(base, "values.npz")))
        got = flat_leaves(checkpoint.read_checkpoint(checkpoint.latest_checkpoint(base)))
        if sorted(got) != sorted(want) or not all(
                np.asarray(got[k]).dtype == want[k].dtype
                and np.array_equal(np.asarray(got[k]), want[k]) for k in want):
            raise AssertionError(f"the JAX-written fixture {name} reads otherwise")
    log(f"[16] 16b the committed JAX-written orbax directories (one process; two "
        f"processes, ocdbt.process_0/1, a 4-chunk grid) read bit-equal to their "
        f".npz through libzstd at {orbax_io.zstd_library()}")
    return counts


# ------------------------------------------ phase 17: the drivers through bash
#
# The port's five drivers and its launcher (efficientvideoclassification_
# youtube8m_torch/scripts/*.sh) run through bash, as a user runs them: the
# reference's flags at flagship width and batch 256, from a directory that
# holds ./yt8m/. run_train.sh (1 epoch of 512 videos: 2 distill steps),
# run_validate.sh, run_convert_model.sh, run_finetune.sh (2 steps) and
# run_eval.sh run at their default directories, which chain; then
# run_train_multihost.sh as one rank (NCCL refuses two ranks on one card)
# writes an orbax directory. The data are 9b's shards, each split's four
# in one file: one reader then takes the file whole, so the drivers'
# racing readers give the order that --deterministic_input pins.
# A subprocess's kernel launches cannot be counted from here, so each
# driver's argv (recorded by a fake python first on PATH) also runs in
# this process through run_binary, from a twin directory of the same
# layout, with --deterministic_input: the twin's counts are the path's,
# and the drivers' results are held against the twin's bit for bit (the
# run is deterministic on the card: scripts/acceptance_run.py's record).
DRIVERS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "efficientvideoclassification_youtube8m_torch", "scripts")
# (driver, its binary) in the pipeline's order
DRIVERS = (("run_train.sh", train_cli), ("run_validate.sh", validate_cli),
           ("run_convert_model.sh", convert_cli), ("run_finetune.sh", finetune_cli),
           ("run_eval.sh", eval_cli))
TRAIN_DIR_DEFAULT = "model_HLSTM_TeaStud_every10_train"
FT_DIR_DEFAULT = "model_HLSTM_TeaStud_every10_finetune"
MULTIHOST_DIR = "model_multihost"
# bash's `time` line (TIMEFORMAT unset)
TIME_RE = re.compile(r"^real\s+(\d+)m([\d.]+)s$", re.M)
EPOCH_LINE_RE = re.compile(r"epoch/eval number \d+ \| .*")
EPOCH_TAGS = ("Avg_Hit@1", "Avg_Perr", "GAP", "MAP", "Avg_Loss")
FAKE_PYTHON = '#!/bin/bash\nprintf "%s\\0" "$@" > "$ARGV_FILE"\n'


def driver_env(**extra) -> dict:
    """The caller's environment with the checkout on PYTHONPATH (the
    drivers run `python -m` from their own directory) and `extra`."""
    env = {k: v for k, v in os.environ.items() if k != "TIMEFORMAT"}
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [repo, env.get("PYTHONPATH")]))
    env.update(extra)
    return env


def driver_argv(name: str, work: str, env: dict) -> list:
    """The argv that the driver `name` gives its python: the driver run in
    `work` with a fake python first on PATH that records it."""
    bin_dir = os.path.join(work, "bin")
    os.makedirs(bin_dir)
    fake = os.path.join(bin_dir, "python")
    with open(fake, "w") as f:
        f.write(FAKE_PYTHON)
    os.chmod(fake, 0o755)
    argv_file = os.path.join(work, "argv")
    subprocess.run(["bash", os.path.join(DRIVERS_DIR, name)], cwd=work, check=True,
                   capture_output=True, timeout=60, env=dict(
                       env, PATH=bin_dir + os.pathsep + env["PATH"], ARGV_FILE=argv_file))
    with open(argv_file, "rb") as f:
        return f.read().decode().split("\0")[:-1]


def run_driver(name: str, cwd: str, env: dict):
    """`bash name` in `cwd`, which must exit 0. Returns (its stdout and
    stderr, its wall seconds, the seconds of its `time` line)."""
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", os.path.join(DRIVERS_DIR, name)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"{name} exited {proc.returncode}: {out[-4000:]}")
    ((minutes, seconds),) = TIME_RE.findall(proc.stderr)
    return out, wall, 60 * int(minutes) + float(seconds)


def epoch_scalars(train_dir: str) -> dict:
    """{tag: {step: f32 value}} of the eval binaries' epoch summaries."""
    return {tag: read_scalars(os.path.join(train_dir, "eval"), f"Epoch/Eval_{tag}")
            for tag in EPOCH_TAGS}


def expect_files(base: str, names, what: str) -> None:
    missing = [n for n in names if not glob.glob(os.path.join(base, n))]
    if missing:
        raise AssertionError(f"{what}: {missing} missing under {base} "
                             f"(there: {sorted(os.listdir(base))})")


def phase_drivers(root: str, smi: str) -> dict:
    """17: the five drivers and the one-rank launcher through bash, each
    driver's argv again in this process; returns the twin's launches by
    driver."""
    t_phase = time.perf_counter()
    base = os.path.join(root, "drivers")
    work, twin = os.path.join(base, "run"), os.path.join(base, "twin")
    data = os.path.join(work, "yt8m")
    os.makedirs(data)
    os.makedirs(twin)
    for split in ("train", "validate"):
        with open(os.path.join(data, f"{split}-0000.tfrecord"), "wb") as out:
            for path in sorted(glob.glob(os.path.join(root, "scale", f"{split}-*.tfrecord"))):
                with open(path, "rb") as f:
                    shutil.copyfileobj(f, out)
    os.symlink(data, os.path.join(twin, "yt8m"))
    env = driver_env(EPOCH="1")
    argvs = {name: driver_argv(name, os.path.join(base, "argv", name), env)
             for name, _ in DRIVERS}
    cfg = TrainConfig()
    levels, B = 2 * cfg.lstm_layers, cfg.batch_size
    steps, eval_batches = SCALE_TRAIN // B, math.ceil(SCALE_EVAL / B)
    expected = {
        "run_train.sh": {"lstm_train_fwd": 2 * levels * steps,
                         "lstm_train_bwd": 2 * levels * steps},
        "run_validate.sh": {"lstm_chunk_scan": 2 * levels * eval_batches},
        "run_convert_model.sh": {},
        "run_finetune.sh": {"lstm_train_fwd": levels * steps, "lstm_train_bwd": levels * steps},
        "run_eval.sh": {"lstm_chunk_scan": levels * eval_batches},
    }
    times, outputs, results, launches = {}, {}, {}, {}
    for name, binary in DRIVERS:
        argv = argvs[name]
        if argv[:3] != ["-u", "-m", binary.__name__]:
            raise AssertionError(f"{name} runs {argv[:3]}, not {binary.__name__}")
        outputs[name], wall, timed = run_driver(name, work, env)
        with LogCapture("train", fidelity_check.STEP_RE) as capture, contextlib.chdir(twin):
            results[name], twin_s, launches[name] = run_binary(
                f"17 {name}'s argv in this process", binary.main,
                argv[3:] + ["--deterministic_input", "true"], expected[name], phase="17")
        times[name] = (wall, timed, twin_s)
        log(f"[17] {name}: exit 0, {wall:.3f} s wall, `time` real {timed:.3f} s; its argv "
            f"in this process {twin_s:.3f} s")
        if name == "run_train.sh":
            train_dir = os.path.join(work, TRAIN_DIR_DEFAULT)
            expect_files(train_dir, ["model.ckpt-4.msgpack", "checkpoint"], name)
            expect_files(os.path.join(train_dir, "backup_epc1"), [
                "model.ckpt-4.msgpack", "checkpoint", "events.out.tfevents.*"], name)
            if glob.glob(os.path.join(train_dir, "events*")):
                raise AssertionError(f"{name} left its events files in {train_dir}")
            with open(os.path.join(work, "output_HLSTM_TeaStud_every10_after_1epc")) as f:
                losses = [m.groups() for m in fidelity_check.STEP_RE.finditer(f.read())]
            if len(losses) != steps or losses != capture.matches:
                raise AssertionError(f"{name} logged {losses}, its twin {capture.matches}")
            if results[name].global_step != 2 * steps:
                raise AssertionError(f"the twin ended at {results[name].global_step}")
            results[name] = losses
            log(f"[17] {name}: checkpoint, backup_epc1 and its log in place; the logged "
                f"losses of its {steps} steps equal the twin's")
        elif name in ("run_validate.sh", "run_eval.sh"):
            model = TRAIN_DIR_DEFAULT if name == "run_validate.sh" else FT_DIR_DEFAULT
            lines = EPOCH_LINE_RE.findall(outputs[name])
            want = summary_lib.add_epoch_summary(None, results[name]["epoch_id"], results[name])
            got, mine = (epoch_scalars(os.path.join(d, model)) for d in (work, twin))
            if lines != [want] or got != mine or any(
                    len(v) != 1 for v in got.values()):
                raise AssertionError(f"{name}: epoch {lines} against {want}; summaries "
                                     f"{got} against {mine}")
            log(f"[17] {name}: its epoch line and its epoch summaries (f32) equal the "
                f"twin's bit for bit: {want}")
        elif name == "run_convert_model.sh":
            expect_files(work, ["output_HLSTM_TeaStud_every10_convertModel"], name)
            want = os.path.join(FT_DIR_DEFAULT, "model.ckpt-0.msgpack")
            if os.path.relpath(results[name], ".") != want or not os.path.exists(
                    os.path.join(work, want)):
                raise AssertionError(f"{name} wrote {results[name]}, not ./{want}")
            # the train checkpoints are read by nothing after convert
            for d in (work, twin):
                shutil.rmtree(os.path.join(d, TRAIN_DIR_DEFAULT))
        elif name == "run_finetune.sh":
            ft_dir = os.path.join(work, FT_DIR_DEFAULT)
            expect_files(ft_dir, ["model.ckpt-2.msgpack", "checkpoint"], name)
            expect_files(os.path.join(ft_dir, "backup_epc1"), [
                "model.ckpt-2.msgpack", "checkpoint", "train/events.out.tfevents.*"], name)
            expect_files(work, ["output_HLSTM_TeaStud_every10_finetune_after_1epc"], name)
            n = same_leaves(*(msgpack_io.load(os.path.join(d, "model.ckpt-2.msgpack"))
                              for d in (ft_dir, os.path.join(twin, FT_DIR_DEFAULT))),
                            f"{name}'s finetuned checkpoint against the twin's")
            results[name] = None  # the twin's state
            log(f"[17] {name}: checkpoint, backup_epc1 and its log in place; the "
                f"finetuned checkpoint's {n} leaves bit-equal to the twin's")
    shutil.rmtree(twin)

    env = driver_env(NUM_HOSTS="1", NPROC_PER_HOST="1", BATCH_SIZE="256",
                     TRAIN_DIR=f"./{MULTIHOST_DIR}")
    out, wall, timed = run_driver("run_train_multihost.sh", work, env)
    times["run_train_multihost.sh"] = (wall, timed, None)
    path = checkpoint.latest_checkpoint(os.path.join(work, MULTIHOST_DIR))
    if path is None or not os.path.isdir(path) or not path.endswith("model.ckpt-4"):
        raise AssertionError(f"run_train_multihost.sh left {path}")
    losses = [m.groups() for m in fidelity_check.STEP_RE.finditer(out)]
    if losses != results["run_train.sh"]:
        raise AssertionError(f"the launcher logged {losses}, run_train.sh "
                             f"{results['run_train.sh']}")
    log("[17] run_train_multihost.sh (NUM_HOSTS=1 NPROC_PER_HOST=1 BATCH_SIZE=256): "
        f"exit 0, {wall:.3f} s wall, `time` real {timed:.3f} s; orbax directory "
        f"{os.path.basename(path)} ({dir_bytes(path)} B); its logged losses equal "
        "run_train.sh's")
    shutil.rmtree(base)
    log("[17] driver seconds (wall, `time` real, its argv in this process): " + "; ".join(
        f"{name} {w:.3f}, {t:.3f}" + (f", {i:.3f}" if i is not None else "")
        for name, (w, t, i) in times.items()) + f" ({smi})")
    log(f"[17] phase 17 wall {time.perf_counter() - t_phase:.1f} s")
    return launches


def jax_package_files():
    """The files under the JAX package's directory (beside this script),
    or None where there is none."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "efficientvideoclassification_youtube8m_tpu")
    if not os.path.isdir(root):
        return None
    return sorted(os.path.join(d, f) for d, _, files in os.walk(root) for f in files)


LSTM_MODEL_BATCHES = 2
# the calls of `lstm_chunk_scan` a batch: one a layer of each forward
# (cli.validate runs both towers of the state)
LSTM_MODEL_CALLS = {"eval": 2, "validate": 4, "infer": 2}


def phase_lstm_model(root: str, smi: str) -> dict:
    """18: `--model LstmModel` at its published widths through cli.eval,
    cli.validate and cli.infer at batch 256 over two batches of
    full-frame videos, each with the scan's launch count set to 0 just
    before it; cli.eval traced for `lstm.step_launches`. Returns the calls
    a batch of each binary."""
    data_dir = os.path.join(root, "lstm_model")
    os.makedirs(data_dir)
    B = 256
    for s in range(LSTM_MODEL_BATCHES):
        port_data.write_synthetic_frame_shard(
            os.path.join(data_dir, f"eval-{s:04d}.tfrecord"), num_videos=B, seed=180 + s)
    pattern = os.path.join(data_dir, "eval-*.tfrecord")
    train_dir = os.path.join(root, "lstm_model_train")
    argv = ["--model", "LstmModel", "--lstm_cells", "1024", "--lstm_layers", "2",
            "--num_classes", "4716", "--moe_num_mixtures", "2", "--batch_size", str(B),
            "--max_num_frames", "300", "--every_n", "1", "--num_readers", "4",
            "--device", "cuda", "--run_once", "true", "--compute_dtype", "bfloat16",
            "--top_k", "20", "--train_dir", train_dir]
    cfg = flags.config_from_args(flags.base_parser("").parse_args(argv))
    device = torch.device("cuda", 0)
    state = DistillState(teacher=init_model(cfg, device=device),
                         student=init_model(cfg, device=device), opt_teacher={},
                         opt_student={}, global_step=1, dropout_keep_prob=1.0)
    checkpoint.save_checkpoint(train_dir, state, 1)
    del state
    per_batch = {}
    for binary in ("eval", "validate", "infer"):
        lstm_scan.lstm_chunk_scan.launches = 0
        t0 = time.perf_counter()
        if binary == "eval":
            with profiling.trace(os.path.join(root, "lstm_model_trace"), device=device) as t:
                epoch = eval_cli.main(argv + ["--eval_data_pattern", pattern])
            steps = t.totals["counters"].get("lstm.step_launches", 0)
            if steps != 600 * LSTM_MODEL_BATCHES:
                raise AssertionError(f"18 cli.eval: {steps} kernel steps, expected "
                                     f"{600 * LSTM_MODEL_BATCHES}")
        elif binary == "validate":
            epoch = validate_cli.main(argv + ["--eval_data_pattern", pattern])
        else:
            out = os.path.join(root, "lstm_model.csv")
            infer_cli.main(argv + ["--input_data_pattern", pattern, "--output_file", out])
            with open(out) as f:
                rows = sum(1 for _ in f) - 1
            if rows != B * LSTM_MODEL_BATCHES:
                raise AssertionError(f"18 cli.infer wrote {rows} rows")
            epoch = None
        seconds = time.perf_counter() - t0
        calls = lstm_scan.lstm_chunk_scan.launches
        per_batch[binary] = calls / LSTM_MODEL_BATCHES
        log(f"[18] cli.{binary} --model LstmModel: {calls} scan calls over "
            f"{LSTM_MODEL_BATCHES} batches of {B} (expected "
            f"{LSTM_MODEL_CALLS[binary]} a batch), {seconds:.1f} s"
            + ("" if epoch is None else f", avg_loss {epoch['avg_loss']:.6f}, "
               f"gap {epoch['gap']:.6f}"))
        if calls != LSTM_MODEL_CALLS[binary] * LSTM_MODEL_BATCHES:
            raise AssertionError(f"18 cli.{binary}: {calls} scan calls")
        if epoch is not None and not math.isfinite(epoch["avg_loss"]):
            raise AssertionError(f"18 cli.{binary}: avg_loss {epoch['avg_loss']}")
    log(f"[18] LstmModel at its published widths: 600 kernel steps a batch under "
        f"cli.eval's trace ({smi})")
    return per_batch


GNETVLAD_BATCHES = 2
GNETVLAD_SPANS = ("gnetvlad.video", "gnetvlad.audio", "gnetvlad.hidden", "gnetvlad.head")


def phase_gnetvlad_model(root: str, smi: str) -> None:
    """19: `--model GatedNetVLADModel` at its published widths (the
    constructor's defaults: 256 clusters, hidden 1024, both gates; MoE of
    2 over 4716) through cli.eval, cli.validate and cli.infer at batch
    256 over two batches of full-frame videos, each traced: one span of
    each of the four `gnetvlad.*` a forward, inside `step.eval` on its
    thread (cli.validate runs both towers)."""
    data_dir = os.path.join(root, "gnetvlad_model")
    os.makedirs(data_dir)
    B = 256
    for s in range(GNETVLAD_BATCHES):
        port_data.write_synthetic_frame_shard(
            os.path.join(data_dir, f"eval-{s:04d}.tfrecord"), num_videos=B, seed=190 + s)
    pattern = os.path.join(data_dir, "eval-*.tfrecord")
    train_dir = os.path.join(root, "gnetvlad_model_train")
    argv = ["--model", "GatedNetVLADModel", "--num_classes", "4716",
            "--moe_num_mixtures", "2", "--batch_size", str(B), "--max_num_frames", "300",
            "--every_n", "1", "--num_readers", "4", "--device", "cuda", "--run_once", "true",
            "--compute_dtype", "bfloat16", "--top_k", "20", "--train_dir", train_dir]
    cfg = flags.config_from_args(flags.base_parser("").parse_args(argv))
    device = torch.device("cuda", 0)
    state = DistillState(teacher=init_model(cfg, device=device),
                         student=init_model(cfg, device=device), opt_teacher={},
                         opt_student={}, global_step=1, dropout_keep_prob=1.0)
    params = sum(p.numel() for p in state.student.parameters())
    if params != 333_244_440:
        raise AssertionError(f"19 GatedNetVLADModel holds {params} parameters")
    checkpoint.save_checkpoint(train_dir, state, 1)
    del state
    for binary, forwards in (("eval", 1), ("validate", 2), ("infer", 1)):
        t0 = time.perf_counter()
        with profiling.trace(os.path.join(root, f"gnetvlad_{binary}_trace"),
                             device=device) as t:
            if binary == "eval":
                epoch = eval_cli.main(argv + ["--eval_data_pattern", pattern])
            elif binary == "validate":
                epoch = validate_cli.main(argv + ["--eval_data_pattern", pattern])
            else:
                out = os.path.join(root, "gnetvlad_model.csv")
                infer_cli.main(argv + ["--input_data_pattern", pattern, "--output_file", out])
                with open(out) as f:
                    rows = sum(1 for _ in f) - 1
                if rows != B * GNETVLAD_BATCHES:
                    raise AssertionError(f"19 cli.infer wrote {rows} rows")
                epoch = None
        seconds = time.perf_counter() - t0
        spans = t.totals["spans"]
        counts = {n: spans.get(n, {}).get("count", 0) for n in GNETVLAD_SPANS}
        steps = [r for r in profiling.records() if r[0] == "step.eval"]
        outside = [r for r in profiling.records() if r[0] in GNETVLAD_SPANS and not any(
            s[1] == r[1] and s[2] <= r[2] and r[3] <= s[3] for s in steps)]
        log(f"[19] cli.{binary} --model GatedNetVLADModel: spans {counts} over "
            f"{GNETVLAD_BATCHES} batches of {B}, {len(steps)} step.eval, {seconds:.1f} s"
            + ("" if epoch is None else f", avg_loss {epoch['avg_loss']:.6f}, "
               f"gap {epoch['gap']:.6f}"))
        if len(steps) != GNETVLAD_BATCHES:
            raise AssertionError(f"19 cli.{binary}: {len(steps)} step.eval spans")
        if any(c != forwards * GNETVLAD_BATCHES for c in counts.values()) or outside:
            raise AssertionError(f"19 cli.{binary}: spans {counts}, {len(outside)} outside "
                                 f"step.eval")
        if epoch is not None and not math.isfinite(epoch["avg_loss"]):
            raise AssertionError(f"19 cli.{binary}: avg_loss {epoch['avg_loss']}")
    log(f"[19] GatedNetVLADModel at its published widths, 333,244,440 parameters: its "
        f"four spans inside step.eval in the three binaries ({smi})")


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
    train_launches, step_rate, trace_path = phase_distill(smi)
    int8_worst, int8_times = phase_int8_kernel()
    int8_launches = phase_int8_serving(smi)
    phase_routing()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_pipeline")
    shutil.rmtree(root, ignore_errors=True)
    try:
        phase_pipeline(root, smi, step_rate)
        library = phase_library(smi)["student_L1"]
        phase_gate(smi)
        zoo = phase_zoo(root, smi)
        t0 = time.perf_counter()
        interop = phase_interop(root, smi)
        chunked = phase_chunked(root, smi)
        log(f"[13] phase 13 wall {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        world_one = phase_world_one(root, smi)
        two_ranks = phase_two_ranks(root, smi)
        phase_trace(trace_path)
        log(f"[14] phase 14 wall {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh_launches = phase_mesh(root, smi)
        log(f"[15] phase 15 wall {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        stacked_launches = phase_stacked(root, smi)
        orbax_launches = phase_orbax(root, smi)
        log(f"[16] phase 16 wall {time.perf_counter() - t0:.1f} s")
        driver_launches = phase_drivers(root, smi)
        lstm_model_launches = phase_lstm_model(root, smi)
        phase_gnetvlad_model(root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "msgpack", "efficientvideoclassification_youtube8m_tpu"))
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    if jax_package_files() != jax_files:
        raise AssertionError("the run wrote into the JAX package's directory")
    log("[19] no module of jax, flax, msgpack or the JAX package loaded; nothing "
        "written into the JAX package's directory (phases 1-19)")
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
        if name.startswith("lstm_train"):
            # the launches of phase 12b's cli.train (SingleHiddenLayerModelDropout)
            # and of phase 14a's cli.train in an NCCL group of one rank
            kernels[-1]["zoo_train_launches"] = zoo["train_launches"]
            kernels[-1]["world_one_train_launches"] = world_one["launches"][name]
        else:
            # a 300-video request to each Predictor over 13a's bundle
            kernels[-1]["interop_predict_launches"] = interop["launches"][
                "student none" if name == "lstm_chunk_scan" else "student int8"]
        if name == "lstm_chunk_scan":
            # phase 18: the LSTM baseline's binaries, calls a batch
            kernels[-1]["lstm_model_launches"] = lstm_model_launches
        # phase 15's paths: a rank's launches, each path counted alone
        kernels[-1]["mesh_launches"] = {path: counts[name] for path, counts
                                        in mesh_launches.items() if counts[name]}
        # phase 16's paths: K = 4 eval, validate and infer (one run a
        # batch), cli.train --checkpoint_format orbax
        paths = {f"{tag} K={STACK_K}": counts.get(name, 0)
                 for tag, counts in stacked_launches.items()}
        paths["train --checkpoint_format orbax"] = orbax_launches[name]
        kernels[-1]["phase16_launches"] = {p: n for p, n in paths.items() if n}
        # phase 17: each driver's argv run in this process
        kernels[-1]["phase17_launches"] = {d: counts[name] for d, counts
                                           in driver_launches.items() if counts[name]}
    log(f"[13] interop: export {interop['export_gib_s']:.2f} GiB/s, import "
        f"{interop['import_gib_s']:.2f} GiB/s of a {interop['bundle_bytes']} B bundle; "
        f"chunked msgpack {chunked['bytes']} B, save {chunked['save_gib_s']:.2f} GiB/s, "
        f"restore {chunked['restore_gib_s']:.2f} GiB/s; 14a all-reduce "
        f"{world_one['allreduce_ms']:.3f} ms a step; 14b worst gradient "
        + ", ".join(f"{k} {v:.3g}" for k, v in two_ranks.items()))
    log(f"[1] card: {smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
                    sys.argv[6])
    else:
        main()
