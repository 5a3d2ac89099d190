#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from this checkout's sources, holds
it against its plain PyTorch version at the shapes the serving path gives
it, serves the flagship student through `Predictor` and checks that its
LSTM recurrences went through the kernel. Phases:

  1. the card (nvidia-smi name and power limit), torch and CUDA
     versions, the kernel's build time and ptxas report;
  2. `lstm_chunk_scan` against `lstm_chunk_scan_reference` in bf16 at the
     student and teacher layer shapes and a ragged one, with times;
  3. the student tower at the flagship config (TrainConfig defaults in
     bf16: D=1152, 2x1024 LSTMs, 4716 classes, MoE 2, every_n=10, 5
     chunks, random weights from a seed) serving requests of 256, 100
     and 513 videos; the launch count, the range of the predictions, the
     agreement with the plain-scan Predictor, and videos/s at batch 256;
  4. one teacher request (the T=15 and T=20 recurrences).

Any failure raises, so the exit code is not 0. The line before the last
is {"kernels": [...]}; the last is {"ok": true, "device": {...}}. With no
CUDA device the script stops before it measures anything.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch.ops.kernels import _build
from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan
from efficientvideoclassification_youtube8m_torch.serving import (
    Predictor,
    TrainConfig,
    init_model,
)

KERNEL = "lstm_chunk_scan"
KERNEL_SOURCE = "efficientvideoclassification_youtube8m_torch/ops/csrc/lstm_chunk_scan.cu"
REPLACES = "efficientvideoclassification_youtube8m_tpu/ops/pallas/lstm_scan.py:72"

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

# (name, T, B, H, D_in): the layers the flagship serves at serve_batch
# 256. L1 folds 5 (student) or 20 (teacher) chunks into the batch axis;
# D_in is the input width of the level's first layer.
LAYER_SHAPES = [
    ("student_L1", 6, 1280, 1024, 1152),
    ("student_L2", 5, 256, 1024, 4096),
    ("teacher_L1", 15, 5120, 1024, 1152),
    ("teacher_L2", 20, 256, 1024, 4096),
    ("ragged", 7, 13, 48, 40),
]
SERVE_BATCH = 256


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` runs, after a warm-up."""
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
    lstm_scan.load_kernel()
    log(f"[1] kernel build+load: {time.perf_counter() - t0:.3f} s")
    for line in _build.build_log(KERNEL).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1] ptxas: {line.strip()}")
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
        iters = 20 if name != "ragged" else 5
        ms = cuda_ms(lambda: lstm_scan.lstm_chunk_scan(*args), iters)
        plain_ms = cuda_ms(lambda: lstm_scan.lstm_chunk_scan_reference(*args), iters)
        times[name] = (ms, plain_ms)
        log(f"[2] {name} T={T} B={B} H={H}: max|diff| outs {err['outs']:.3g} "
            f"c_fin {err['c_fin']:.3g} h_fin {err['h_fin']:.3g}; "
            f"zeros past seq {zeros_past_seq}, zero state at seq 0 {zero_state}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
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
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cuda")
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    worst, times = phase_kernel()
    launches = phase_serving(smi)
    if any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules):
        raise AssertionError("the port imported jax")
    ms, plain_ms = times["student_L1"]
    log(f"[1] card: {smi}")
    log(json.dumps({"kernels": [{
        "name": KERNEL, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
