"""What the drivers share: the run's context, the program's configuration
built by the program's own flag parser from a configuration file, the
program's modules holding the seed's weights, the loader tap that ends a
stream at the window's deadline, and the comparisons that decide
`correct`."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from portbench import trace as trace_lib
from portbench import traffic as traffic_lib
from portbench import weights as weights_lib
from portbench.reference import model as ref_model

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    cell: str
    spec: Dict  # portbench/workloads/<cell>.json
    config: Dict  # portbench/configs/<config>.json
    traffic: Dict  # portbench/traffic/<traffic>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    clock: Callable[[], float]  # seconds since the process started
    tmp: Path
    marks: List[tuple] = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        """Note the set-up's clock at the end of a part of it."""
        self.marks.append((what, self.clock()))

    @property
    def flags(self) -> Dict:
        return self.config["flags"]


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window's seconds, the steps, batches
    or requests attempted and failed in it, the end-to-end values, and
    (name, value, limit) of each number compared with the reference."""

    setup_s: float
    window_s: float
    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: List[tuple]
    memory_peak_bytes: int
    observed: Dict  # what the per-layer readers read
    marks: List[tuple]  # the set-up's parts: (what, seconds since the start)
    trace: Optional[Dict] = None
    numbers: Optional[Dict[str, float]] = None  # every number compared or not
    kept: Optional[Dict] = None  # the inputs and readings of the comparison


def program_config(flags: Dict, **extra):
    """(args, cfg) as the program's CLI parses them from `flags` (a
    configuration file's flag names and values) and `extra`."""
    from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib

    argv: List[str] = []
    for key, value in {**flags, **extra}.items():
        argv += [f"--{key}", str(value)]
    args = flags_lib.base_parser("portbench").parse_args(argv)
    return args, flags_lib.config_from_args(args)


def program_seed(seed: int) -> int:
    """The program's --seed (int32) for a run's seed."""
    return seed % (2 ** 31)


def program_tower(cfg, leaves: Dict[str, torch.Tensor], device):
    """A program module of `cfg.model` holding `leaves`. It is built on
    the device (the program's own draw there takes a fraction of a
    second; built on the meta device it took 7 s of set-up on the H100's
    host) and its parameters are then overwritten."""
    from efficientvideoclassification_youtube8m_torch.train.state import init_model

    module = init_model(cfg, device=device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(leaves[name])
    return module


def program_towers(ctx: Context, cfg, towers: Sequence[str]) -> Dict:
    ctx.mark("program_imports")
    drawn = weights_lib.draw(ctx.flags, tuple(towers), ctx.seed, ctx.device)
    ctx.mark("weights")
    out = {t: program_tower(cfg, drawn.pop(t), ctx.device) for t in towers}
    ctx.mark("modules")
    return out


def write_pool(ctx: Context) -> str:
    directory = traffic_lib.cache_dir(ROOT, ctx.cell, ctx.seed)
    return traffic_lib.write_pool(directory, ctx.traffic, ctx.flags, ctx.seed,
                                  str(ctx.device))


def frame_loader(ctx: Context, cfg, pattern: str):
    """The program's loader over the pool, as the cell's traffic sets it:
    an endless stream, the reference's readers."""
    from efficientvideoclassification_youtube8m_torch.data import FrameDataLoader

    t = ctx.traffic
    return FrameDataLoader(
        pattern, batch_size=cfg.batch_size,
        feature_names=cfg.feature_names_list, feature_sizes=cfg.feature_sizes_list,
        max_frames=cfg.max_num_frames, vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers, deterministic=cfg.deterministic_input,
        num_epochs=None, shuffle=t["shuffle"], shuffle_buffer=t.get("shuffle_buffer"),
        seed=cfg.seed, drop_remainder=True, use_native=cfg.use_native_io,
        frame_stride=cfg.every_n if t["stride"] == "every_n" else 1)


class Tap:
    """One stream over a loader iterator, cut into takes: `take(n)` yields
    n batches, `until(deadline)` batches until the clock passes the
    deadline. It times each wait in `next()` and polls the tracer."""

    def __init__(self, iterator, tracer: Optional[trace_lib.Tracer] = None,
                 traced: bool = False):
        self._it = iterator
        self.tracer = tracer
        self.traced = traced
        self.wait_s = 0.0
        self.count = 0

    def _next(self):
        with trace_lib.span("loader", self.traced):
            t = time.perf_counter()
            batch = next(self._it)
            self.wait_s += time.perf_counter() - t
        self.count += 1
        return batch

    def take(self, n: int, keep: Optional[list] = None) -> Iterable:
        for _ in range(n):
            batch = self._next()
            if keep is not None:
                keep.append(batch)
            yield batch

    def until(self, start: float, seconds: float,
              on_batch: Optional[Callable] = None) -> Iterable:
        while True:
            elapsed = time.perf_counter() - start
            if self.tracer is not None:
                self.tracer.poll()
            if elapsed >= seconds:
                if self.tracer is not None:
                    self.tracer.finish()
                return
            batch = self._next()
            if on_batch is not None:
                on_batch(batch)
            yield batch

    def close(self) -> None:
        self._it.close()


def tracer_for(ctx: Context) -> Optional[trace_lib.Tracer]:
    if not ctx.trace:
        return None
    return trace_lib.Tracer(ctx.device, min(ctx.spec["trace"]["span_s"], ctx.seconds / 2))


def begin_window(ctx: Context, tracer) -> float:
    """Start the traced stretch, if any, and return the window's start."""
    if tracer is not None:
        tracer.begin()
    return time.perf_counter()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    """The peak is read over the window: set-up's copies are not the
    program's."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ------------------------------------------------------ comparisons


def rel_gap(got: float, want: float) -> float:
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-30)


def leaf_norm_gap(got: Dict[str, float], want: Dict[str, float],
                  keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger
    of the reference leaf's norm and the median leaf's."""
    names = list(want if keep is None else keep)
    if not names:
        return 0.0
    median = float(np.median([want[n] for n in want]))
    worst = 0.0
    for n in names:
        g = got.get(n, math.nan)
        if not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - want[n]) / max(want[n], median, 1e-30))
    return worst


def checks(ctx: Context, numbers: Dict[str, float]) -> List[tuple]:
    """(name, value, limit) of each number the cell's file gives a limit."""
    lim = ctx.spec["check"]["limits"]
    return [(k, float(v), float(lim[k])) for k, v in numbers.items() if k in lim]


class Fp8(ref_model.Precision):
    """The control's arithmetic, the nearest below the configuration's
    bf16: every product's operands, and every stored input projection,
    rounded to fp8 e4m3 (nearest, 3 mantissa bits) under a scale that
    puts each row's (a weight's column's) largest magnitude at 448, the
    format's largest; gradients pass straight through."""

    @staticmethod
    def _q(t: torch.Tensor, dim: int) -> torch.Tensor:
        v = t.detach()
        scale = torch.clamp(v.abs().amax(dim=dim, keepdim=True), min=1e-30) / 448
        return t + ((v / scale).to(torch.float8_e4m3fn).to(v.dtype) * scale - v)

    def mm(self, x, w):
        return self._q(x, 1) @ self._q(w, 0)

    def store(self, t):
        return self._q(t, 1)


FP8 = Fp8()


def tmp_dir(name: str) -> Path:
    base = Path(os.environ.get("TMPDIR") or "/tmp")
    path = base / "portbench" / f"{name}-{os.getpid()}"
    path.mkdir(parents=True, exist_ok=True)
    return path
