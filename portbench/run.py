"""Run one cell of the port's benchmark once, on the machine it starts on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(portbench/configs/), its traffic (portbench/traffic/) and its chips;
portbench/workloads/<cell>.json names its driver (portbench/drivers/),
its checks' limits and its traced stretch. The last line of standard
output is the result: with `--trace 0` the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics (portbench/metrics/<metric>.py).
The numbers compared with the reference, each beside its limit, are the
last lines of standard error and the result's last key."""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "efficientvideoclassification_youtube8m_tpu")


def _process_age() -> float:
    """Seconds since this process started (from /proc), at import."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE = _process_age()


def since_start() -> float:
    return _AGE + time.perf_counter() - _START


def cell_entry(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")


def with_held_back(bench: dict) -> dict:
    """`bench` with the cells of portbench/held_back.json added: cells whose
    files are kept but that BENCHMARK.json holds back (PERF.md says why).
    The tools and the CPU tests run them; a run of the benchmark does not."""
    held = json.loads((ROOT / "portbench" / "held_back.json").read_text())
    return dict(bench, workloads=bench["workloads"] + held)


def reported(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = cell_entry(bench, args.workload)
    caches = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(caches / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(caches / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {entry['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, since_start)
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"].update(platform="gpu", kind=torch.cuda.get_device_name(device),
                            count=entry["chips"])
    _print(result)
    return 0


def make_context(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
                 device, clock, resize=None):
    """The cell's context, its files as loaded; `resize(spec, config,
    traffic)`, if given, changes them (the tests' small sizes)."""
    from portbench import harness

    entry = cell_entry(bench, cell)
    pb = ROOT / "portbench"
    files = (harness.load_json(pb / "workloads" / f"{cell}.json"),
             harness.load_json(pb / "configs" / f"{entry['config']}.json"),
             harness.load_json(pb / "traffic" / f"{entry['traffic']}.json"))
    if resize is not None:
        resize(*files)
    return harness.Context(
        cell=cell, spec=files[0], config=files[1], traffic=files[2],
        seed=seed, seconds=seconds, trace=trace, device=device, clock=clock,
        tmp=harness.tmp_dir(cell))


def drive(ctx, then=None):
    """Run the cell's driver (and `then(driver, outcome)`, if given) with
    the program's loggers writing into the run's temporary directory,
    which is removed after."""
    log = logging.getLogger("portbench")
    handler = logging.FileHandler(ctx.tmp / "log.txt")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False
    try:
        driver = importlib.import_module(f"portbench.drivers.{ctx.spec['driver']}")
        out = driver.run(ctx)
        return out, (then(driver, out) if then is not None else None)
    finally:
        log.removeHandler(handler)
        handler.close()
        shutil.rmtree(ctx.tmp, ignore_errors=True)


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, clock, resize=None) -> dict:
    """Run `cell` on `device` and return its result (the harness's own
    look for a chip is the caller's)."""
    ctx = make_context(bench, cell, seed, seconds, trace, device, clock, resize)
    ctx.mark("imports")
    out, _ = drive(ctx)
    print("set-up: " + ", ".join(f"{what} {t:.3f} s" for what, t in out.marks
                                 + [("window", out.setup_s)]), file=sys.stderr)
    values = dict(out.metrics, setup_s=out.setup_s)
    metrics = {}
    if trace:
        run = Reading(ctx, out)
        for m in reported(bench, cell, "per_layer"):
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in reported(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    correct = (out.failed == 0 and bool(out.checks)
               and all(math.isfinite(v) and v <= lim for _, v, lim in out.checks))
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": {"memory_peak_bytes": out.memory_peak_bytes}}
    if trace and out.trace is not None:
        result["device"].update(busy_s=out.trace["busy_s"], window_s=out.trace["window_s"])
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return result


class Reading:
    """What a per-layer reader reads: the configuration's flags, the work
    a step of the cell does (its file's "work"), the window's seconds,
    what the driver observed and the traced stretch."""

    def __init__(self, ctx, outcome):
        self.flags = ctx.flags
        self.work = ctx.spec["work"]
        self.window_s = outcome.window_s
        self.observed = outcome.observed
        self.trace = outcome.trace


def _finite(x):
    """JSON has no infinity: a number that is not finite is written null."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def _print(result: dict) -> None:
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)


if __name__ == "__main__":
    sys.exit(main())
