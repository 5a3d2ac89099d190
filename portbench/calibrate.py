"""Readings that the limits of `correct` are set from: for each seed, the
numbers the cell compares for a sound run of the program, and the same
numbers for its control (and, for training, a planted fault). Not run by
the benchmark's runs. On the card, from the checkout's root:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

One JSON line a seed on standard output; all in one process."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")

    import torch

    from portbench import run

    if not torch.cuda.is_available():
        print("portbench: calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = run.with_held_back(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = run.make_context(bench, args.workload, seed, args.seconds, False, device,
                               lambda: time.perf_counter() - t0)
        out, control = run.drive(ctx, lambda driver, out: driver.control(ctx, out))
        print(json.dumps(run._finite({
            "seed": seed, "numbers": out.numbers, "control": control,
            "metrics": out.metrics, "setup_s": out.setup_s, "window_s": out.window_s,
            "seconds": time.perf_counter() - t0})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
