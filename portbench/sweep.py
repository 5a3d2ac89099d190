"""The knee of an open-loop cell: run its driver at each of a list of
rates and print, a rate a line, the latency percentiles and whether the
backlog grew (the mean lateness of the window's last fifth of requests
against its first fifth). Not run by the benchmark's runs. On the card:

    python3 portbench/sweep.py --workload serve_open.b8 --rates 200,400,800 [--seconds 10]
"""

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
    p.add_argument("--rates", required=True, help="requests/s, comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")

    import numpy as np
    import torch

    from portbench import run

    bench = run.with_held_back(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for rate in (float(r) for r in args.rates.split(",")):
        def resize(spec, config, traffic, rate=rate):
            traffic["rate"] = rate
        ctx = run.make_context(bench, args.workload, args.seed, args.seconds, False,
                               torch.device("cuda", 0), time.perf_counter, resize)
        out, _ = run.drive(ctx)
        late = out.observed["late_s"]
        n = len(late) // 5
        print(json.dumps(run._finite({
            "rate": rate, "requests": len(late),
            "p50_ms": float(np.percentile(late, 50)) * 1e3,
            "p95_ms": float(np.percentile(late, 95)) * 1e3,
            "p99_ms": float(np.percentile(late, 99)) * 1e3,
            "first_fifth_ms": float(np.mean(late[:n])) * 1e3,
            "last_fifth_ms": float(np.mean(late[-n:])) * 1e3,
            "service_p50_ms": float(np.median(out.observed["service_s"])) * 1e3,
            "completed_per_s": out.observed["steps"] / out.window_s})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
