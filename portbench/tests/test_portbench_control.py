"""On the card: each cell's control comes out not correct by the cell's
limits, and the sound program correct, at the configurations' widths and
a batch of 32 (training, eval) or the cell's own request size (serving),
on two seeds. The same readings at the cells' own sizes are
`portbench/calibrate.py`'s."""

import json
import time

import pytest
import torch

from portbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _smaller(spec, config, traffic):
    config["flags"]["batch_size"] = 32
    if traffic["kind"] == "pool":
        traffic["videos"] = 256
    else:
        traffic["requests"] = 8
    if "shuffle_buffer" in traffic:
        traffic["shuffle_buffer"] = 64


def _fails(numbers, limits):
    return any(k in limits and not v <= limits[k] for k, v in numbers.items())


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    device = torch.device("cuda", 0)
    for seed in (101, 2 ** 31 + 102):
        ctx = run.make_context(BENCH, cell, seed, 1.0, False, device, time.perf_counter,
                               _smaller)
        out, control = run.drive(ctx, lambda d, o: d.control(ctx, o))
        limits = ctx.spec["check"]["limits"]
        assert not _fails(out.numbers, limits), out.numbers
        assert any(_fails(numbers, limits) for numbers in control.values()), control
