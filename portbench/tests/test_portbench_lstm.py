"""The LSTM baseline's cell (`lstm_eval.b256`) on the CPU at small sizes: a
sound run comes out correct, and an altered prediction, pack class or
pack loss, or a scan whose state is reset halfway through the clip, does
not; `counts_lstm` counts what `FlopCounterMode` counts on the reference;
and each of the cell's per-layer readers reads None where its run holds
nothing to read and the right value on a synthetic run. On the card
(`card`): the reset planted in the scan kernel's wrapper fails `correct`
at the cell's own size."""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, counts_lstm, run, weights_lstm
from portbench.reference import lstm as ref_lstm
from portbench.tests.small import bench, resize
from portbench.tests.test_portbench_faults import (
    _alter_eval_step,
    pack_class,
    pack_loss,
    prediction,
)

# one intra-op thread: the small CPU runs gain nothing from more, and a
# worker that takes every core starves the short traced windows of the
# cells tested beside it (test_portbench_vlad.py's, under xdist)
torch.set_num_threads(1)

BENCH = bench()
CELL = "lstm_eval.b256"
METRICS = ["lstm_scan_roofline.lstm_eval", "mfu.lstm_eval", "lstm_dispatch_ms.lstm_eval",
           "device_idle.lstm_eval", "loader_wait_ms.lstm_eval", "reader_busy.lstm_eval",
           "loader_queue_wait_ms.lstm_eval", "h2d_enqueue_ms.lstm_eval",
           "step_dispatch_ms.lstm_eval", "host_metrics_ms.lstm_eval"]
FLAGS = {"feature_sizes": "12, 4", "num_classes": 24, "max_num_frames": 30,
         "lstm_cells": 8, "lstm_layers": 2, "moe_num_mixtures": 2, "every_n": 1,
         "num_readers": 4}


def _resize(spec, config, traffic):
    """small.py's sizes at every frame."""
    resize(spec, config, traffic)
    config["flags"]["every_n"] = 1


def _run(trace=False, seed=2 ** 31 + 99):
    return run.run_cell(BENCH, CELL, seed, 0.6, trace, torch.device("cpu"),
                        time.perf_counter, _resize)


def _resize_traced(spec, config, traffic):
    """`_resize` with a 2-s traced stretch: the loop accumulates a batch
    `fetch_depth` (4) launches after it, and a busy CPU can run fewer than
    five small batches in small.py's 0.5 s, which leaves the per-batch
    readers nothing to read."""
    _resize(spec, config, traffic)
    spec["trace"] = {"span_s": 2.0}


def test_the_cell_is_in_the_benchmark():
    assert CELL in [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["eval_videos_per_s"]["workloads"]
    assert {m["name"] for m in run.reported(BENCH, CELL, "per_layer")} == set(METRICS)
    entry = run.cell_entry(BENCH, CELL)
    assert entry["chips"] == 1 and entry["traffic"] == "pool_every_n_ordered"


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"prob_max_abs", "prob_mean_abs", "topk_max_abs",
                                "loss_mean_rel", "info_max_abs"}


@pytest.mark.parametrize("alter", [prediction, pack_class, pack_loss],
                         ids=lambda f: f.__name__)
def test_eval_answer_altered_is_caught(monkeypatch, alter):
    _alter_eval_step(monkeypatch, alter)
    assert not _run()["correct"]


def _reset_halfway(scan):
    """`scan(layers, xs [B, T, D], seq_len, **kw)` -> final state, with each
    layer's state reset halfway through the clip: the stack scanned as two
    halves, the second from a zero state."""
    def halves(layers, xs, seq_len, **kw):
        half = xs.shape[1] // 2
        first = scan(layers, xs[:, :half], seq_len.clamp(max=half), **kw)
        second = scan(layers, xs[:, half:], (seq_len - half).clamp(min=0), **kw)
        return torch.where((seq_len > half)[:, None], second, first)
    return halves


def test_a_state_reset_halfway_is_caught(monkeypatch):
    """On the CPU the program scans with the plain `multi_lstm_scan`."""
    from efficientvideoclassification_youtube8m_torch.models import frame_level

    monkeypatch.setattr(frame_level, "multi_lstm_scan",
                        _reset_halfway(frame_level.multi_lstm_scan))
    assert not _run()["correct"]


def _reset_kernel_halfway(scan):
    """`lstm_chunk_scan(x_proj [T, B, 4H], w_h, bias, seq_len, forget_bias)`
    with its state reset at step T / 2."""
    def halves(x_proj, w_h, bias, seq_len, forget_bias=1.0):
        half = x_proj.shape[0] // 2
        o1, c1, h1 = scan(x_proj[:half].contiguous(), w_h, bias, seq_len.clamp(max=half),
                          forget_bias)
        o2, c2, h2 = scan(x_proj[half:].contiguous(), w_h, bias,
                          (seq_len - half).clamp(min=0), forget_bias)
        late = (seq_len > half)[:, None]
        return torch.cat([o1, o2]), torch.where(late, c2, c1), torch.where(late, h2, h1)
    halves.launches = scan.launches  # the wrapper counts its calls on its module's name
    return halves


@pytest.mark.card
def test_a_kernel_state_reset_halfway_fails_at_the_cells_size(monkeypatch):
    """The cell as the benchmark runs it (batch 256, 300 frames, the
    published widths), with the scan kernel's state reset at step 150 of
    each layer: not correct. Step 150 lies about 107 steps before the
    end of a mean-length video."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan

    monkeypatch.setattr(lstm_scan, "lstm_chunk_scan",
                        _reset_kernel_halfway(lstm_scan.lstm_chunk_scan))
    r = run.run_cell(BENCH, CELL, 2 ** 31 + 123, 2.0, False, torch.device("cuda", 0),
                     time.perf_counter)
    print({k: (c["value"], c["limit"]) for k, c in r["checks"].items()})
    assert not r["correct"]


def test_counts_are_the_flop_counters():
    leaves = weights_lstm.draw(FLAGS, 5, "cpu")
    frames = torch.randint(0, 256, (3, 30, 16), dtype=torch.uint8)
    with FlopCounterMode(display=False) as counter:
        ref_lstm.predictions(leaves, frames, torch.tensor([30, 4, 17]), FLAGS)
    assert counts_lstm.forward_flops(FLAGS, 3) == counter.get_total_flops()
    assert counts_lstm.parameters(FLAGS) == sum(t.numel() for t in leaves.values())


def test_counts_at_the_published_widths():
    flags = run.make_context(BENCH, CELL, 1, 1.0, False, torch.device("cpu"),
                             time.perf_counter).flags
    assert counts_lstm.parameters(flags) == 113_902_808
    # 10.57 GFLOP a video, 2.707 TFLOP a batch of 256 over 989 TFLOP/s
    assert counts_lstm.forward_flops(flags, 1) == 10_574_069_760
    assert counts_lstm.bound_s(flags, 256) == pytest.approx(2.737e-3, rel=1e-3)
    # the frozen scan bound of a 300-step layer of 256 rows and 1024 units
    assert counts_lstm.scan_bound_ms(flags, 256) == counts.bound_ms(
        "lstm_chunk_scan", 300, 256, 1024) == pytest.approx(0.651, rel=1e-3)


class _Run:
    flags = FLAGS
    window_s = 2.0

    def __init__(self, trace=None, steps=0):
        self.trace = trace
        self.observed = {"batch": 8, "steps": steps, "loader_wait_s": 0.4}


def _registry(monkeypatch, spans, counters):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    spans = {n: {"count": c, "seconds": s, "self_seconds": s}
             for n, (c, s) in spans.items()}
    monkeypatch.setattr(profiling, "totals", lambda: {"spans": spans, "counters": counters})


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_is_none_with_nothing_to_read(monkeypatch, metric):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    profiling.reset()
    assert run.load_reader(metric)(_Run()) is None
    monkeypatch.delattr(profiling, "totals")
    assert run.load_reader(metric)(_Run()) is None


def test_the_readers_on_a_synthetic_run(monkeypatch):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    _registry(monkeypatch, {"lstm.scan": (12, 0.06), "lstm.head": (12, 0.03),
                            "step.eval": (12, 0.6), "loader.queue_wait": (8, 0.08),
                            "prefetch.h2d": (8, 0.016), "eval.accumulate": (8, 0.024)},
              {"eval.batches": 8, "lstm.step_launches": 720})
    # the loop's thread (1) records from 0 to 2 s; two readers parse 1 s
    # and 2.5 s, 0.5 s of it after the loop's last span: 2.5 of 4 x 2 s
    s = 10 ** 9
    monkeypatch.setattr(profiling, "records", lambda: [
        ("eval.accumulate", 1, 0, s, None, 0), ("eval.accumulate", 1, s, 2 * s, None, 1),
        ("loader.parse", 7, 0, s, None, None), ("loader.parse", 8, s // 2, 3 * s, None, None)])
    trace = {"window_s": 3.0, "busy_s": 0.75,
             "kernels": {"void lstm_step_kernel<2, 32, false>": [720, 0.004],
                         "gemm": [24, 0.002], "Memcpy HtoD (Pinned -> Device)": [12, 0.5]}}
    r = _Run(trace, steps=40)
    read = {m: run.load_reader(m)(r) for m in METRICS}
    flops = counts_lstm.forward_flops(FLAGS, 8)
    assert math.isclose(read["mfu.lstm_eval"], 100 * flops * 40 / 2.0 / 989e12)
    # 720 step launches over 30 frames: 24 calls, not the 8 batches accumulated
    bound_s = 24 * counts.bound_ms("lstm_chunk_scan", 30, 8, 8) * 1e-3
    assert math.isclose(read["lstm_scan_roofline.lstm_eval"], 100 * bound_s / 0.004)
    assert math.isclose(read["lstm_dispatch_ms.lstm_eval"], 7.5)
    assert math.isclose(read["device_idle.lstm_eval"], 75.0)
    assert math.isclose(read["loader_wait_ms.lstm_eval"], 10.0)
    assert math.isclose(read["reader_busy.lstm_eval"], 31.25)
    assert math.isclose(read["loader_queue_wait_ms.lstm_eval"], 10.0)
    assert math.isclose(read["h2d_enqueue_ms.lstm_eval"], 2.0)
    assert math.isclose(read["step_dispatch_ms.lstm_eval"], 75.0)
    assert math.isclose(read["host_metrics_ms.lstm_eval"], 3.0)


def test_a_traced_run_reports_the_host_side_metrics():
    """On the CPU the trace holds no kernels and the plain scan counts no
    kernel steps, so the roofline reads None; the card's traced runs
    report it."""
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    profiling.reset()
    r = run.run_cell(BENCH, CELL, 2 ** 31 + 7, 2.5, True, torch.device("cpu"),
                     time.perf_counter, _resize_traced)
    assert r["correct"], r["checks"]
    for name in set(METRICS) - {"lstm_scan_roofline.lstm_eval"}:
        value = r["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value) and value >= 0, name
