"""The port's tracing system (utils/profiling.py) on the CPU: off, a span
neither enters `record_function` nor records; on, its records carry
parent, batch and thread, `totals()` adds them up, and its clock is the
profiler's; a reader thread's span reaches `trace`'s Chrome trace on a
track of its own; the registry keeps every update under threads and
bounds its ring. Then the spans and counters of the loader (both
streams, both parsers) and of `cli.eval`'s `run_eval_epoch` at
`--steps_per_dispatch` 1 and 4."""

import itertools
import json
import math
import os
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import flags
from efficientvideoclassification_youtube8m_torch.data import (
    FrameDataLoader,
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_torch.data import native
from efficientvideoclassification_youtube8m_torch.train.checkpoint import save_checkpoint
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import init_distill_state
from efficientvideoclassification_youtube8m_torch.utils import profiling


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spin(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_off_a_span_neither_enters_record_function_nor_records(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_RANGE", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    profiling.reset()
    spans = {id(profiling.annotate("a")), id(profiling.annotate("b", batch=2))}
    with profiling.annotate("loader.parse", batch=1):
        with profiling.annotate("inner"):
            x = torch.arange(4).sum()
    profiling.count("eval.batches")
    assert int(x) == 6
    assert len(spans) == 1  # one shared no-op context
    assert profiling.records() == []
    assert profiling.totals() == {"spans": {}, "counters": {}}


def test_on_records_carry_parent_batch_and_thread_and_totals_add_up():
    profiling.reset()
    seen = {}

    def reader():
        seen["tid"] = threading.get_native_id()
        with profiling.annotate("loader.parse"):
            _spin(0.002)
        profiling.count("loader.videos")

    with _cpu_profile():
        with profiling.annotate("eval.accumulate", batch=3):
            _spin(0.01)
            with profiling.annotate("eval.unpack", batch=3):
                _spin(0.005)
            with profiling.annotate("eval.summary"):
                _spin(0.002)
        profiling.count("eval.batches")
        profiling.count("eval.batches", 2)
        t = threading.Thread(target=reader)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    main = threading.get_native_id()
    recs = {r[0]: r for r in profiling.records()}
    assert set(recs) == {"eval.accumulate", "eval.unpack", "eval.summary", "loader.parse"}
    assert recs["eval.unpack"][4:] == ("eval.accumulate", 3)
    assert recs["eval.summary"][4:] == ("eval.accumulate", None)
    assert recs["eval.accumulate"][4:] == (None, 3)
    assert recs["loader.parse"][4:] == (None, None)
    assert recs["loader.parse"][1] == seen["tid"] != main
    assert {recs[n][1] for n in ("eval.accumulate", "eval.unpack", "eval.summary")} == {main}
    for name, tid, start, end, _, _ in recs.values():
        assert end > start
    tot = profiling.totals()
    assert tot["counters"] == {"eval.batches": 3, "loader.videos": 1}
    dur = {n: (r[3] - r[2]) * 1e-9 for n, r in recs.items()}
    outer = tot["spans"]["eval.accumulate"]
    assert outer["count"] == 1
    assert math.isclose(outer["seconds"], dur["eval.accumulate"], rel_tol=1e-9)
    assert math.isclose(outer["self_seconds"],
                        dur["eval.accumulate"] - dur["eval.unpack"] - dur["eval.summary"],
                        rel_tol=1e-9)
    assert outer["seconds"] >= 0.017 and outer["self_seconds"] >= 0.01
    for leaf in ("eval.unpack", "eval.summary", "loader.parse"):
        assert tot["spans"][leaf]["count"] == 1
        assert tot["spans"][leaf]["self_seconds"] == tot["spans"][leaf]["seconds"]


def test_a_span_lies_on_the_profilers_clock():
    """Each span's start and end within 1 ms of its own `record_function`
    event in the profiler's results."""
    profiling.reset()
    with _cpu_profile() as prof:
        with torch.profiler.record_function("warm"):
            pass
        for i in range(5):
            with profiling.annotate(f"clock.{i}"):
                torch.ones(256).sum()
                _spin(0.001)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    recs = profiling.records()
    assert len(recs) == 5
    for name, _, start, end, _, _ in recs:
        e = events[name]
        assert abs(start - e.start_ns()) < 1_000_000, name
        assert abs(end - (e.start_ns() + e.duration_ns())) < 1_000_000, name


def test_a_reader_threads_span_reaches_the_chrome_trace_on_its_own_track(tmp_path):
    seen = {}

    def reader():
        seen["tid"] = threading.get_native_id()
        for _ in range(3):
            with profiling.annotate("loader.parse"):
                _spin(0.001)
            profiling.count("loader.videos")

    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        with profiling.annotate("loader.queue_wait"):
            th = threading.Thread(target=reader)
            th.start()
            th.join(timeout=30)
    assert not th.is_alive()
    doc = json.load(open(t.path))
    events = doc["traceEvents"]
    parse = [e for e in events if e.get("name") == "loader.parse"]
    assert len(parse) == 3
    assert {e["tid"] for e in parse} == {seen["tid"]}
    assert all(e["ph"] == "X" and e["pid"] == os.getpid() for e in parse)
    assert any(e.get("ph") == "M" and e.get("name") == "thread_name"
               and e.get("tid") == seen["tid"] for e in events)
    # the main thread's span is the profiler's own event, written once, and
    # the reader's spans lie inside it on the same time base
    wait = [e for e in events if e.get("name") == "loader.queue_wait"]
    assert len(wait) == 1 and wait[0]["tid"] != seen["tid"]
    lo, hi = wait[0]["ts"], wait[0]["ts"] + wait[0]["dur"]
    assert all(lo - 1000 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1000 for e in parse)
    assert t.totals["spans"]["loader.parse"]["count"] == 3
    assert t.totals["counters"] == {"loader.videos": 3}


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        with profiling.annotate("input_pipeline"):
            torch.ones(64).sum()
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert t.path is not None and os.path.dirname(t.path) == str(tmp_path / "trace")
    events = json.load(open(t.path))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "input_pipeline" in names
    assert any("mm" in str(n) for n in names)
    assert any(e.key == "input_pipeline" for e in t.profile.key_averages())
    assert t.totals["spans"]["input_pipeline"]["count"] == 1


def test_annotate_runs_outside_a_trace():
    with profiling.annotate("host work"):
        x = torch.arange(4).sum()
    assert int(x) == 6


def test_no_update_is_lost_between_threads():
    """More threads than cores, switching every microsecond: every span
    and every count arrives."""
    threads, each = 2 * (os.cpu_count() or 1) + 2, 400
    old = sys.getswitchinterval()
    profiling.reset()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work():
                for _ in range(each):
                    with profiling.annotate("outer"):
                        with profiling.annotate("inner"):
                            pass
                    profiling.count("n")

            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    tot = profiling.totals()
    assert tot["counters"]["n"] == threads * each
    assert tot["spans"]["outer"]["count"] == tot["spans"]["inner"]["count"] == threads * each
    assert all(r[4] == "outer" for r in profiling.records() if r[0] == "inner")


def test_the_ring_is_bounded_and_the_totals_are_not(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 5)
    profiling.reset()
    try:
        with _cpu_profile():
            for i in range(8):
                with profiling.annotate("s", batch=i):
                    pass
        assert [r[5] for r in profiling.records()] == [3, 4, 5, 6, 7]
        assert profiling.totals()["spans"]["s"]["count"] == 8
    finally:
        monkeypatch.undo()
        profiling.reset()


# ------------------------------------------------ the loader's spans

VIDEOS = 53  # 7 batches of 8, the last with 3 padding rows
SIZES = dict(feature_sizes=(6, 2), max_frames=40, vocab_size=40)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    write_synthetic_frame_shard(str(root / "eval-0000.tfrecord"), 30, seed=5, **SIZES)
    write_synthetic_frame_shard(str(root / "eval-0001.tfrecord"), VIDEOS - 30, seed=6,
                                **SIZES)
    return root


@pytest.mark.parametrize("deterministic", [False, True], ids=["workstealing", "ordered"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_loader_spans_and_counter(shards, deterministic, use_native):
    if use_native and not native.available():
        pytest.skip("the native parser did not build here")
    loader = FrameDataLoader(
        str(shards / "eval-*.tfrecord"), batch_size=8, feature_names=("rgb", "audio"),
        feature_sizes=SIZES["feature_sizes"], max_frames=SIZES["max_frames"],
        vocab_size=SIZES["vocab_size"], num_readers=2, num_epochs=1, shuffle=False,
        pad_final_batch=True, use_native=use_native, frame_stride=2,
        deterministic=deterministic)
    assert (loader._native is not None) == use_native
    profiling.reset()
    with _cpu_profile():
        batches = list(loader)
    main = threading.get_native_id()
    tot = profiling.totals()
    assert len(batches) == 7
    # in order, the native batcher fills the batches unless the order of
    # several readers is kept; its team counts its waits for a stream
    in_place = use_native and not deterministic
    counters = dict(tot["counters"])
    waits = counters.pop("loader.stream_waits", None)
    assert counters == {"loader.videos": VIDEOS,
                        **({"loader.in_place": 7} if in_place else {})}
    assert (waits is not None) == in_place and (waits or 0) >= 0
    spans = tot["spans"]
    assert spans["loader.assemble"]["count"] == 7
    assert spans["loader.parse"]["count"] >= VIDEOS
    assert spans["loader.queue_wait"]["count"] == 7  # one fill a batch
    assert spans.get("loader.decode", {"count": 0})["count"] == (VIDEOS if in_place else 0)
    tids = {}
    for name, tid, *_ in profiling.records():
        tids.setdefault(name, set()).add(tid)
    assert tids["loader.queue_wait"] == tids["loader.assemble"] == {main}
    # the per-video route's two readers, or the batcher's team
    threads = native.team_size(2) if in_place else 2
    assert main not in tids["loader.parse"] and 1 <= len(tids["loader.parse"]) <= threads


def test_the_batchers_parse_spans_are_its_readers_inside_the_trace(shards, tmp_path):
    """Under `trace`, an endless in-order stream filled by the native
    batcher: its `loader.parse` records are those of its team's threads
    (threads that run no Python), each inside the traced stretch, their
    totals what the records add up to, and `portbench/spans.busy_share`
    reads a share of the streams' time from them."""
    from portbench import spans as bench_spans

    if not native.available():
        pytest.skip("the native parser did not build here")
    loader = FrameDataLoader(
        str(shards / "eval-*.tfrecord"), batch_size=8, feature_sizes=SIZES["feature_sizes"],
        max_frames=SIZES["max_frames"], vocab_size=SIZES["vocab_size"], num_readers=2,
        num_epochs=None, shuffle=False, frame_stride=2)
    assert loader._fills_in_place()
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        start = time.time_ns()
        for _ in itertools.islice(loader, 30):
            with profiling.annotate("eval.accumulate"):
                _spin(0.002)
        end = time.time_ns()
    python_threads = {th.native_id for th in threading.enumerate()}
    recs = [r for r in profiling.records() if r[0] == "loader.parse"]
    tids = {r[1] for r in recs}
    assert len(recs) >= 30 * 8 and 1 <= len(tids) <= native.team_size(2)
    assert not tids & python_threads
    assert all(start <= r[2] < r[3] <= end and r[4:] == (None, None) for r in recs)
    parse = t.totals["spans"]["loader.parse"]
    assert parse["count"] == len(recs)
    assert math.isclose(parse["seconds"], sum(r[3] - r[2] for r in recs) * 1e-9)
    assert t.totals["counters"]["loader.in_place"] == 30

    class Run:
        flags = {"num_readers": 2}

    share = bench_spans.busy_share(Run(), "loader.parse")
    assert 0 < share < 100


@pytest.mark.parametrize("streams", [1, 2])
def test_the_batchers_reads_and_decodes_under_a_trace(shards, tmp_path, monkeypatch, streams):
    """Under `trace`, an endless in-order stream over 1 or 2 record streams
    decoded by a team of 7 (a process that may run on 8 CPUs): the
    `loader.parse` records, a stream held, never overlap more than
    `num_readers` deep; the `loader.decode` records are the team's threads
    (which run no Python), at least one a video of the batches taken, each
    inside the traced stretch; and `loader.stream_waits` counts the
    threads' waits for a stream."""
    if not native.available():
        pytest.skip("the native parser did not build here")
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    loader = FrameDataLoader(
        str(shards / "eval-*.tfrecord"), batch_size=8, feature_sizes=SIZES["feature_sizes"],
        max_frames=SIZES["max_frames"], vocab_size=SIZES["vocab_size"],
        num_readers=streams, num_epochs=None, shuffle=False)
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        start = time.time_ns()
        for _ in itertools.islice(loader, 60):
            with profiling.annotate("eval.accumulate"):
                pass
        end = time.time_ns()
    recs = profiling.records()
    # a read's end sorts before another's start at the same ns
    edges = sorted([(r[2], 1) for r in recs if r[0] == "loader.parse"]
                   + [(r[3], -1) for r in recs if r[0] == "loader.parse"])
    depths = list(itertools.accumulate(d for _, d in edges))
    assert len(edges) >= 2 * 60 * 8 and max(depths) <= streams and min(depths) >= 0
    decodes = [r for r in recs if r[0] == "loader.decode"]
    tids = {r[1] for r in decodes}
    assert len(decodes) >= 60 * 8 and 1 <= len(tids) <= 7
    assert not tids & {th.native_id for th in threading.enumerate()}
    assert all(start <= r[2] < r[3] <= end and r[4:] == (None, None) for r in decodes)
    assert t.totals["spans"]["loader.decode"]["count"] == len(decodes)
    assert t.totals["counters"]["loader.stream_waits"] > 0


# ------------------------------------------------ run_eval_epoch's spans

TINY_FLAGS = [
    "--num_classes", "40", "--batch_size", "8", "--lstm_cells", "8",
    "--lstm_layers", "2", "--max_num_frames", "40",
    "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2", "--every_n", "2",
    "--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
    "--num_readers", "2", "--top_k", "5", "--scan_unroll", "1",
    "--device", "cpu", "--run_once", "true", "--compute_dtype", "float32",
]
LOOP_SPANS = {"loader.queue_wait", "loader.assemble", "loader.parse", "loader.decode",
              "prefetch.h2d", "step.eval", "fetch.enqueue", "fetch.wait",
              "eval.accumulate", "eval.unpack", "metrics.accumulate_topk", "eval.summary"}


@pytest.fixture(scope="module")
def train_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_spans")
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    save_checkpoint(str(root / "train"), init_distill_state(cfg, make_optimizer(cfg.optimizer)),
                    3)
    return str(root / "train")


@pytest.mark.parametrize("k", [1, 4])
def test_run_eval_epoch_spans_at_k(shards, train_dir, tmp_path, k):
    """cli.eval's epoch under a trace: every span of the eval path and the
    loader appears, under the same names at K = 1 and K = 4, and
    `eval.batches` counts the batches accumulated. `prefetch.pin` is the
    pinned copy's, which only a CUDA device makes."""
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        result = eval_cli.main(TINY_FLAGS + [
            "--train_dir", train_dir, "--eval_data_pattern", str(shards / "eval-*.tfrecord"),
            "--steps_per_dispatch", str(k)])
    assert result is not None
    spans, counters = t.totals["spans"], t.totals["counters"]
    assert set(spans) == LOOP_SPANS
    # cli.eval reads in order: the native batcher fills the batches, its
    # team counting its waits for a stream
    assert counters.pop("loader.stream_waits") >= 0
    assert counters == {"loader.videos": VIDEOS, "eval.batches": 7, "loader.in_place": 7}
    assert spans["metrics.accumulate_topk"]["count"] == spans["eval.summary"]["count"] == 7
    groups = math.ceil(7 / k)  # one fetch a group of k batches
    assert spans["fetch.enqueue"]["count"] == spans["fetch.wait"]["count"] == groups
    assert spans["eval.accumulate"]["count"] == spans["eval.unpack"]["count"] == 7
    assert spans["prefetch.h2d"]["count"] == 7
    assert spans["step.eval"]["count"] == 7  # the last group runs its one batch
    assert spans["loader.assemble"]["count"] == spans["loader.queue_wait"]["count"] == 7
    for s in spans.values():
        assert 0 <= s["self_seconds"] <= s["seconds"]
    parents = {r[0]: r[4] for r in profiling.records()}
    for child in ("eval.unpack", "metrics.accumulate_topk", "eval.summary"):
        assert parents[child] == "eval.accumulate"
