"""The NeXtVLAD cell (`nextvlad_eval.b256`) on the CPU at small sizes: a
sound run comes out correct, and an altered prediction, pack class or
pack loss does not; its control's rows are packed as the program packs
them; `counts_vlad` counts what `FlopCounterMode` counts on the
reference; and each of the cell's per-layer readers reads None where its
run holds nothing to read and the right value on a synthetic run."""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts_vlad, run, weights_vlad
from portbench.drivers import eval_loop, vlad_eval
from portbench.reference import model as ref_model
from portbench.reference import nextvlad as ref_vlad
from portbench.tests.small import bench, resize
from portbench.tests.test_portbench_faults import (
    _alter_eval_step,
    pack_class,
    pack_loss,
    prediction,
)

BENCH = bench()
CELL = "nextvlad_eval.b256"
METRICS = ["mfu.vlad_eval", "vlad_step_roofline.vlad_eval", "vlad_dispatch_ms.vlad_eval",
           "device_idle.vlad_eval", "loader_wait_ms.vlad_eval", "h2d_enqueue_ms.vlad_eval"]
SMALL_WIDTHS = {"vlad_clusters": 8, "groups": 4, "expansion": 2, "hidden_size": 32,
                "gating_reduction": 4, "drop_rate": 0.5}


def _resize(spec, config, traffic):
    """small.py's sizes at every frame; the widths stay the program's
    defaults (the published ones), which the small features split."""
    resize(spec, config, traffic)
    config["flags"]["every_n"] = 1


def _run(trace=False, seed=2 ** 31 + 99):
    return run.run_cell(BENCH, CELL, seed, 0.6, trace, torch.device("cpu"),
                        time.perf_counter, _resize)


def test_the_cell_is_in_the_benchmark():
    assert CELL in [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["eval_videos_per_s"]["workloads"]
    assert {m["name"] for m in run.reported(BENCH, CELL, "per_layer")} == set(METRICS)


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


@pytest.mark.parametrize("classes,k", [(32, 20), (32, 5), (20000, 4)])
def test_control_rows_are_packed_as_the_program_packs(classes, k):
    from efficientvideoclassification_youtube8m_torch.train import step as tstep

    g = torch.Generator().manual_seed(3)
    preds = torch.rand(6, classes, generator=g)
    labels = torch.rand(6, classes, generator=g) < 0.2
    want = tstep._eval_outputs(preds, labels, k)["host_pack"].numpy()
    got = vlad_eval.pack_rows(preds, labels, k)
    assert got.shape == want.shape
    fields = eval_loop.unpack(got, k, classes)
    assert (fields["topk_idx"] == eval_loop.unpack(want, k, classes)["topk_idx"]).all()
    assert (got[:, :-2] == want[:, :-2]).all()  # values, and classes lane for lane
    gaps = eval_loop.pack_gaps([got], [preds], [{"labels": labels.numpy()}], k, classes)
    assert gaps["topk_max_abs"] == 0 and gaps["loss_mean_rel"] < 1e-6


def test_counts_are_the_flop_counters():
    flags = {"feature_sizes": "12, 4", "num_classes": 24, "max_num_frames": 30}
    leaves = weights_vlad.draw({"flags": flags, "nextvlad": SMALL_WIDTHS}, 5, "cpu")
    x = ref_model.preprocess(torch.randint(0, 256, (3, 30, 16), dtype=torch.uint8),
                             torch.tensor([30, 4, 17]))
    with FlopCounterMode(display=False) as counter:
        ref_vlad.forward(leaves, x, torch.tensor([30, 4, 17]), (12, 4))
    assert counts_vlad.forward_flops(flags, SMALL_WIDTHS, 3) == counter.get_total_flops()
    assert counts_vlad.parameters(flags, SMALL_WIDTHS) == sum(t.numel() for t in leaves.values())


def test_counts_at_the_published_widths():
    cfg = run.make_context(BENCH, CELL, 1, 1.0, False, torch.device("cpu"),
                           time.perf_counter).config
    flags, widths = cfg["flags"], cfg["nextvlad"]
    assert counts_vlad.parameters(flags, widths) == 88_970_274
    assert counts_vlad.forward_flops(flags, widths, 1) == 2_922_037_248
    # 748 GFLOP a batch of 256 over 989 TFLOP/s: bound by the products
    assert counts_vlad.bound_s(flags, widths, 256) == pytest.approx(0.756e-3, rel=1e-3)


class _Run:
    flags = {"feature_sizes": "12, 4", "num_classes": 24, "max_num_frames": 30,
             "num_readers": 4}
    window_s = 2.0

    def __init__(self, trace=None, steps=0):
        self.trace = trace
        self.observed = {"batch": 8, "steps": steps, "loader_wait_s": 0.4,
                         "widths": SMALL_WIDTHS}


def _registry(monkeypatch, spans, counters):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    spans = {n: {"count": 1, "seconds": s, "self_seconds": s} for n, s in spans.items()}
    monkeypatch.setattr(profiling, "totals", lambda: {"spans": spans, "counters": counters})


@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_is_none_with_nothing_to_read(monkeypatch, metric):
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    profiling.reset()
    assert run.load_reader(metric)(_Run()) is None
    monkeypatch.delattr(profiling, "totals")
    assert run.load_reader(metric)(_Run()) is None


def test_the_readers_on_a_synthetic_run(monkeypatch):
    _registry(monkeypatch, {"nextvlad.video": 0.06, "nextvlad.audio": 0.03,
                            "nextvlad.gate": 0.03, "prefetch.h2d": 0.6, "step.eval": 9.0},
              {"eval.batches": 12})
    trace = {"window_s": 3.0, "busy_s": 0.75,
             "kernels": {"gemm": [10, 0.004], "softmax": [4, 0.002],
                         "Memcpy HtoD (Pinned -> Device)": [12, 0.5], "Memset (Device)": [1, 0.1]}}
    r = _Run(trace, steps=40)
    read = {m: run.load_reader(m)(r) for m in METRICS}
    flops = counts_vlad.forward_flops(_Run.flags, SMALL_WIDTHS, 8)
    assert math.isclose(read["mfu.vlad_eval"], 100 * flops * 40 / 2.0 / 989e12)
    bound = counts_vlad.bound_s(_Run.flags, SMALL_WIDTHS, 8)
    assert math.isclose(read["vlad_step_roofline.vlad_eval"], 100 * bound * 12 / 0.006)
    assert math.isclose(read["vlad_dispatch_ms.vlad_eval"], 10.0)
    assert math.isclose(read["device_idle.vlad_eval"], 75.0)
    assert math.isclose(read["loader_wait_ms.vlad_eval"], 10.0)
    assert math.isclose(read["h2d_enqueue_ms.vlad_eval"], 50.0)


def test_a_traced_run_reports_the_host_side_metrics():
    """On the CPU the trace holds no kernels, so the roofline reads None;
    the card's traced runs report it."""
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    profiling.reset()
    r = _run(trace=True, seed=2 ** 31 + 7)
    assert r["correct"], r["checks"]
    for name in set(METRICS) - {"vlad_step_roofline.vlad_eval"}:
        value = r["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value) and value >= 0, name
