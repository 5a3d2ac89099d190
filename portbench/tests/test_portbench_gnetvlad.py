"""The Gated NetVLAD cell (`gnetvlad_eval.b256`) on the CPU at small sizes:
the cell, its configuration and its twelve per-layer metrics are in
BENCHMARK.json; a sound run comes out correct, and each fault planted in
the program's model (a batch norm left out, the centers' term dropped,
the intra-normalisation dropped, the padding frames unmasked, the
probability gate dropped), as each altered answer of the step, does not;
`counts_gnetvlad` counts what `FlopCounterMode` counts on the reference
and the published figures; each reader reads None where its run holds
nothing to read and the right value on a synthetic run. On the card
(`card`): a cluster batch norm left out fails `correct` at the cell's own
size, on three seeds."""

import math
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts_gnetvlad, harness, run, weights_gnetvlad
from portbench.reference import gated_netvlad as ref_gnetvlad
from portbench.reference import model as ref_model
from portbench.tests.small import bench, resize
from portbench.tests.test_portbench_faults import (
    _alter_eval_step,
    pack_class,
    pack_loss,
    prediction,
)

torch.set_num_threads(1)

BENCH = bench()
CELL = "gnetvlad_eval.b256"
CONFIG = "gnetvlad_yt8m2017"
METRICS = ["mfu.gnetvlad_eval", "gnetvlad_step_roofline.gnetvlad_eval",
           "gnetvlad_dispatch_ms.gnetvlad_eval", "device_idle.gnetvlad_eval",
           "loader_wait_ms.gnetvlad_eval", "reader_busy.gnetvlad_eval",
           "decode_busy.gnetvlad_eval", "loader_queue_wait_ms.gnetvlad_eval",
           "h2d_enqueue_ms.gnetvlad_eval", "step_dispatch_ms.gnetvlad_eval",
           "host_metrics_ms.gnetvlad_eval", "fetch_wait_ms.gnetvlad_eval"]
FLAGS = {"feature_sizes": "12, 4", "num_classes": 24, "max_num_frames": 30,
         "moe_num_mixtures": 2, "every_n": 1, "num_readers": 4}
SMALL_WIDTHS = {"vlad_clusters": 8, "hidden_size": 32}


def _resize(spec, config, traffic):
    """small.py's sizes at every frame; the widths stay the program's
    defaults (the published ones)."""
    resize(spec, config, traffic)
    config["flags"]["every_n"] = 1


def _run(trace=False, seed=2 ** 31 + 99):
    return run.run_cell(BENCH, CELL, seed, 0.6, trace, torch.device("cpu"),
                        time.perf_counter, _resize)


# ------------------------------------------- faults planted in the model
# Each takes (monkeypatch, the program's module) and breaks one part of
# the mathematics; tests/test_torch_gated_netvlad.py plants them too.


def skip_bn(path):
    """The batch norm at `path` (`input_bn`, `video.cluster_bn`, ...) left
    out."""
    def fault(monkeypatch, module):
        from efficientvideoclassification_youtube8m_torch.models import frame_level

        norm, real = module.get_submodule(path), frame_level._bn_apply
        monkeypatch.setattr(frame_level, "_bn_apply", lambda p, x, is_training, **kw: (
            (x, {}) if p is norm else real(p, x, is_training, **kw)))
    fault.__name__ = f"skip_{path}"
    return fault


def drop_centers(monkeypatch, module):
    with torch.no_grad():
        module.video.centers.zero_()
        module.audio.centers.zero_()


def drop_intra_normalisation(monkeypatch, module):
    from efficientvideoclassification_youtube8m_torch.models import frame_level

    real = frame_level._l2_rows
    monkeypatch.setattr(frame_level, "_l2_rows",
                        lambda x, dim: x if x.dim() == 3 else real(x, dim))


def unmask_padding(monkeypatch, module):
    from efficientvideoclassification_youtube8m_torch.models import frame_level

    monkeypatch.setattr(frame_level, "_frame_mask", lambda nf, T, device=None: torch.ones(
        len(nf), T, 1, device=device))


def drop_prob_gate(monkeypatch, module):
    real = module._gate
    monkeypatch.setattr(module, "_gate", lambda name, act, norm, dtype: (
        torch.ones_like(act) if name == "prob_gate" else real(name, act, norm, dtype)))


MODEL_FAULTS = [skip_bn("input_bn"), skip_bn("video.cluster_bn"), skip_bn("audio.cluster_bn"),
                skip_bn("gate_bn"), drop_centers, drop_intra_normalisation, unmask_padding,
                drop_prob_gate]


def _plant(monkeypatch, fault):
    """`fault` planted in the module the driver builds."""
    real = harness.program_tower

    def tower(cfg, leaves, device):
        module = real(cfg, leaves, device)
        fault(monkeypatch, module)
        return module
    monkeypatch.setattr(harness, "program_tower", tower)


# ------------------------------------------------------------- the cell


def test_the_cell_is_in_the_benchmark():
    assert CELL in [w["name"] for w in BENCH["workloads"]]
    entry = run.cell_entry(BENCH, CELL)
    assert entry["chips"] == 1 and entry["traffic"] == "pool_every_n_ordered"
    assert entry["config"] == CONFIG
    config = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    assert config["reduced"] == [] and config["file"] == f"portbench/configs/{CONFIG}.json"
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["eval_videos_per_s"]["workloads"]
    reported = run.reported(BENCH, CELL, "per_layer")
    assert {m["name"] for m in reported} == set(METRICS)
    assert all(m["workloads"] == [CELL] and m["moves"] == "eval_videos_per_s"
               for m in reported)


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"prob_max_abs", "prob_mean_abs", "topk_max_abs",
                                "loss_mean_rel", "info_max_abs"}


@pytest.mark.parametrize("fault", MODEL_FAULTS, ids=lambda f: f.__name__)
def test_a_fault_in_the_model_is_caught(monkeypatch, fault):
    _plant(monkeypatch, fault)
    assert not _run()["correct"]


@pytest.mark.parametrize("alter", [prediction, pack_class, pack_loss],
                         ids=lambda f: f.__name__)
def test_eval_answer_altered_is_caught(monkeypatch, alter):
    _alter_eval_step(monkeypatch, alter)
    assert not _run()["correct"]


def test_a_width_the_program_lacks_fails_the_run():
    """A configuration whose widths are not the program's defaults fails
    before the window."""
    def resize_widths(spec, config, traffic):
        _resize(spec, config, traffic)
        config["gnetvlad"]["hidden_size"] = 512

    with pytest.raises(ValueError, match="GatedNetVLADModel holds"):
        run.run_cell(BENCH, CELL, 5, 0.6, False, torch.device("cpu"), time.perf_counter,
                     resize_widths)


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 123, 3100002771, 3100002772])
def test_a_cluster_norm_left_out_fails_at_the_cells_size(monkeypatch, seed):
    """The cell as the benchmark runs it (batch 256, 300 frames, the
    published widths) with the video branch's cluster batch norm left
    out: not correct, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    _plant(monkeypatch, skip_bn("video.cluster_bn"))
    r = run.run_cell(BENCH, CELL, seed, 2.0, False, torch.device("cuda", 0),
                     time.perf_counter)
    print({k: (c["value"], c["limit"]) for k, c in r["checks"].items()})
    assert not r["correct"]


# ------------------------------------------------------------- counts


def test_counts_are_the_flop_counters():
    leaves = weights_gnetvlad.draw({"flags": FLAGS, "gnetvlad": SMALL_WIDTHS}, 5, "cpu")
    nf = torch.tensor([30, 4, 17])
    x = ref_model.preprocess(torch.randint(0, 256, (3, 30, 16), dtype=torch.uint8), nf)
    with FlopCounterMode(display=False) as counter:
        ref_gnetvlad.forward(leaves, x, nf, (12, 4))
    assert counts_gnetvlad.forward_flops(FLAGS, SMALL_WIDTHS, 3) == counter.get_total_flops()
    assert counts_gnetvlad.parameters(FLAGS, SMALL_WIDTHS) == sum(
        t.numel() for t in leaves.values())


def test_counts_at_the_published_widths():
    config = run.make_context(BENCH, CELL, 1, 1.0, False, torch.device("cpu"),
                              time.perf_counter).config
    flags, widths = config["flags"], config["gnetvlad"]
    # the FC 285.2 M, the MoE 24.2 M, the probability gate 22.2 M
    assert counts_gnetvlad.parameters(flags, widths) == 333_244_440
    # 0.9995 GFLOP a video, 255.9 GFLOP a batch of 256
    assert counts_gnetvlad.forward_flops(flags, widths, 1) == 999_529_248
    assert counts_gnetvlad.forward_flops(flags, widths, 256) == pytest.approx(255.9e9, rel=2e-4)
    # 0.76 GB at least (every parameter once in bf16, the uint8 frames,
    # the predictions): 0.227 ms; the products' 0.259 ms bound it
    assert counts_gnetvlad.forward_bytes(flags, widths, 256) == pytest.approx(0.76e9, rel=1e-2)
    assert counts_gnetvlad.bound_s(flags, widths, 256) == pytest.approx(0.259e-3, rel=2e-3)


# ------------------------------------------------------------- readers


class _Run:
    flags = FLAGS
    window_s = 2.0

    def __init__(self, trace=None, steps=0):
        self.trace = trace
        self.observed = {"batch": 8, "steps": steps, "loader_wait_s": 0.4,
                         "widths": SMALL_WIDTHS}


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
    """16 steps launched in the traced stretch, 12 of them accumulated: the
    roofline and the dispatch count the launches, the loop's spans the
    batches accumulated."""
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    _registry(monkeypatch, {"gnetvlad.video": (16, 0.04), "gnetvlad.audio": (16, 0.02),
                            "gnetvlad.hidden": (16, 0.01), "gnetvlad.head": (16, 0.01),
                            "step.eval": (16, 0.18), "loader.queue_wait": (12, 0.06),
                            "prefetch.h2d": (12, 0.024), "eval.accumulate": (12, 0.036),
                            "fetch.wait": (12, 0.012)},
              {"eval.batches": 12})
    # the loop's thread (1) records from 0 to 2 s; two readers parse 1 s
    # and 2.5 s, 0.5 s of it after the loop's last span: 2.5 of 4 x 2 s;
    # two decoders of the team decode 1 s and 1.5 s: 2.5 of 2 x 2 s
    s = 10 ** 9
    monkeypatch.setattr(profiling, "records", lambda: [
        ("eval.accumulate", 1, 0, s, None, 0), ("eval.accumulate", 1, s, 2 * s, None, 1),
        ("loader.parse", 7, 0, s, None, None), ("loader.parse", 8, s // 2, 3 * s, None, None),
        ("loader.decode", 9, 0, s, None, None), ("loader.decode", 10, s // 2, 2 * s, None, None)])
    trace = {"window_s": 3.0, "busy_s": 0.75,
             "kernels": {"gemm": [10, 0.004], "softmax": [4, 0.002],
                         "Memcpy HtoD (Pinned -> Device)": [12, 0.5], "Memset (Device)": [1, 0.1]}}
    r = _Run(trace, steps=40)
    read = {m: run.load_reader(m)(r) for m in METRICS}
    flops = counts_gnetvlad.forward_flops(FLAGS, SMALL_WIDTHS, 8)
    assert math.isclose(read["mfu.gnetvlad_eval"], 100 * flops * 40 / 2.0 / 989e12)
    bound = counts_gnetvlad.bound_s(FLAGS, SMALL_WIDTHS, 8)
    assert math.isclose(read["gnetvlad_step_roofline.gnetvlad_eval"], 100 * bound * 16 / 0.006)
    assert math.isclose(read["gnetvlad_dispatch_ms.gnetvlad_eval"], 5.0)
    assert math.isclose(read["device_idle.gnetvlad_eval"], 75.0)
    assert math.isclose(read["loader_wait_ms.gnetvlad_eval"], 10.0)
    assert math.isclose(read["reader_busy.gnetvlad_eval"], 31.25)
    assert math.isclose(read["decode_busy.gnetvlad_eval"], 62.5)
    assert math.isclose(read["loader_queue_wait_ms.gnetvlad_eval"], 5.0)
    assert math.isclose(read["h2d_enqueue_ms.gnetvlad_eval"], 2.0)
    assert math.isclose(read["step_dispatch_ms.gnetvlad_eval"], 15.0)
    assert math.isclose(read["host_metrics_ms.gnetvlad_eval"], 3.0)
    assert math.isclose(read["fetch_wait_ms.gnetvlad_eval"], 1.0)


def test_a_traced_run_reports_the_host_side_metrics():
    """On the CPU the trace holds no kernels, so the roofline reads None;
    the card's traced runs report it."""
    from efficientvideoclassification_youtube8m_torch.utils import profiling

    def resize_traced(spec, config, traffic):
        _resize(spec, config, traffic)
        spec["trace"] = {"span_s": 2.0}

    profiling.reset()
    r = run.run_cell(BENCH, CELL, 2 ** 31 + 7, 2.5, True, torch.device("cpu"),
                     time.perf_counter, resize_traced)
    assert r["correct"], r["checks"]
    for name in set(METRICS) - {"gnetvlad_step_roofline.gnetvlad_eval"}:
        value = r["metrics"][name]["value"]
        assert isinstance(value, float) and math.isfinite(value) and value >= 0, name
