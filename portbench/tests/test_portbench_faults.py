"""A run of each cell without the harness's look for a chip, at a small
size on the CPU (float32), comes out correct; with the timed path broken
underneath it comes out not correct, once for each fault the cell can
have: a step that returns its state unchanged, half of the batch left
out (the means taken over the rest), an answer altered where it is
produced (eval: the predictions, or a class or a loss in the packed host
rows), and for eval half of the fetched rows left out or Hit@1 counted
wrong on the host. (Every cell runs on one chip: there is no exchange
between chips to leave out.)"""

import time

import pytest
import torch

from portbench import run
from portbench.tests.small import bench, resize

BENCH = bench()
TRAIN = ["distill.b256", "finetune.b256"]


def _run(cell):
    return run.run_cell(BENCH, cell, 2 ** 31 + 99, 0.6, False, torch.device("cpu"),
                        time.perf_counter, resize)


def _wrap_train(monkeypatch, fault):
    from efficientvideoclassification_youtube8m_torch.parallel import sharded_step

    for name in ("build_sharded_distill_step", "build_sharded_finetune_step"):
        real = getattr(sharded_step, name)

        def build(*a, _real=real, **k):
            return fault(_real(*a, **k))
        monkeypatch.setattr(sharded_step, name, build)


def unchanged(step):
    def fn(state, f, l, n):
        towers = [getattr(state, t) for t in ("teacher", "student") if hasattr(state, t)]
        slots = [getattr(state, f"opt_{t}") for t in ("teacher", "student")
                 if hasattr(state, f"opt_{t}")]
        saved = ([{k: p.detach().clone() for k, p in m.named_parameters()} for m in towers],
                 [{k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                   for k, v in s.items()} for s in slots], state.global_step)
        state, metrics = step(state, f, l, n)
        with torch.no_grad():
            for m, ps in zip(towers, saved[0]):
                for k, p in m.named_parameters():
                    p.copy_(ps[k])
            for s, old in zip(slots, saved[1]):
                for k, v in old.items():
                    if isinstance(v, dict):
                        for n2, t in v.items():
                            s[k][n2].copy_(t)
                    else:
                        s[k] = v
        state.global_step = saved[2]
        return state, metrics
    return fn


def half_batch(step):
    def fn(state, f, l, n):
        h = f.shape[0] // 2
        return step(state, f[:h], l[:h], n[:h])
    return fn


def altered_update(step):
    """The step's answer altered where it is produced: the student's first
    leaf moved twice as far as the step moved it."""
    def fn(state, f, l, n):
        p = next(state.student.parameters())
        before = p.detach().clone()
        state, metrics = step(state, f, l, n)
        with torch.no_grad():
            p.add_(p - before)
        return state, metrics
    return fn


@pytest.mark.parametrize("cell", TRAIN + ["student_eval.b256", "serve_open.b8"])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r["checks"])


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered_update],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_caught(monkeypatch, cell, fault):
    _wrap_train(monkeypatch, fault)
    assert not _run(cell)["correct"]


def _alter_eval_step(monkeypatch, alter):
    from efficientvideoclassification_youtube8m_torch.parallel import sharded_step

    real = sharded_step.build_sharded_eval_step

    def build(*a, **k):
        step = real(*a, **k)

        def fn(*args):
            out = dict(step(*args))
            alter(out)
            return out
        return fn
    monkeypatch.setattr(sharded_step, "build_sharded_eval_step", build)


def prediction(out):
    preds = out["predictions"].clone()
    preds[0, 0] = 1 - preds[0, 0]
    out["predictions"] = preds


def pack_class(out):
    """The first row's two best classes swapped in the packed host rows."""
    pack = out["host_pack"].clone()
    words = pack[:, 20].view(torch.int32)
    lo, hi = words & 0xFFFF, (words >> 16) & 0x3FFF
    pack[:, 20] = (hi | (lo << 16) | -(1 << 30)).view(torch.float32)
    out["host_pack"] = pack


def pack_loss(out):
    pack = out["host_pack"].clone()
    pack[-1, -2] *= 1.01
    out["host_pack"] = pack


@pytest.mark.parametrize("alter", [prediction, pack_class, pack_loss],
                         ids=lambda f: f.__name__)
def test_eval_answer_altered_is_caught(monkeypatch, alter):
    _alter_eval_step(monkeypatch, alter)
    assert not _run("student_eval.b256")["correct"]


@pytest.mark.parametrize("fault", ["half_rows", "hit_at_one"])
def test_eval_fetch_or_accumulator_fault_is_caught(monkeypatch, fault):
    """The rows the host fetched, half of them left out (the means taken
    over the rest), or the accumulator's Hit@1 counted off by one row."""
    from efficientvideoclassification_youtube8m_torch.cli import validate
    from efficientvideoclassification_youtube8m_torch.parallel import distributed

    if fault == "half_rows":
        real = distributed.gather_step_outputs

        def gather(*a, **k):
            rows = real(*a, **k)
            h = len(rows["labels"]) // 2
            return {n: v[:h] for n, v in rows.items()}
        monkeypatch.setattr(distributed, "gather_step_outputs", gather)
    else:
        real = validate.EvaluationMetrics.accumulate_topk

        def accumulate(self, *a, **k):
            info = real(self, *a, **k)
            info["hit_at_one"] += 1 / len(a[2])
            return info
        monkeypatch.setattr(validate.EvaluationMetrics, "accumulate_topk", accumulate)
    assert not _run("student_eval.b256")["correct"]


def test_serve_answer_altered_is_caught(monkeypatch):
    from efficientvideoclassification_youtube8m_torch import serving

    real = serving.Predictor.predict

    def predict(self, features, num_frames):
        out = real(self, features, num_frames)
        out[0, 0] = 1 - out[0, 0]
        return out
    monkeypatch.setattr(serving.Predictor, "predict", predict)
    assert not _run("serve_open.b8")["correct"]
