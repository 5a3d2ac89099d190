"""The port's copy of the host metrics against the JAX package's, bit for
bit: the AP and mAP calculators (native heap and pure Python),
train_step_metrics, and EvaluationMetrics.get() through both accumulate
paths, on random scores and on scores with many ties; and the port's
device top-k and PERR against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu.metrics import (
    average_precision as jap,
    eval_util as jeu,
    mean_average_precision as jmap,
)
from efficientvideoclassification_youtube8m_torch import metrics as tmetrics
from efficientvideoclassification_youtube8m_torch.metrics import (
    average_precision as tap,
    eval_util as teu,
    mean_average_precision as tmap,
)

B, V, K = 12, 30, 5


def _scores(seed, tied):
    rng = np.random.default_rng(seed)
    preds = rng.random((B, V)).astype(np.float32)
    if tied:  # a handful of distinct values: ties inside and across rows
        preds = np.round(preds * 4) / 4
    labels = rng.random((B, V)) < 0.15
    labels[0] = False  # a video without labels
    return preds, labels


def _topk(preds, k=K):
    idx = np.argsort(-preds, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(preds, idx, axis=1), idx


CASES = [(seed, tied) for seed in (0, 1) for tied in (False, True)]
IDS = [f"seed{seed}-{'tied' if tied else 'random'}" for seed, tied in CASES]


@pytest.fixture(params=[True, False], ids=["native", "python"])
def heap(request, monkeypatch):
    """Both packages' AP calculators on the native heap, or both on the
    pure-Python one."""
    if not request.param:
        monkeypatch.setattr(jap, "_NATIVE_CACHE", [True, None])
        monkeypatch.setattr(tap, "_NATIVE_CACHE", [True, None])
    return request.param


@pytest.mark.parametrize("seed,tied", CASES, ids=IDS)
def test_ap_and_map_calculators(heap, seed, tied):
    preds, labels = _scores(seed, tied)
    for top_n in (None, 7):
        j, t = jap.AveragePrecisionCalculator(top_n), tap.AveragePrecisionCalculator(top_n)
        for row in range(B):
            j.accumulate(preds[row], labels[row].astype(np.float64), float(labels[row].sum()))
            t.accumulate(preds[row], labels[row].astype(np.float64), float(labels[row].sum()))
        assert t.peek_ap_at_n() == j.peek_ap_at_n()
    jm, tm = jmap.MeanAveragePrecisionCalculator(V), tmap.MeanAveragePrecisionCalculator(V)
    per_class_p = [list(preds[:, c]) for c in range(V)]
    per_class_l = [list(labels[:, c].astype(float)) for c in range(V)]
    pos = list(labels.sum(axis=0))
    jm.accumulate(per_class_p, per_class_l, pos)
    tm.accumulate(per_class_p, per_class_l, pos)
    assert tm.peek_map_at_n() == jm.peek_map_at_n()


@pytest.mark.parametrize("seed,tied", CASES, ids=IDS)
@pytest.mark.parametrize("with_perr", [True, False])
def test_train_step_metrics(heap, seed, tied, with_perr):
    preds, labels = _scores(seed, tied)
    vals, idx = _topk(preds)
    perr = np.random.default_rng(seed).random(B).astype(np.float32) if with_perr else None
    assert (teu.train_step_metrics(vals, idx, labels, perr_precision=perr)
            == jeu.train_step_metrics(vals, idx, labels, perr_precision=perr))


@pytest.mark.parametrize("seed,tied", CASES, ids=IDS)
@pytest.mark.parametrize("path", ["topk", "full"])
def test_evaluation_metrics_get(heap, seed, tied, path):
    """Three batches into each package's EvaluationMetrics; get() equal,
    every value and every per-class AP."""
    results = []
    for module in (jeu, teu):
        evl = module.EvaluationMetrics(V, K)
        for b in range(3):
            preds, labels = _scores(seed + 10 * b, tied)
            loss = np.random.default_rng(b).random(B).astype(np.float32)
            if path == "topk":
                vals, idx = _topk(preds)
                perr = np.asarray(jeu.perr_precision_on_device(
                    jnp.asarray(preds), jnp.asarray(labels)))
                evl.accumulate_topk(vals, idx, labels, loss, perr_precision=perr)
            else:
                evl.accumulate(preds, labels, loss)
        results.append(evl.get())
    want, got = results
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    # the port's class is the one its metrics package exports
    assert tmetrics.EvaluationMetrics is teu.EvaluationMetrics


@pytest.mark.parametrize("seed,tied", CASES, ids=IDS)
def test_batch_oracles(seed, tied):
    preds, labels = _scores(seed, tied)
    labels[0, 3] = True  # argpartition over -0 labels is another code path
    assert teu.calculate_hit_at_one(preds, labels) == jeu.calculate_hit_at_one(preds, labels)
    assert (teu.calculate_precision_at_equal_recall_rate(preds, labels)
            == jeu.calculate_precision_at_equal_recall_rate(preds, labels))
    assert teu.calculate_gap(preds, labels, K) == jeu.calculate_gap(preds, labels, K)


@pytest.mark.parametrize("seed,tied", CASES, ids=IDS)
def test_device_topk_and_perr(seed, tied):
    """The port's torch top-k and PERR against the JAX package's fused
    form and its two separate calls, on the same scores: bit for bit."""
    preds, labels = _scores(seed, tied)
    jv, ji, jp = (np.asarray(x) for x in jeu.topk_and_perr_on_device(
        jnp.asarray(preds), jnp.asarray(labels), K))
    tv, ti, tp = (x.numpy() for x in tmetrics.topk_and_perr_on_device(
        torch.from_numpy(preds), torch.from_numpy(labels), K))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tp, jp)
    sv, si = jax.lax.top_k(jnp.asarray(preds), K)
    np.testing.assert_array_equal(np.asarray(sv), tv)
    np.testing.assert_array_equal(np.asarray(si), ti)
    np.testing.assert_array_equal(np.asarray(jeu.perr_precision_on_device(
        jnp.asarray(preds), jnp.asarray(labels))), tp)


class _NoProduct(np.ndarray):
    """A label matrix that refuses a matrix product: a BLAS call on the eval
    loop's thread leaves OpenBLAS's thread team spinning on every core,
    where the loader's native readers need the cores."""

    def __matmul__(self, other):
        raise AssertionError("a BLAS product over the labels")

    __rmatmul__ = __matmul__


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_label_counts_take_no_blas_product(layout):
    """`accumulate_topk`'s label counts come from integer sums, with no BLAS
    product, and equal the plain counts, whatever the matrix's layout."""
    labels = np.random.default_rng(7).random((40, 2 * V)) < 0.2
    if layout == "strided":
        labels = labels[:, ::2]
    pos, rows = teu._label_count_reductions(labels.view(_NoProduct), need_rows=True)
    np.testing.assert_array_equal(pos, labels.sum(axis=0))
    np.testing.assert_array_equal(rows, labels.sum(axis=1))
    assert pos.dtype == rows.dtype == np.int64
