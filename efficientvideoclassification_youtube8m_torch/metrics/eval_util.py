"""Evaluation metrics: Hit@1, PERR, GAP, and the epoch aggregator (port
of the JAX package's metrics/eval_util.py).

The host-side numpy metrics are a copy of the JAX package's, with the
same numerics bit for bit (the reference's eval_util.py); the device
parts — the per-video top-k and the exact PERR the steps compute on the
device, so that only [B, k] crosses to the host — are torch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch.metrics.average_precision import (
    AveragePrecisionCalculator,
)
from efficientvideoclassification_youtube8m_torch.metrics.mean_average_precision import (
    MeanAveragePrecisionCalculator,
)


def flatten(l):
    return [item for sublist in l for item in sublist]


def calculate_hit_at_one(predictions: np.ndarray, actuals: np.ndarray) -> float:
    """Fraction of videos whose argmax prediction is a true label.

    PARITY ORACLE, kept operation-for-operation with the reference's
    numpy (eval_util.py:17-33): this and the two functions below are the
    batch-level METRIC DEFINITIONS — the bit-exact yardstick the
    production paths (topk_and_perr_on_device, the C epoch kernels) are
    tested against. Reordering the numpy ops would break that
    bit-identity, so they are deliberately not "redesigned"."""
    top_prediction = np.argmax(predictions, 1)
    hits = actuals[np.arange(actuals.shape[0]), top_prediction]
    return float(np.average(hits))


def calculate_precision_at_equal_recall_rate(
    predictions: np.ndarray, actuals: np.ndarray
) -> float:
    """Per-video precision within the top-|labels| predictions, averaged.
    PARITY ORACLE — see calculate_hit_at_one (reference eval_util.py:36-59)."""
    aggregated_precision = 0.0
    num_videos = actuals.shape[0]
    for row in range(num_videos):
        num_labels = int(np.sum(actuals[row]))
        top_indices = np.argpartition(predictions[row], -num_labels)[-num_labels:]
        item_precision = 0.0
        for label_index in top_indices:
            if predictions[row][label_index] > 0:
                item_precision += actuals[row][label_index]
        item_precision /= top_indices.size
        aggregated_precision += item_precision
    return aggregated_precision / num_videos


def calculate_gap(predictions, actuals, top_k: int = 20) -> float:
    """Global average precision over the batch's pooled top-k triplets.
    PARITY ORACLE — see calculate_hit_at_one (reference eval_util.py:62-79)."""
    gap_calculator = AveragePrecisionCalculator()
    sparse_predictions, sparse_labels, num_positives = top_k_by_class(
        predictions, actuals, top_k
    )
    gap_calculator.accumulate(
        flatten(sparse_predictions), flatten(sparse_labels), sum(num_positives)
    )
    return gap_calculator.peek_ap_at_n()


def top_k_by_class(
    predictions: np.ndarray, labels: np.ndarray, k: int = 20
) -> Tuple[List[List[float]], List[List[float]], List[float]]:
    """Top-k predictions per video, regrouped per class.

    Returns per-class score lists, per-class label lists, and per-class
    positive counts over the WHOLE batch (not just the top-k entries).
    """
    if k <= 0:
        raise ValueError("k must be a positive integer.")
    k = min(k, predictions.shape[1])
    num_classes = predictions.shape[1]

    # vectorized top-k per row (order within the k does not matter —
    # everything is re-sorted downstream)
    idx = np.argpartition(predictions, -k, axis=1)[:, -k:]
    rows = np.arange(predictions.shape[0])[:, None]
    top_preds = predictions[rows, idx]
    top_labels = labels[rows, idx]

    out_predictions, out_labels = _group_by_class(
        idx.ravel(), top_preds.ravel(), top_labels.ravel(), num_classes
    )
    out_true_positives = list(labels.sum(axis=0))
    return out_predictions, out_labels, out_true_positives


def _class_sorted(flat_classes, flat_preds, flat_labels):
    """Stable sort of flattened top-k triplets by class: per class the
    entries keep (video, rank) order — exactly the per-class append
    sequence of the reference's double loop (eval_util.py:110-118).

    Stability comes from a composite (class, position) key with unique
    values, which lets the default (faster, unstable) introsort produce
    the stable order — ~4x quicker than kind='stable' on the [B*k]
    int arrays this sees."""
    n = flat_classes.size
    key = flat_classes.astype(np.int64) * n + np.arange(n, dtype=np.int64)
    order = np.argsort(key)
    return flat_classes[order], flat_preds[order], flat_labels[order]


def _label_count_reductions(labels: np.ndarray, need_rows: bool):
    """(positives per class [C], labels per video [B] or None) for a
    [B, C] label matrix. Bool-axis reductions in numpy cost ~3ms at
    batch 512 x 4716; int32 sums over the matrix's 0/1 bytes take about
    half the time of BLAS matvecs over a float32 copy (256 x 4716, one
    core), and call no BLAS: after each call OpenBLAS's thread team spins
    on every core, which starves the loader's native reader threads."""
    if labels.dtype == bool:
        u = labels.view(np.uint8)
        pos = u.sum(axis=0, dtype=np.int32).astype(np.int64)
        rows = u.sum(axis=1, dtype=np.int32).astype(np.int64) if need_rows else None
        return pos, rows
    pos = labels.sum(axis=0).astype(np.int64)
    rows = labels.sum(axis=1).astype(np.int64) if need_rows else None
    return pos, rows


def _class_segments(sorted_classes):
    """(unique class ids, segment starts, segment ends) of a
    class-sorted array — the contiguous per-class slices after
    _class_sorted."""
    uniq, starts = np.unique(sorted_classes, return_index=True)
    ends = np.append(starts[1:], sorted_classes.size)
    return uniq, starts, ends


def _group_by_class(flat_classes, flat_preds, flat_labels, num_classes):
    """Per-class score/label lists via one stable argsort instead of a
    Python loop over every (video, rank) entry."""
    sc, sp, sl = _class_sorted(flat_classes, flat_preds, flat_labels)
    out_predictions: List[List[float]] = [[] for _ in range(num_classes)]
    out_labels: List[List[float]] = [[] for _ in range(num_classes)]
    uniq, starts, ends = _class_segments(sc)
    for c, s, e in zip(uniq.tolist(), starts.tolist(), ends.tolist()):
        out_predictions[c] = list(sp[s:e])
        out_labels[c] = list(sl[s:e])
    return out_predictions, out_labels


def top_k_triplets(predictions: np.ndarray, labels: np.ndarray, k: int = 20):
    """(class, score, label) triplets for one video's top-k."""
    m = len(predictions)
    k = min(k, m)
    indices = np.argpartition(predictions, -k)[-k:]
    return [(index, predictions[index], labels[index]) for index in indices]


def _perr_from_tau(predictions, labels_f, n, tau):
    """PERR by threshold counting (`_perr_from_tau` of the JAX package):
    scores above the row's n-th largest score tau are in the top n; of
    the scores tied at tau, only (n - #above) fit, and the capacity is
    shared out in proportion (the expectation of a uniform tie pick)."""
    positive = predictions > 0  # the reference's numpy.nonzero filter
    above = predictions > tau[:, None]
    tied = predictions == tau[:, None]
    hits_above = torch.sum(labels_f * above * positive, dim=1)
    count_above = torch.sum(above, dim=1).to(torch.float32)
    tied_label_hits = torch.sum(labels_f * tied * positive, dim=1)
    tied_count = torch.sum(tied, dim=1).to(torch.float32)
    capacity = torch.clamp(n.to(torch.float32) - count_above, min=0.0)
    hits = hits_above + capacity * tied_label_hits / torch.clamp(
        tied_count, min=1.0)
    return torch.where(
        n > 0, hits / torch.clamp(n, min=1).to(torch.float32),
        torch.zeros_like(hits))


def topk_and_perr_on_device(predictions: torch.Tensor, labels: torch.Tensor,
                            k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Each row's k largest scores and its EXACT PERR precision, from ONE
    stable descending sort of the [B, V] score row (the JAX package's
    `topk_and_perr_on_device`). Top-k: values descending, ties lowest
    index first, as `lax.top_k` orders them: a STABLE ascending sort of
    the negated scores gives that order (`torch.topk` does not specify
    its tie order), and negating twice keeps the values' bits. PERR:
    precision within the top-|labels| predictions over the full row
    (reference eval_util.py:34-59); rows without labels give 0. Returns
    (topk_val [B, k], topk_idx [B, k], perr [B] float32)."""
    neg, idx = torch.sort(-predictions, dim=1, stable=True)
    labels_f = labels.to(torch.float32)
    n = torch.sum(labels_f, dim=1).to(torch.int64)
    # n-th largest = descending index n-1; n = 0 rows are masked below
    tau = -torch.gather(neg, 1, torch.clamp(n - 1, min=0)[:, None])[:, 0]
    return -neg[:, :k], idx[:, :k], _perr_from_tau(predictions, labels_f, n, tau)


def _topk_perr_sum(topk_values, top_labels, label_counts):
    """Sum over rows of precision-within-top-min(n,k): the top-k PERR
    approximation, vectorized. The running (cumsum) reduction keeps the
    row-by-row float accumulation of the original loop (rows with zero
    labels contribute an exact + 0.0)."""
    B, k = topk_values.shape
    n = np.minimum(label_counts, k)
    within = np.arange(k)[None, :] < n[:, None]
    hits = np.sum(top_labels * (topk_values > 0) * within, axis=1)
    per_row = np.where(n > 0, hits / np.maximum(n, 1), 0.0)
    return float(np.cumsum(per_row)[-1]) if B else 0.0


def train_step_metrics(
    topk_values: np.ndarray,  # [B, k] sorted desc (from device top_k)
    topk_indices: np.ndarray,  # [B, k]
    labels: np.ndarray,  # [B, num_class]
    perr_precision=None,  # [B] exact per-row PERR from the device step
) -> Dict[str, float]:
    """Per-step Hit@1 / PERR / GAP from device-side top-k — the cheap path
    for the training loop's every-step logging (train.py:522-526).

    With `perr_precision` (from `topk_and_perr_on_device`, computed over
    the FULL score row inside the train step) PERR is exact for any label
    count; without it, the top-k approximation (exact for <= k labels).
    GAP uses one global AP calculator over the pooled top-k entries; the
    epoch-level eval path (EvaluationMetrics) keeps the exact reference
    numerics.
    """
    topk_values = np.asarray(topk_values)
    topk_indices = np.asarray(topk_indices)
    labels = np.asarray(labels)
    B, k = topk_values.shape
    rows = np.arange(B)
    top_labels = labels[rows[:, None], topk_indices]  # [B, k]

    hit_at_one = float(np.average(labels[rows, topk_indices[:, 0]]))

    if perr_precision is not None:
        perr = float(np.sum(np.asarray(perr_precision))) / B
    else:
        label_counts = labels.sum(axis=1).astype(np.int64)
        perr = _topk_perr_sum(topk_values, top_labels, label_counts) / B

    gap_calc = AveragePrecisionCalculator()
    gap_calc.accumulate(
        topk_values.ravel(),
        top_labels.astype(np.float64).ravel(),
        float(labels.sum()),
    )
    return {
        "hit_at_one": hit_at_one,
        "perr": perr,
        "gap": gap_calc.peek_ap_at_n(),
    }


class EvaluationMetrics:
    """Epoch-level aggregator (eval_util.py:126-213).

    Throughput design: `accumulate_topk` does only vectorized numpy work
    per batch (one [B*k] argsort + gathers) and DEFERS the AP-calculator
    pushes — batches are queued as flat arrays and flushed with one
    epoch-wide group-by when `get()` reads the results. The deferral is
    exact: every calculator heap here is unbounded, so pushing a class's
    entries all at once in their original (batch, video, rank) arrival
    order builds the same heap the per-entry path built, and the heap
    order is what feeds the GAP tie-break (average_precision.py)."""

    def __init__(self, num_class: int, top_k: int):
        self.sum_hit_at_one = 0.0
        self.sum_perr = 0.0
        self.sum_loss = 0.0
        self.map_calculator = MeanAveragePrecisionCalculator(num_class)
        self.global_ap_calculator = AveragePrecisionCalculator()
        self.top_k = top_k
        self.num_examples = 0
        self.num_class = num_class
        self._pending: List[tuple] = []  # (classes, preds, labels, pos[C])

    def accumulate(self, predictions, labels, loss) -> Dict[str, float]:
        self._flush_pending()  # keep heap-push order across mixed calls
        predictions = np.asarray(predictions)
        labels = np.asarray(labels)
        batch_size = labels.shape[0]
        mean_hit_at_one = calculate_hit_at_one(predictions, labels)
        mean_perr = calculate_precision_at_equal_recall_rate(predictions, labels)
        mean_loss = float(np.mean(loss))

        sparse_predictions, sparse_labels, num_positives = top_k_by_class(
            predictions, labels, self.top_k
        )
        self.map_calculator.accumulate(sparse_predictions, sparse_labels, num_positives)
        self.global_ap_calculator.accumulate(
            flatten(sparse_predictions), flatten(sparse_labels), sum(num_positives)
        )

        self.num_examples += batch_size
        self.sum_hit_at_one += mean_hit_at_one * batch_size
        self.sum_perr += mean_perr * batch_size
        self.sum_loss += mean_loss * batch_size
        return {"hit_at_one": mean_hit_at_one, "perr": mean_perr, "loss": mean_loss}

    def accumulate_topk(
        self,
        topk_values: np.ndarray,  # [B, k] from topk_and_perr_on_device
        topk_indices: np.ndarray,  # [B, k]
        labels: np.ndarray,  # [B, num_class] (bool/int)
        loss,
        perr_precision: Sequence[float] = None,
    ) -> Dict[str, float]:
        """Fast path: same GAP/mAP numerics from device-side top-k.

        Hit@1 comes from the top-1 entry. PERR: pass `perr_precision`
        (the [B] per-video precisions from `topk_and_perr_on_device`,
        computed on the full score row inside the eval step) for EXACT
        reference numerics; without it, PERR falls back to a top-k
        approximation that is exact only for videos with <= k labels.
        GAP/mAP from the top-k list ARE the reference's definition
        (eval_util.py:82-124 pools per-video top-k triplets).
        """
        topk_values = np.asarray(topk_values)
        topk_indices = np.asarray(topk_indices)
        labels = np.asarray(labels)
        batch_size = labels.shape[0]

        rows = np.arange(batch_size)
        hits = labels[rows, topk_indices[:, 0]]
        mean_hit_at_one = float(np.average(hits))

        top_labels = labels[rows[:, None], topk_indices]
        pos_per_class, label_counts = _label_count_reductions(
            labels, need_rows=perr_precision is None
        )
        if perr_precision is not None:
            # exact per-row precisions computed on device over the full row
            mean_perr = float(np.sum(np.asarray(perr_precision))) / batch_size
        else:
            # PERR within the top-k ranked list (approximate for >k labels)
            mean_perr = (
                _topk_perr_sum(topk_values, top_labels, label_counts)
                / batch_size
            )
        mean_loss = float(np.mean(loss))

        # class-major per batch (== flatten(per-class lists) push order);
        # the AP-calculator pushes themselves are deferred to get()
        from efficientvideoclassification_youtube8m_torch.metrics.average_precision import (
            _native,
        )

        native = _native()
        flat_c = topk_indices.ravel().astype(np.int64)
        flat_p = topk_values.ravel().astype(np.float64)
        flat_l = top_labels.ravel().astype(np.float64)
        if native is not None:
            sp, sl, counts = native.group_by_class(
                flat_c, flat_p, flat_l, self.num_class)
            sc = np.repeat(np.arange(self.num_class, dtype=np.int64),
                           counts)
        else:
            sc, sp, sl = _class_sorted(flat_c, flat_p, flat_l)
        self._pending.append((sc, sp, sl, pos_per_class))

        self.num_examples += batch_size
        self.sum_hit_at_one += mean_hit_at_one * batch_size
        self.sum_perr += mean_perr * batch_size
        self.sum_loss += mean_loss * batch_size
        return {"hit_at_one": mean_hit_at_one, "perr": mean_perr, "loss": mean_loss}

    def _flush_pending(self):
        """Push every queued batch into the AP calculators: one global
        accumulate in arrival order, one epoch-wide stable group-by for
        the per-class calculators (entries per class keep (batch, video,
        rank) order — the exact per-entry push sequence)."""
        if not self._pending:
            return
        classes = np.concatenate([p[0] for p in self._pending])
        preds = np.concatenate([p[1] for p in self._pending])
        acts = np.concatenate([p[2] for p in self._pending])
        pos = np.sum([p[3] for p in self._pending], axis=0)
        self._pending = []

        from efficientvideoclassification_youtube8m_torch.metrics.average_precision import (
            _native,
        )

        native = _native()
        gcalc = self.global_ap_calculator
        if (native is not None and gcalc.heap_size == 0
                and gcalc._top_n is None):
            # empty unbounded global calculator: heapify the epoch's
            # entries in place (same layout as sequential pushes) and
            # adopt — skips the grow-and-push of the big array
            gp, ga = preds.copy(), acts.copy()
            native.heap_build_segments(
                gp, ga, np.zeros(1, np.int64),
                np.asarray([gp.size], np.int64))
            gcalc._adopt_heap(gp, ga, pos.sum())
        else:
            gcalc.accumulate(preds, acts, pos.sum())
        if native is not None:
            # O(n) C counting-sort group-by: identical stable order to
            # _class_sorted (within a class, entries keep arrival order)
            # but ~20x faster at the 28M-entry YT8M epoch flush, and the
            # per-class counts replace the np.unique segment scan
            sp, sa, counts = native.group_by_class(
                classes, preds, acts, self.num_class)
            uniq = np.flatnonzero(counts)
            seg_starts = np.zeros(self.num_class, np.int64)
            np.cumsum(counts[:-1], out=seg_starts[1:])
            starts = seg_starts[uniq]
            ends = starts + counts[uniq]
        else:
            sc, sp, sa = _class_sorted(classes, preds, acts)
            uniq, starts, ends = _class_segments(sc)
        calcs = self.map_calculator._ap_calculators
        present = np.zeros(self.num_class, bool)
        present[uniq] = True

        empty = (native is not None and
                 [c for c in uniq.tolist() if calcs[c].heap_size == 0])
        if native is not None and len(empty) == len(uniq):
            # one C call heapifies every class segment in place with the
            # exact heapq layout; calculators adopt zero-copy views
            native.heap_build_segments(sp, sa, starts, ends)
            for c, s, e in zip(uniq.tolist(), starts.tolist(), ends.tolist()):
                calcs[c]._adopt_heap(sp[s:e], sa[s:e], pos[c])
        else:
            for c, s, e in zip(uniq.tolist(), starts.tolist(), ends.tolist()):
                calcs[c].accumulate(sp[s:e], sa[s:e], pos[c])
        # classes with positives but no top-k entries still count their
        # positives (the per-entry path accumulated empty lists for them)
        for c in np.flatnonzero(~present & (pos > 0)).tolist():
            calcs[c].accumulate([], [], pos[c])

    def get(self) -> Dict[str, object]:
        if self.num_examples <= 0:
            raise ValueError("total_sample must be positive.")
        self._flush_pending()
        return {
            "avg_hit_at_one": self.sum_hit_at_one / self.num_examples,
            "avg_perr": self.sum_perr / self.num_examples,
            "avg_loss": self.sum_loss / self.num_examples,
            "aps": self.map_calculator.peek_map_at_n(),
            "gap": self.global_ap_calculator.peek_ap_at_n(),
        }

    def clear(self):
        self.sum_hit_at_one = 0.0
        self.sum_perr = 0.0
        self.sum_loss = 0.0
        self.map_calculator.clear()
        self.global_ap_calculator.clear()
        self.num_examples = 0
        self._pending = []
