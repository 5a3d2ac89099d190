"""Prediction-CSV utilities + ensembling (a copy of the JAX package's
ensemble.py: the same rows, byte for byte).

The Kaggle submission format the reference reads/writes
(`inference_ensemble.py:63-74,155-176,182`):

    VideoId,LabelConfidencePairs
    <id>,<class> <prob> <class> <prob> ...
"""

from __future__ import annotations

import glob as globlib
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def format_lines(video_ids: Sequence[str], predictions: np.ndarray,
                 top_k: int) -> Iterator[str]:
    """Top-k 'class prob' pairs per video, sorted by descending prob
    (inference_ensemble.py:63-74).

    Batched: one argpartition over the whole [B, V] matrix + one stable
    argsort over the [B, k] winners instead of per-row numpy calls, and
    `.tolist()` ahead of the string formatting (Python np-scalar access
    dominates otherwise). Byte-identical to the per-row form: the same
    introselect runs per row either way, and the stable descending sort
    keeps ties in argpartition segment order exactly like the stable
    Python `sorted(key=-prob)` it replaces (pinned in test_ensemble)."""
    predictions = np.asarray(predictions)
    if len(video_ids) == 0:
        return
    top = np.argpartition(predictions, -top_k, axis=1)[:, -top_k:]
    vals = np.take_along_axis(predictions, top, axis=1)
    order = np.argsort(-vals, axis=1, kind="stable")
    idx_rows = np.take_along_axis(top, order, axis=1)
    val_rows = np.take_along_axis(vals, order, axis=1)
    yield from format_ranked_lines(video_ids, idx_rows, val_rows)


def format_ranked_lines(video_ids: Sequence[str], topk_idx: np.ndarray,
                        topk_val: np.ndarray) -> Iterator[str]:
    """CSV rows from ALREADY-RANKED top-k pairs — the single owner of
    the '%i %f' row format. format_lines ranks then delegates here; a
    device top-k, already sorted, can feed it directly."""
    topk_idx = np.asarray(topk_idx)
    idx_rows = topk_idx.astype(np.int64, copy=False).tolist()
    val_rows = np.asarray(topk_val).astype(np.float64).tolist()
    fmt = " ".join(["%i %f"] * topk_idx.shape[1])
    for video_index in range(len(video_ids)):
        vid = video_ids[video_index]
        if isinstance(vid, bytes):
            vid = vid.decode("utf-8")
        flat = [
            x
            for pair in zip(idx_rows[video_index], val_rows[video_index])
            for x in pair
        ]
        yield vid + "," + (fmt % tuple(flat)) + "\n"


def write_predictions_csv(path: str, rows: Iterator[str]):
    with open(path, "w") as f:
        f.write("VideoId,LabelConfidencePairs\n")
        for row in rows:
            f.write(row)


def read_pred_file(filename: str) -> Dict[str, Tuple[List[int], List[float]]]:
    """CSV -> {video_id: (label_ids, probs)} (inference_ensemble.py:155-167)."""
    with open(filename) as f:
        lines = f.readlines()[1:]
    out = {}
    for line in lines:
        vid, pairs = line.rstrip("\n").split(",", 1)
        tokens = pairs.split(" ")
        labels = [int(t) for t in tokens[0::2]]
        probs = [float(t) for t in tokens[1::2]]
        out[vid] = (labels, probs)
    return out


class PredictionStore:
    """K prediction CSVs parsed ONCE, assembled per batch.

    (inference_ensemble.py:169-191 parses once before its loop too; a
    naive per-batch reload would re-parse hundreds of MB per step at
    Kaggle scale.)"""

    def __init__(self, preds_pattern: str, num_classes: int = 4716):
        self.files = sorted(globlib.glob(preds_pattern))
        if not self.files:
            raise IOError(f"no prediction files match {preds_pattern!r}")
        self.num_classes = num_classes
        self._dicts = [read_pred_file(f) for f in self.files]

    @property
    def num_models(self) -> int:
        return len(self.files)

    def assemble(self, video_ids: Sequence[str]) -> np.ndarray:
        """[B, K, num_classes] old_predictions for a batch of ids."""
        out = np.zeros((len(video_ids), len(self._dicts), self.num_classes),
                       np.float32)
        for i, vid in enumerate(video_ids):
            if isinstance(vid, bytes):
                vid = vid.decode("utf-8")
            for j, d in enumerate(self._dicts):
                entry = d.get(vid)
                if entry is None:
                    raise KeyError(
                        f"video id {vid!r} is missing from prediction "
                        f"file {self.files[j]!r} — the K prediction CSVs "
                        "must cover every video in the input shards "
                        "(was that inference run truncated?)")
                labels, probs = entry
                out[i, j, labels] = probs
        return out


def load_old_predictions(
    preds_pattern: str, video_ids: Sequence[str], num_classes: int = 4716
) -> np.ndarray:
    """One-shot convenience wrapper over PredictionStore."""
    return PredictionStore(preds_pattern, num_classes).assemble(video_ids)


def max_ensemble(
    pred_files: Sequence[str], num_classes: int = 4716, top_k: int = 20
) -> Iterator[str]:
    """Per-label max over K prediction CSVs (max_ensemble.py): for each
    video take, per class, the maximum probability any model assigned,
    then emit the top-k. Streams over videos, so the Kaggle-scale 700640
    rows never materialize at once."""
    dicts = [read_pred_file(f) for f in pred_files]
    # the files must agree on the video universe: a silent first-file
    # iteration would DROP ids present only in later files (an
    # incomplete Kaggle submission) and a bare d[vid] would crash
    # mid-stream after partial output
    universe = set(dicts[0])
    for f, d in zip(pred_files[1:], dicts[1:]):
        missing = universe - set(d)
        extra = set(d) - universe
        if missing or extra:
            ex = next(iter(missing or extra))
            raise ValueError(
                f"prediction files disagree on the video universe: "
                f"{f!r} is {'missing' if missing else 'adding'} "
                f"{len(missing) or len(extra)} ids (e.g. {ex!r}) vs "
                f"{pred_files[0]!r} — was one inference run truncated?")
    for vid in dicts[0]:
        dense = np.zeros((num_classes,), np.float32)
        for d in dicts:
            labels, probs = d[vid]
            np.maximum.at(dense, labels, probs)
        yield from format_lines([vid], dense[None, :], top_k)
