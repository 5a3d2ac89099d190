"""TensorBoard summaries, no TensorFlow (port of the JAX package's
utils/summary.py).

The events-file writer and the reference's summary helpers
(`MakeSummary`/`AddGlobalStepSummary`/`AddEpochSummary`, utils.py:28-125)
are a copy of the JAX package's, byte for byte in what they write: an
events file is a TFRecord stream of Event protos

    Event { double wall_time = 1; int64 step = 2;
            oneof { string file_version = 3; Summary summary = 5; } }
    Summary { repeated Value value = 1 { string tag = 1;
                                         float simple_value = 2; } }

with the reference's tag names. `write_variable_histograms` computes
each parameter's histogram statistics on its device with torch.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.data.proto import (
    _len_field,
    _tag,
    write_varint,
)
from efficientvideoclassification_youtube8m_torch.data.tfrecord import TFRecordWriter


def _double_field(field_num: int, value: float) -> bytes:
    return _tag(field_num, 1) + struct.pack("<d", value)


def _float_field(field_num: int, value: float) -> bytes:
    return _tag(field_num, 5) + struct.pack("<f", value)


def _varint_field(field_num: int, value: int) -> bytes:
    return _tag(field_num, 0) + write_varint(value & ((1 << 64) - 1))


def make_summary(name: str, value: float) -> bytes:
    """Serialized Summary proto with one simple_value (utils.py:28-34)."""
    val = _len_field(1, str(name).encode()) + _float_field(2, float(value))
    return _len_field(1, val)


def _default_bucket_limits() -> "np.ndarray":
    """TF's default exponential histogram buckets (histogram.cc
    InitDefaultBucketsInner): positives 1e-12 * 1.1^k, mirrored negatives,
    closed with DBL_MAX on both ends."""
    pos = []
    v = 1e-12
    while v < 1.7976931348623157e308:
        pos.append(v)
        v *= 1.1
    pos.append(1.7976931348623157e308)
    return np.asarray([-x for x in reversed(pos)] + pos)


_BUCKET_LIMITS = _default_bucket_limits()


def make_histogram_from_stats(
    tag: str,
    num: float,
    vmin: float,
    vmax: float,
    vsum: float,
    sum_squares: float,
    counts: "np.ndarray",
) -> bytes:
    """Serialized Summary proto with one HistogramProto value from
    precomputed statistics (`counts` aligned with _BUCKET_LIMITS).

    HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (doubles),
    bucket_limit=6 bucket=7 (packed doubles); Summary.Value carries it in
    field 5 (`histo`). Zero-count bucket runs are collapsed to their last
    limit, matching TF's EncodeToProto(preserve_zero_buckets=false).
    """
    histo = b""
    if num > 0:
        histo += _double_field(1, float(vmin))
        histo += _double_field(2, float(vmax))
    else:
        # empty histogram: TF's initial min/max sentinels
        histo += _double_field(1, _BUCKET_LIMITS[-1])
        histo += _double_field(2, _BUCKET_LIMITS[0])
    histo += _double_field(3, float(num))
    histo += _double_field(4, float(vsum))
    histo += _double_field(5, float(sum_squares))
    counts = np.asarray(counts, np.float64)
    limits_out, counts_out = [], []
    i = 0
    n = len(_BUCKET_LIMITS)
    while i < n:
        end = _BUCKET_LIMITS[i]
        count = counts[i]
        i += 1
        if count <= 0.0:
            while i < n and counts[i] <= 0.0:
                end = _BUCKET_LIMITS[i]
                i += 1
        limits_out.append(end)
        counts_out.append(count)
    histo += _tag(6, 2) + write_varint(8 * len(limits_out)) + struct.pack(
        f"<{len(limits_out)}d", *limits_out
    )
    histo += _tag(7, 2) + write_varint(8 * len(counts_out)) + struct.pack(
        f"<{len(counts_out)}d", *counts_out
    )
    val = _len_field(1, str(tag).encode()) + _len_field(5, histo)
    return _len_field(1, val)


def make_histogram(tag: str, values) -> bytes:
    """make_histogram_from_stats over host values. Non-finite entries are
    dropped everywhere (num/min/max/sum AND buckets) so the proto stays
    internally consistent even for diverging runs."""
    x = np.asarray(values, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    # bucket i spans (limit[i-1], limit[i]]; searchsorted with side="left"
    # maps v to the first limit >= v
    counts = np.bincount(
        np.searchsorted(_BUCKET_LIMITS, x, side="left"),
        minlength=len(_BUCKET_LIMITS),
    ).astype(np.float64)
    return make_histogram_from_stats(
        tag,
        num=float(x.size),
        vmin=float(x.min()) if x.size else 0.0,
        vmax=float(x.max()) if x.size else 0.0,
        vsum=float(x.sum()),
        sum_squares=float(np.square(x).sum()),
        counts=counts,
    )




def make_event(
    summary: Optional[bytes] = None,
    step: int = 0,
    wall_time: Optional[float] = None,
    file_version: Optional[str] = None,
) -> bytes:
    out = _double_field(1, time.time() if wall_time is None else wall_time)
    if step:
        out += _varint_field(2, step)
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary is not None:
        out += _len_field(5, summary)
    return out


class SummaryWriter:
    """Append-only events-file writer (one scalar or many per step)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._writer = TFRecordWriter(os.path.join(logdir, fname))
        self._writer.write(make_event(file_version="brain.Event:2"))

    def add_summary(self, summary: bytes, global_step: int = 0):
        self._writer.write(make_event(summary=summary, step=global_step))

    def scalar(self, tag: str, value: float, global_step: int = 0):
        self.add_summary(make_summary(tag, value), global_step)

    def histogram(self, tag: str, values, global_step: int = 0):
        self.add_summary(make_histogram(tag, values), global_step)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


class NullSummaryWriter(SummaryWriter):
    """Drop-everything writer for non-master processes.

    Multi-host runs elect one summary/checkpoint owner (the reference's
    is_chief, train.py:444); the other hosts keep the identical control
    flow but write nothing.
    """

    def __init__(self, logdir: str = ""):
        pass

    def add_summary(self, summary: bytes, global_step: int = 0):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def for_master(logdir: str, is_master: bool = True) -> SummaryWriter:
    """SummaryWriter on the master process, NullSummaryWriter elsewhere."""
    return SummaryWriter(logdir) if is_master else NullSummaryWriter()




def add_global_step_summary(
    summary_writer: Optional[SummaryWriter],
    global_step_val: int,
    global_step_info_dict: Dict[str, float],
    summary_scope: str = "Eval",
) -> str:
    """Per-batch scalars + the reference's log line (utils.py:37-78)."""
    this_hit_at_one = global_step_info_dict["hit_at_one"]
    this_perr = global_step_info_dict["perr"]
    this_loss = global_step_info_dict["loss"]
    examples_per_second = global_step_info_dict.get("examples_per_second", -1)

    if summary_writer is not None:
        summary_writer.scalar(
            f"GlobalStep/{summary_scope}_Hit@1", this_hit_at_one, global_step_val
        )
        summary_writer.scalar(
            f"GlobalStep/{summary_scope}_Perr", this_perr, global_step_val
        )
        summary_writer.scalar(
            f"GlobalStep/{summary_scope}_Loss", this_loss, global_step_val
        )
        if examples_per_second != -1:
            summary_writer.scalar(
                f"GlobalStep/{summary_scope}_Example_Second",
                examples_per_second,
                global_step_val,
            )
        summary_writer.flush()
    return (
        "global_step {0} | Batch Hit@1: {1:.3f} | Batch PERR: {2:.3f} "
        "| Batch Loss: {3:.3f} | Examples_per_sec: {4:.3f}"
    ).format(
        global_step_val, this_hit_at_one, this_perr, this_loss,
        examples_per_second,
    )


def add_epoch_summary(
    summary_writer: Optional[SummaryWriter],
    global_step_val: int,
    epoch_info_dict: Dict[str, object],
    summary_scope: str = "Eval",
) -> str:
    """Epoch scalars + the reference's log line (utils.py:81-125)."""
    epoch_id = epoch_info_dict["epoch_id"]
    avg_hit_at_one = epoch_info_dict["avg_hit_at_one"]
    avg_perr = epoch_info_dict["avg_perr"]
    avg_loss = epoch_info_dict["avg_loss"]
    aps = epoch_info_dict["aps"]
    gap = epoch_info_dict["gap"]
    mean_ap = float(np.mean(aps))

    if summary_writer is not None:
        summary_writer.scalar(
            f"Epoch/{summary_scope}_Avg_Hit@1", avg_hit_at_one, global_step_val
        )
        summary_writer.scalar(
            f"Epoch/{summary_scope}_Avg_Perr", avg_perr, global_step_val
        )
        summary_writer.scalar(
            f"Epoch/{summary_scope}_Avg_Loss", avg_loss, global_step_val
        )
        summary_writer.scalar(f"Epoch/{summary_scope}_MAP", mean_ap, global_step_val)
        summary_writer.scalar(f"Epoch/{summary_scope}_GAP", gap, global_step_val)
        summary_writer.flush()
    return (
        "epoch/eval number {0} | Avg_Hit@1: {1:.3f} | Avg_PERR: {2:.3f} "
        "| MAP: {3:.3f} | GAP: {4:.3f} | Avg_Loss: {5:3f}"
    ).format(epoch_id, avg_hit_at_one, avg_perr, mean_ap, gap, avg_loss)


with np.errstate(over="ignore"):
    # f32 limits: the limits beyond f32's range become +/-inf, which only
    # matters for values no f32 parameter holds
    _LIMITS_F32 = _BUCKET_LIMITS.astype(np.float32)


def jax_order(names):
    """`names` (dotted parameter names) in the order jax flattens the JAX
    parameter tree: dict keys sorted, list entries by index."""
    return sorted(names, key=lambda n: tuple(int(p) if p.isdigit() else p
                                             for p in n.split(".")))


def histogram_stats(tensors) -> np.ndarray:
    """Histogram statistics of each tensor, computed on its device like
    the JAX package's `histogram_stats_on_device`, and fetched in ONE
    transfer: a float64 array [P, 5 + L] of (num, min, max, sum,
    sum_squares, bucket counts). Non-finite values are dropped; a value v
    falls in the first bucket whose limit is >= v (`bucketize(right=False)`
    = `searchsorted(side="left")`); counts are integers (exact in float64)."""
    rows = []
    for t in tensors:
        x = t.detach().reshape(-1).to(torch.float32)
        limits = torch.from_numpy(_LIMITS_F32).to(x.device)
        finite = torch.isfinite(x)
        xf = torch.where(finite, x, 0.0)
        idx = torch.bucketize(x, limits, right=False).clamp_(0, len(limits) - 1)
        counts = torch.zeros(len(limits), dtype=torch.int64, device=x.device)
        counts.index_add_(0, idx, finite.to(torch.int64))
        head = torch.stack([
            finite.sum().to(torch.float64),
            torch.where(finite, x, float("inf")).min().to(torch.float64),
            torch.where(finite, x, float("-inf")).max().to(torch.float64),
            xf.sum().to(torch.float64),
            (xf * xf).sum().to(torch.float64),
        ])
        rows.append(torch.cat([head, counts.to(torch.float64)]))
    return torch.stack(rows).cpu().numpy()


def write_variable_histograms(writer: SummaryWriter,
                              params: Union[nn.Module, Dict[str, torch.Tensor]],
                              prefix: str, global_step: int) -> None:
    """One histogram per model variable, tag = its path with slashes
    (`model/rnn_l1/0/kernel`), in the JAX package's order — the rebuild of
    `tf.summary.histogram` over `slim.get_model_variables()`
    (train.py:426-427), emitted at the save_summaries_secs cadence."""
    named = dict(params.state_dict() if isinstance(params, nn.Module) else params)
    names = jax_order(named)
    stats = histogram_stats([named[n] for n in names])
    for name, row in zip(names, stats):
        num, vmin, vmax, vsum, sumsq = row[:5]
        writer.add_summary(
            make_histogram_from_stats(
                f"{prefix}/{name.replace('.', '/')}", float(num),
                float(vmin) if num else 0.0, float(vmax) if num else 0.0,
                float(vsum), float(sumsq), row[5:]),
            global_step)
