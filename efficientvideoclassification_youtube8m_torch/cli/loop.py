"""The training loop of cli.train and cli.finetune (port of the
JAX package's cli/loop.py), the eval loop of cli.eval, cli.validate and
cli.infer, and the host->device prefetch of every binary.

`device_prefetch` copies each host batch to the device one batch ahead
(the counterpart of the JAX package's parallel/mesh.py `device_prefetch`);
`HostFetch` queues a step's device->host copies right behind the step, so
a later wait covers that step alone; `eval_loop` launches every batch as
it arrives and fetches the outputs of `--steps_per_dispatch` batches at a
time through the lag-N ring `stacked_ring`; `run_training_loop` fetches each
step's metrics one step late (the fetch of step N follows the launch of
step N+1, so host logging overlaps device work), saves on the
save_model_secs cadence through the
AsyncCheckpointSaver, writes graph summaries on the save_summaries_secs
cadence, and on Ctrl-C saves, logs the pending step, joins the writer and
closes the summary writer. Under a process group the loader goes through
`distributed.sync_host_streams` (every rank stops when one runs dry, and
the ranks of a model group step on the same batches) and
the master's clock decides the cadences for every rank.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.utils import profiling


def _stage(a: np.ndarray) -> torch.Tensor:
    """A copy of `a` in pinned memory, made with one `np.copyto`:
    single-threaded and outside the interpreter lock, where a
    `Tensor.copy_` or `pin_memory()` runs on the intra-op thread team,
    which the loader's reader threads keep busy. The buffer comes from
    PyTorch's caching host allocator, which hands a block out again only
    once the `non_blocking` copies that read it have run."""
    buf = torch.empty(a.shape, dtype=torch.from_numpy(a).dtype, pin_memory=True)
    np.copyto(buf.numpy(), a)
    return buf


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """`a` in pinned memory: the pinned block that `a` is the whole of (the
    loader's batch arrays with a CUDA device, `data/loader._array`), else
    a staged copy (`_stage`, counted by `prefetch.staged`). Only
    `Tensor.numpy()` gives an array a tensor for its base, with the
    tensor's shape, dtype and bytes (a view or slice of that array has the
    array for its base); the tensor is a whole block if it starts the
    block and is contiguous. It is on the caching host allocator's own
    storage, so a `non_blocking` copy from it records its stream on the
    block by the storage's context, and the allocator hands the block out
    again only once the copy has read it."""
    t = a.base
    if (isinstance(t, torch.Tensor) and t.storage_offset() == 0
            and t.is_contiguous() and t.is_pinned()):
        return t
    profiling.count("prefetch.staged")
    return _stage(a)


def device_prefetch(loader, device: torch.device, depth: int = 1,
                    host_keep=None):
    """Yield `((features, labels, num_frames) on `device`, host_keep(batch))`
    with the host->device copy running `depth` batches ahead.

    On a CUDA device each array is copied with a `non_blocking` copy on a
    side stream from pinned memory (`_host_tensor`: the loader's own
    pinned block, or a staged copy of any other array), so batch k+1's
    transfer overlaps step k; the consumer's stream waits on the copy's
    event before it uses the tensors. Only `host_keep(batch)` stays on
    the host (default: the labels, for the train loops' metric logging):
    the loader's own arrays, never a staging buffer, which a later batch
    reuses."""
    if host_keep is None:
        host_keep = lambda b: b.labels  # noqa: E731
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    pending: deque = deque()

    def send(batch, index):
        with profiling.annotate("prefetch.h2d", index):
            arrays = (batch.features, batch.labels, batch.num_frames)
            if not cuda:
                return [torch.from_numpy(a) for a in arrays], None
            with torch.cuda.stream(stream):
                with profiling.annotate("prefetch.pin", index):
                    host = [_host_tensor(a) for a in arrays]
                dev = [t.to(device, non_blocking=True) for t in host]
                return dev, stream.record_event()

    def receive(item):
        (dev, event), kept = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in dev:
                t.record_stream(current)
        return tuple(dev), kept

    for index, batch in enumerate(loader):
        pending.append((send(batch, index), host_keep(batch)))
        if len(pending) > depth:
            yield receive(pending.popleft())
    while pending:
        yield receive(pending.popleft())


class HostFetch:
    """The tensors of a step's output dict (`keys`, default all), copied to
    the host. On a CUDA device the copies go into pinned buffers with
    `non_blocking` copies queued on the current stream right after the
    step, and `get()` waits on their event alone: a `.cpu()` at fetch time
    would queue behind every step launched since and wait for those too,
    which serializes a lagged fetch with the device. Other values pass
    through."""

    def __init__(self, out: dict, keys=None):
        self._event = None
        self._host = {}
        with profiling.annotate("fetch.enqueue"):
            for key in out if keys is None else keys:
                value = out[key]
                if isinstance(value, torch.Tensor) and value.is_cuda:
                    buf = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                    value = buf.copy_(value, non_blocking=True)
                    if self._event is None:
                        self._event = torch.cuda.Event()
                self._host[key] = value
            if self._event is not None:
                self._event.record()

    def get(self) -> dict:
        with profiling.annotate("fetch.wait"):
            if self._event is not None:
                self._event.synchronize()
        return self._host


def stacked_ring(batches, steps: int, depth: int, launch):
    """Group the `batches` into stacks of `steps`, `launch(bufs)` each (an
    in-flight handle), and yield the handles from a FIFO lag-`depth`
    ring, popped only when MORE than `depth` launches are in flight, so
    that much dispatch and fetch latency overlaps device work while the
    consumer sees the per-batch loop's order. The last partial stack is
    launched as it is."""
    ring: deque = deque()
    buf = []
    for batch in batches:
        buf.append(batch)
        if len(buf) == steps:
            ring.append(launch(buf))
            buf = []
            if len(ring) > depth:
                yield ring.popleft()
    if buf:
        ring.append(launch(buf))
    while ring:
        yield ring.popleft()


def eval_loop(batches, device: torch.device, steps: int, depth: int, launch,
              keys, host_keep):
    """The eval binaries' loop at every `--steps_per_dispatch` K. Each host
    batch goes through `device_prefetch` and `launch(f, l, n)` (an output
    dict) runs as soon as it is on the device; the batches of a group of
    up to K are fetched in one `HostFetch` of their `keys`, queued behind
    the group's last step, and a group is waited for only when more than
    `depth` groups are in flight (`stacked_ring`). Yields `(outputs,
    host_keep(batch))` a batch, in batch order: the epoch metrics and CSV
    rows are those of K = 1, which is groups of one."""
    def select(out):  # the step's other outputs are freed at once
        return [out[key] for key in keys]

    launched = ((select(launch(f, l, n)), kept) for (f, l, n), kept in
                device_prefetch(batches, device, host_keep=host_keep))

    def fetch(group):
        outs = {(i, key): value for i, (values, _) in enumerate(group)
                for key, value in zip(keys, values)}
        return HostFetch(outs), [kept for _, kept in group]

    for pending, kept in stacked_ring(launched, steps, depth, fetch):
        host = pending.get()
        for i, batch_kept in enumerate(kept):
            yield {key: host[i, key] for key in keys}, batch_kept


def run_training_loop(*, loader, device, state, step_fn, saver, writer, cfg,
                      args, log_step, write_graph_summaries, logger, mesh=None):
    """Drive `step_fn` over the loader until the epoch limit or Ctrl-C.

    `log_step(metrics, host_labels, seconds_per_batch)` and
    `write_graph_summaries(metrics, global_step_val, state)` are the
    binary-specific pieces; `mesh` is the step's (a model group's ranks
    step on the batches of its first rank's loader). Returns the final
    state."""
    last_save = time.time()
    last_summary = time.time()
    pending = None  # (HostFetch of the metrics, host_labels, batch_start_time)
    interrupted = False
    try:
        for (f, l, n), host_labels in device_prefetch(
                distributed.sync_host_streams(loader, "train", mesh), device):
            batch_start_time = time.time()
            state, metrics = step_fn(state, f, l, n)
            metrics = HostFetch(metrics)
            if pending is not None:
                lagged = pending[0].get()
                log_step(lagged, pending[1], batch_start_time - pending[2])
                if distributed.broadcast_flag(
                        time.time() - last_summary > args.save_summaries_secs):
                    write_graph_summaries(lagged, int(lagged["global_step"]), state)
                    last_summary = time.time()
            pending = (metrics, host_labels, batch_start_time)
            if distributed.broadcast_flag(
                    time.time() - last_save > args.save_model_secs):
                # named by the step stored IN the saved state (the
                # reference's Saver uses the graph's global_step,
                # train.py:502), not by the lagged log step
                saver.save(cfg.train_dir, state, state.global_step,
                           backend=args.checkpoint_format)
                last_save = time.time()
    except KeyboardInterrupt:
        interrupted = True
        logger.info("Interrupted; saving checkpoint.")
    if pending is not None:
        # the lagged metrics are logged even on interrupt: their step
        # completed, only its fetch was outstanding
        log_step(pending[0].get(), pending[1], time.time() - pending[2])
    if not interrupted:
        logger.info("Done training -- epoch limit reached.")
    saver.save(cfg.train_dir, state, state.global_step,
               backend=args.checkpoint_format)
    saver.wait()  # the final snapshot must be on disk before exit
    writer.close()
    return state
