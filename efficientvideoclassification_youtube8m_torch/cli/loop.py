"""The training loop of cli.train and cli.finetune (port of the
JAX package's cli/loop.py), and the host->device prefetch of every
binary.

`device_prefetch` copies each host batch to the device one batch ahead
(the counterpart of the JAX package's parallel/mesh.py `device_prefetch`);
`HostFetch` queues a step's device->host copies right behind the step, so
a later wait covers that step alone; `run_training_loop` fetches each
step's metrics one step late (the fetch of step N follows the launch of
step N+1, so host logging overlaps device work), saves on the
save_model_secs cadence through the
AsyncCheckpointSaver, writes graph summaries on the save_summaries_secs
cadence, and on Ctrl-C saves, logs the pending step, joins the writer and
closes the summary writer.
"""

from __future__ import annotations

import time
from collections import deque

import torch


def device_prefetch(loader, device: torch.device, depth: int = 1,
                    host_keep=None):
    """Yield `((features, labels, num_frames) on `device`, host_keep(batch))`
    with the host->device copy running `depth` batches ahead.

    On a CUDA device each batch goes through pinned memory with
    `non_blocking` copies on a side stream, so batch k+1's transfer
    overlaps step k; the consumer's stream waits on the copy's event
    before it uses the tensors. Only `host_keep(batch)` stays on the host
    (default: the labels, for the train loops' metric logging)."""
    if host_keep is None:
        host_keep = lambda b: b.labels  # noqa: E731
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    pending: deque = deque()

    def send(batch):
        host = [torch.from_numpy(a) for a in
                (batch.features, batch.labels, batch.num_frames)]
        if not cuda:
            return host, None
        with torch.cuda.stream(stream):
            dev = [t.pin_memory().to(device, non_blocking=True) for t in host]
            return dev, stream.record_event()

    def receive(item):
        (dev, event), kept = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for t in dev:
                t.record_stream(current)
        return tuple(dev), kept

    for batch in loader:
        pending.append((send(batch), host_keep(batch)))
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
        if self._event is not None:
            self._event.synchronize()
        return self._host


def run_training_loop(*, loader, device, state, step_fn, saver, writer, cfg,
                      args, log_step, write_graph_summaries, logger):
    """Drive `step_fn` over the loader until the epoch limit or Ctrl-C.

    `log_step(metrics, host_labels, seconds_per_batch)` and
    `write_graph_summaries(metrics, global_step_val, state)` are the
    binary-specific pieces. Returns the final state."""
    last_save = time.time()
    last_summary = time.time()
    pending = None  # (HostFetch of the metrics, host_labels, batch_start_time)
    interrupted = False
    try:
        for (f, l, n), host_labels in device_prefetch(loader, device):
            batch_start_time = time.time()
            state, metrics = step_fn(state, f, l, n)
            metrics = HostFetch(metrics)
            if pending is not None:
                lagged = pending[0].get()
                log_step(lagged, pending[1], batch_start_time - pending[2])
                if time.time() - last_summary > args.save_summaries_secs:
                    write_graph_summaries(lagged, int(lagged["global_step"]), state)
                    last_summary = time.time()
            pending = (metrics, host_labels, batch_start_time)
            if time.time() - last_save > args.save_model_secs:
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
