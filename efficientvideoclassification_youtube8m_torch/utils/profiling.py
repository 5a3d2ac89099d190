"""The program's one tracing system: named spans and counters, on exactly
while a `torch.profiler` runs in the process.

The reference's only observability is wall-clock deltas turned into
examples/sec summaries (`train.py:513-521,542-544`); the binaries keep
those. Beside them:

  * `annotate(name, batch=None)`: a span around host work. The switch
    is the profiler itself (`torch.autograd.profiler._is_profiler_enabled`,
    which `profile.start()` and `stop()` set): with no profiler running
    a span is one module-global read and a shared no-op context. With
    one running it enters a `record_function` range (its C++ fast path)
    where the profiler records the calling thread (the thread that
    started it: a reader thread's would not show), pushes an NVTX range
    on a CUDA build, and appends one record to a bounded ring: its name,
    thread, start and end ns on the profiler's clock (wall-clock epoch
    ns, the time base of the profiler's host events), its parent (the
    enclosing span on the same thread) and an optional batch index,
    which the spans of one batch share.
  * `count(name, n=1)`: a counter, under the same switch.
  * `add_spans(name, spans)`: spans that threads running no Python (the
    native batcher's team) logged themselves, recorded as theirs.
  * `totals()`: for each span name its count, total seconds and self
    seconds (the duration less what its child spans cover), and the
    counters, since the last `reset()`. Each thread keeps its own, so a
    span takes no lock.
  * `trace(logdir)`: the operator's way to trace a binary. It runs
    `torch.profiler` (CUDA activity when the device is the card) around
    the enclosed work and writes a Chrome trace (chrome://tracing,
    Perfetto) into `logdir` that also holds the spans of the threads
    the profiler cannot see, one track a thread on the same time base.

The spans and counters of the eval path and the loader (the same names
at `--steps_per_dispatch` 1 and K > 1; the training loop shares the
prefetch and the fetch):

  loader.queue_wait   the loader's consumer taking a batch's videos off
                      the readers' queue, its waits included; on the
                      native batcher's path (`FrameDataLoader`, in order)
                      its wait for the oldest block the readers fill
  loader.assemble     the consumer assembling a batch (`_assemble`); on
                      the batcher's path building the batch from its
                      block (ids, a short tail) and handing a block in
  loader.parse        a reader thread advancing its parser by one video;
                      on the batcher's path a thread of the native team
                      holding a record stream to locate its next record,
                      from taking the stream to giving it back, less any
                      wait for a block (at most `num_readers` at once;
                      logged by the thread, added by the consumer)
  loader.decode       on the batcher's path a team thread reading a
                      record's bytes and decoding them into its row,
                      labels and id (added likewise)
  loader.stream_waits (counter) on the batcher's path the times a team
                      thread found every stream held and waited for one
  loader.videos       (counter) videos parsed (a batch at a time on the
                      batcher's path)
  loader.in_place     (counter) batches the native batcher filled
  prefetch.h2d        a batch's host->device copy enqueued, its staging
                      in pinned memory (`prefetch.pin`) included
  prefetch.staged     (counter) arrays copied into pinned memory
                      (`cli/loop._stage`); the loader's own pinned
                      blocks are sent as they are and not counted
  step.eval           the eval, validate and int8 eval steps' host
                      dispatch (not their device time)
  lstm.scan           `LstmModel`'s LSTM stack, inside its step
  lstm.head           `LstmModel`'s classifier, inside its step
  lstm.step_launches  (counter) step kernels `lstm_chunk_scan` launched,
                      T a call
  fetch.enqueue       `HostFetch` queueing a step's device->host copy
  fetch.wait          `HostFetch.get()` waiting for that copy
  eval.accumulate     a fetch's rows unpacked (`eval.unpack`), scored
                      (`metrics.accumulate_topk`) and summarised
                      (`eval.summary`: scalars, flush, log line)
  eval.batches        (counter) batches accumulated

The kernels' own `.launches` counters are separate: they count with
tracing off.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 1 << 17  # span records kept; the oldest go first
_OFF = contextlib.nullcontext()
# the profiler's cheapest host range (a C++ context manager; a
# `torch.profiler.record_function` costs several times as much)
_RANGE = torch._C._profiler._RecordFunctionFast


class _Store:
    """One thread's span totals and counters. Only its thread writes them,
    so a span takes no lock: one lock shared by the loader's reader
    threads and its consumer, taken twice a video, makes them queue for
    it and then for the interpreter lock. A thread that runs no Python
    has its store written by the thread that adds its spans."""

    __slots__ = ("generation", "tid", "spans", "counters")

    def __init__(self, generation: int, tid: Optional[int] = None):
        self.generation = generation
        self.tid = threading.get_native_id() if tid is None else tid
        self.spans: Dict[str, tuple] = {}  # name -> (count, total ns, self ns)
        self.counters: Dict[str, int] = {}


class _Registry:
    """The spans' ring (a deque, whose appends are atomic) and every
    thread's `_Store`, shared by the process; `reset()` starts a new
    generation of stores."""

    def __init__(self):
        self.lock = threading.Lock()  # guards `stores` and the generation
        self.local = threading.local()  # .stack: the thread's open spans; .store
        self.nvtx: Optional[bool] = None  # decided on the first span
        self.generation = 0
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.generation += 1
            self.ring: collections.deque = collections.deque(maxlen=RING)
            self.stores: list = []
            self.others: Dict[int, _Store] = {}  # by thread id: threads running no Python

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def store(self) -> _Store:
        store = getattr(self.local, "store", None)
        if store is None or store.generation != self.generation:
            with self.lock:
                store = self.local.store = _Store(self.generation)
                self.stores.append(store)
        return store

    def other_store(self, tid: int) -> _Store:
        with self.lock:
            store = self.others.get(tid)
            if store is None:
                store = self.others[tid] = _Store(self.generation, tid)
                self.stores.append(store)
            return store


_REGISTRY = _Registry()


class _Span:
    """One open span; its frame is [name, start ns, ns its children cover]."""

    __slots__ = ("name", "batch", "range", "frame", "nvtx")

    def __init__(self, name: str, batch: Optional[int]):
        self.name = name
        self.batch = batch

    def __enter__(self):
        reg = _REGISTRY
        # the profiler records only the thread that started it
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = _RANGE(self.name)
            self.range.__enter__()
        if reg.nvtx is None:
            reg.nvtx = torch.cuda.is_available()
        self.nvtx = reg.nvtx
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.frame = [self.name, 0, 0]
        reg.stack().append(self.frame)
        self.frame[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        reg = _REGISTRY
        name, start, children = self.frame
        stack = reg.stack()
        stack.pop()
        parent = stack[-1] if stack else None
        duration = end - start
        if parent is not None:
            parent[2] += duration
        store = reg.store()
        reg.ring.append((name, store.tid, start, end,
                         parent[0] if parent is not None else None, self.batch))
        count, total, own = store.spans.get(name, (0, 0, 0))
        store.spans[name] = (count + 1, total + duration, own + duration - children)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def annotate(name: str, batch: Optional[int] = None):
    """A span named `name` around the enclosed host work (see the module's
    docstring); `batch` is the index of the batch it works on, if any."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, batch)


def enabled() -> bool:
    """Whether spans and counters record now (a profiler runs)."""
    return bool(_autograd_profiler._is_profiler_enabled)


def add_spans(name: str, spans) -> None:
    """Record spans that threads running no Python logged themselves:
    `spans` holds (native thread id, start ns, end ns) on `time.time_ns`'s
    clock. Each is a record of its thread, with no parent or batch, and
    adds to that thread's totals, while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    reg = _REGISTRY
    stores: Dict[int, _Store] = {}
    for tid, start, end in spans:
        reg.ring.append((name, tid, start, end, None, None))
        store = stores.get(tid)
        if store is None:
            store = stores[tid] = reg.other_store(tid)
        count, total, own = store.spans.get(name, (0, 0, 0))
        store.spans[name] = (count + 1, total + end - start, own + end - start)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    counters = _REGISTRY.store().counters
    counters[name] = counters.get(name, 0) + n


def totals() -> Dict[str, Dict]:
    """{"spans": {name: {"count", "seconds", "self_seconds"}}, "counters":
    {name: n}} over every thread since the last `reset()`."""
    with _REGISTRY.lock:
        stores = list(_REGISTRY.stores)
    spans: Dict[str, list] = {}
    counters: Dict[str, int] = {}
    for store in stores:
        # copied whole under the interpreter lock; each value is replaced,
        # never changed in place, so each is consistent
        for name, (c, t, own) in dict(store.spans).items():
            acc = spans.setdefault(name, [0, 0, 0])
            acc[0] += c
            acc[1] += t
            acc[2] += own
        for name, n in dict(store.counters).items():
            counters[name] = counters.get(name, 0) + n
    return {"spans": {name: {"count": c, "seconds": t * 1e-9, "self_seconds": own * 1e-9}
                      for name, (c, t, own) in spans.items()},
            "counters": counters}


def records() -> list:
    """The ring's span records, oldest first: (name, thread id, start ns,
    end ns, parent name or None, batch index or None)."""
    return list(_REGISTRY.ring)


def reset() -> None:
    """Clear the records, the totals and the counters."""
    _REGISTRY.reset()


class Trace:
    """What `trace` yields: the running `torch.profiler.profile`
    (`profile`, for `key_averages()` and the like) and, once the block
    has ended, the path of the Chrome trace it wrote (`path`) and the
    block's span and counter `totals()` (`totals`)."""

    def __init__(self, profile):
        self.profile = profile
        self.path: Optional[str] = None
        self.totals: Optional[Dict] = None


@contextlib.contextmanager
def trace(logdir: str, device=None):
    """Profile the enclosed work with `torch.profiler` and write the
    Chrome trace `trace.<pid>.<ms>.json` into `logdir`, with the program's
    spans of the threads the profiler does not record (the loader's
    readers) added, one track a thread. The span registry is reset when
    the block starts. CUDA activity is recorded when `device` is a CUDA
    device, or, with no device, when CUDA is available."""
    from torch.profiler import ProfilerActivity, profile

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        result = Trace(prof)
        yield result
        if cuda:
            torch.cuda.synchronize()
    result.totals = totals()
    path = os.path.join(logdir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    _add_thread_spans(path, threading.get_native_id())
    result.path = path


def _add_thread_spans(path: str, profiled_tid: int) -> None:
    """Add to the Chrome trace at `path` the recorded spans of every thread
    but `profiled_tid` (whose spans the profiler wrote itself), on the
    trace's time base (µs after its `baseTimeNanoseconds`)."""
    spans = [r for r in records() if r[1] != profiled_tid]
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for tid in sorted({r[1] for r in spans}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"thread {tid} (program spans)"}})
    for name, tid, start, end, parent, batch in spans:
        args = {"parent": parent} if parent is not None else {}
        if batch is not None:
            args["batch"] = batch
        events.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid,
                       "tid": tid, "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
