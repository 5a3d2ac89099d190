"""Checkpointing with TF-Saver semantics (port of the JAX package's
train/checkpoint.py, msgpack backend, single process).

A checkpoint is `model.ckpt-<step>.msgpack` in the JAX package's layout
(`train.state.state_tree`), written by the jax-free codec of
`train/msgpack_io.py`: the JAX package's `restore_checkpoint` reads the
port's files and the port reads the JAX package's. The `checkpoint`
pointer file lists basenames latest first; `max_to_keep` removes the
oldest. Orbax directories and the reference's TF-V2 bundles are not
ported and raise.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch.train import msgpack_io
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    StudentState,
    load_state_tree,
    state_tree,
)
from efficientvideoclassification_youtube8m_tpu.data.tf_checkpoint import (
    is_tf_checkpoint,
    latest_tf_checkpoint,
)

_POINTER = "checkpoint"
_PREFIX = "model.ckpt"


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError(
            "orbax checkpoints are not ported yet (ROADMAP Queue 1 item 13); "
            "use --checkpoint_format msgpack")
    if backend != "msgpack":
        raise ValueError(f"unknown checkpoint backend {backend!r}")


def _tree(state: Any) -> Any:
    """A port state as its JAX state tree; any other tree as it is."""
    if isinstance(state, (DistillState, StudentState)):
        return state_tree(state)
    return state


def _to_numpy(leaf: Any) -> np.ndarray:
    """The writer's conversion of a tensor leaf: float32 (the JAX
    layout's parameter and slot dtype) or the integer dtype, on the host."""
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"cannot serialize a {type(leaf).__name__}")
    leaf = leaf.detach()
    if leaf.is_floating_point():
        leaf = leaf.to(torch.float32)
    return leaf.cpu().numpy()


def save_checkpoint(train_dir: str, state: Any, step: int,
                    max_to_keep: int = 1, backend: str = "msgpack") -> str:
    """Write `model.ckpt-<step>.msgpack` (through `.tmp` and `os.replace`)
    and update the pointer file. `state` is a DistillState/StudentState
    or a tree of the codec's types and tensors. The reference keeps only
    the latest (`Saver(max_to_keep=1)`, train.py:651)."""
    _check_backend(backend)
    os.makedirs(train_dir, exist_ok=True)
    path = os.path.join(train_dir, f"{_PREFIX}-{step}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        msgpack_io.dump(_tree(state), f, default=_to_numpy)
    os.replace(tmp, path)
    _update_pointer(train_dir, path, max_to_keep)
    return path


def _update_pointer(train_dir: str, path: str, max_to_keep: int) -> None:
    """The tail of a save: pointer file + max_to_keep cleanup."""
    existing = _list_checkpoints(train_dir)
    ordered = [path] + [p for p in existing if p != path]
    with open(os.path.join(train_dir, _POINTER), "w") as f:
        for p in ordered:
            f.write(os.path.basename(p) + "\n")
    if max_to_keep and len(ordered) > max_to_keep:
        for p in ordered[max_to_keep:]:
            try:
                if os.path.isdir(p):
                    shutil.rmtree(p)
                else:
                    os.remove(p)
            except OSError:
                pass


class AsyncCheckpointSaver:
    """Checkpoint writes overlapped with training.

    `save()` snapshots the state on the calling thread and hands the
    snapshot to a writer thread, which writes the file with
    `save_checkpoint`. The train steps update parameters and slots in
    place, so the snapshot must be a copy taken before the next step is
    launched. CUDA tensors are copied into pinned host buffers with
    `non_blocking` copies on the current stream: the next step's kernels
    queue behind the copies, the host does not wait, and the writer
    thread waits on one CUDA event. The buffers are kept and reused by
    the next save (about 3.4 GB for the flagship distill state). An
    in-HBM clone would hold the device for less time, at 3.4 GB of HBM
    and a second copy stream; the pinned copy costs no HBM. CPU tensors
    are cloned.

    One save in flight at a time: a second `save()` joins the first.
    `wait()` joins and re-raises a failure of the writer; call it before
    reading the train_dir, and at loop exit."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._pinned: Dict[str, torch.Tensor] = {}

    def _snapshot(self, tree: Any, path: str = "") -> Any:
        if isinstance(tree, dict):
            return {k: self._snapshot(v, f"{path}/{k}") for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return np.array(tree) if isinstance(tree, np.ndarray) else tree
        x = tree.detach()
        dtype = torch.float32 if x.is_floating_point() else x.dtype
        if not x.is_cuda:
            return x.to(dtype, copy=True)
        buf = self._pinned.get(path)
        if buf is None or buf.shape != x.shape or buf.dtype != dtype:
            buf = torch.empty(x.shape, dtype=dtype, pin_memory=True)
            self._pinned[path] = buf
        buf.copy_(x, non_blocking=True)
        return buf

    def save(self, train_dir: str, state: Any, step: int,
             max_to_keep: int = 1, backend: str = "msgpack") -> None:
        _check_backend(backend)
        self.wait()
        if not self.enabled:
            save_checkpoint(train_dir, state, step, max_to_keep=max_to_keep)
            return
        snapshot = self._snapshot(_tree(state))
        copied = None
        if torch.cuda.is_initialized():
            # covers the snapshot's copies from the card, if any: they were
            # queued on the current stream
            copied = torch.cuda.Event()
            copied.record()

        def write():
            try:
                if copied is not None:
                    copied.synchronize()
                save_checkpoint(train_dir, snapshot, step, max_to_keep=max_to_keep)
            except BaseException as e:  # surfaced at the next wait()/save()
                self._exc = e

        self._thread = threading.Thread(target=write, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _list_checkpoints(train_dir: str) -> List[str]:
    if not os.path.isdir(train_dir):
        return []
    paths = []
    for name in os.listdir(train_dir):
        m = re.fullmatch(rf"{re.escape(_PREFIX)}-(\d+)(\.msgpack)?", name)
        if m:
            paths.append((int(m.group(1)), os.path.join(train_dir, name)))
    return [p for _, p in sorted(paths, reverse=True)]


def latest_checkpoint(train_dir: str) -> Optional[str]:
    """`tf.train.latest_checkpoint`: the pointer file first, then a scan
    of the directory. Reads both this package's pointer files and the
    reference's TF-format ones (`model_checkpoint_path: "..."`)."""
    pointer = os.path.join(train_dir, _POINTER)
    if os.path.exists(pointer):
        with open(pointer) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("model_checkpoint_path:",
                                    "all_model_checkpoint_paths:")):
                    line = line.split(":", 1)[1].strip().strip('"')
                    if not os.path.isabs(line):
                        line = os.path.join(train_dir, line)
                    if os.path.exists(line + ".index"):
                        return line
                    continue
                candidate = os.path.join(train_dir, line)
                if os.path.exists(candidate):
                    return candidate
    existing = _list_checkpoints(train_dir)
    if existing:
        return existing[0]
    return latest_tf_checkpoint(train_dir)


def checkpoint_step(path: str) -> int:
    m = re.search(rf"{re.escape(_PREFIX)}-(\d+)(\.msgpack)?$", path)
    return int(m.group(1)) if m else 0


def read_checkpoint(path: str) -> Any:
    """The raw tree of a msgpack checkpoint (numpy leaves). Orbax
    directories and TF-V2 bundles raise NotImplementedError."""
    if is_tf_checkpoint(path):
        raise NotImplementedError(
            f"{path} is a TF-V2 bundle of the reference; importing those is "
            "the TF-V2 remainder of ROADMAP Queue 1 item 8")
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint; orbax is not ported yet "
            "(ROADMAP Queue 1 item 13)")
    return msgpack_io.load(path)


def restore_checkpoint(path: str, target):
    """Restore a checkpoint into the DistillState/StudentState `target`
    in place and return it. Every field of the target must be in the file
    (extra fields are ignored, as flax ignores them); names, structure and
    shapes are checked before anything is copied."""
    return load_state_tree(target, read_checkpoint(path))


def restore_subtree(path: str, target, keys: Sequence[str]):
    """Restore only the top-level fields `keys` (e.g. the parameters of
    one tower) into `target`; the explicit name->variable maps of the
    reference's validate.py:350-381 become field selection."""
    tree = read_checkpoint(path)
    for key in keys:
        if key not in tree:
            raise KeyError(f"checkpoint {path} has no field {key!r}")
    return load_state_tree(target, tree, fields=keys)
