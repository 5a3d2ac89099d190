"""Multi-process runtime helpers (port of the JAX package's
parallel/distributed.py over `torch.distributed`).

The reference's distribution story is a TF1 grpc parameter-server
scaffold keyed off TF_CONFIG (`train.py:654-733`). The port runs one
process per device:

  * `initialize()`: `torch.distributed.init_process_group` from the
    reference's TF_CONFIG cluster spec or the standard MASTER_ADDR /
    MASTER_PORT / RANK / WORLD_SIZE variables, with an explicit timeout
    (a missing peer is an error, never a hang); NCCL for a CUDA device,
    gloo on the CPU. Host-side collectives (stream sync, broadcasts, the
    eval-row gather) run on a gloo group of their own, so they take CPU
    tensors whatever the device backend;
  * `host_context()`: which slice of the input shards this process reads
    and how many rows of the GLOBAL `--batch_size` it loads;
  * `sync_host_streams`, `broadcast_flag`, `broadcast_str`,
    `gather_eval_rows`: what keeps every rank in the same collective
    step and gives the eval binaries the single-process row stream;
    `scatter_batches`: one reader's global batches cut into the ranks'
    rows (cli.infer, whose CSV keeps one process's row order);
  * `unpack_host_pack`, `gather_step_outputs`: a step's packed host
    outputs as the eval binaries' rows.

With no cluster in the environment every helper is a passthrough.
Fault tolerance is the reference's: periodic checkpoints and
relaunch-and-resume.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from efficientvideoclassification_youtube8m_torch.parallel.mesh import default_device

# how long a rank waits for its peers at start-up and in a collective
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)

_HOST_GROUP = None  # the gloo group of the host-side collectives


def parse_tf_config(env: Optional[dict] = None) -> Optional[dict]:
    """The reference's TF_CONFIG cluster spec (train.py:710-718): masters
    first, then workers, so process ids are unique across both jobs."""
    env = os.environ if env is None else env
    raw = env.get("TF_CONFIG")
    if not raw:
        return None
    cfg = json.loads(raw)
    cluster = cfg.get("cluster", {})
    task = cfg.get("task", {"type": "master", "index": 0})
    masters = cluster.get("master", [])
    workers = cluster.get("worker", [])
    hosts = masters + workers
    index = int(task.get("index", 0))
    task_type = task.get("type", "master")
    process_id = index if task_type == "master" else len(masters) + index
    return {
        "coordinator": hosts[0] if hosts else None,
        "num_processes": len(hosts) or 1,
        "process_id": process_id,
        "task_type": task_type,
    }


def _from_environment() -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(coordinator host:port, world size, rank) that TF_CONFIG or the
    MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE variables name, else Nones."""
    tfc = parse_tf_config()
    if tfc and tfc["num_processes"] > 1:
        return tfc["coordinator"], tfc["num_processes"], tfc["process_id"]
    env = os.environ
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        return (f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}",
                int(env["WORLD_SIZE"]), int(env.get("RANK", 0)))
    return None, None, None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[torch.device] = None,
               backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Join the process group that the arguments or the environment name
    (TF_CONFIG first, then MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE); a
    no-op for a single process or when a group is already up (several
    binaries' mains in one process).

    `device` defaults to the rank's CUDA device (LOCAL_RANK's card; no
    CUDA raises, `mesh.default_device`). The backend is `backend`, else
    NCCL when `device` is a CUDA device and gloo otherwise. A peer that
    does not join within `timeout` (default `DEFAULT_TIMEOUT`) raises
    (torch.distributed's DistError)."""
    global _HOST_GROUP
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address, num_processes, process_id = _from_environment()
    if coordinator_address is None:
        return  # single process
    device = default_device() if device is None else torch.device(device)
    timeout = DEFAULT_TIMEOUT if timeout is None else timeout
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=timeout, **kwargs)
    _HOST_GROUP = (dist.new_group(backend="gloo", timeout=timeout)
                   if backend != "gloo" else dist.group.WORLD)


def shutdown() -> None:
    """Leave the process group (the end of a multi-process run)."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard() -> Tuple[int, int]:
    """(shard_index, num_shards) for this process's input pipeline."""
    return rank(), world_size()


def is_master() -> bool:
    """The reference's master election (`train.py:444`)."""
    return rank() == 0


@dataclasses.dataclass(frozen=True)
class HostContext:
    """One process's place in the cluster (the reference's task index /
    is_chief, `train.py:704-733`): which input shards it reads, how many
    rows of the GLOBAL batch it loads, and whether it owns the side
    effects (summaries, checkpoints, exports). Under tensor parallelism
    the index and count are the rank's data index and the data size: the
    ranks of a model group share one slice, which its first rank reads
    (`sync_host_streams`)."""

    process_index: int
    process_count: int
    local_batch_size: int
    is_master: bool

    @property
    def multi_host(self) -> bool:
        return self.process_count > 1


def host_context(global_batch_size: int, model: int = 1) -> HostContext:
    """This process's role after `initialize()`. `--batch_size` keeps its
    single-process meaning, the GLOBAL batch; each data index loads its
    `1/data` slice, where data = processes / `model` (the
    `--model_parallelism` of `mesh.create_mesh`)."""
    index, count = host_shard()
    if count % model:
        raise ValueError(f"{count} processes not divisible by model={model}")
    index, count = index // model, count // model
    if global_batch_size % count:
        raise ValueError(f"--batch_size {global_batch_size} not divisible "
                         f"by {count} data-parallel processes")
    return HostContext(process_index=index, process_count=count,
                       local_batch_size=global_batch_size // count,
                       is_master=rank() == 0)


def _dummy_batch(loader):
    """A fully padded batch (pad == batch rows) of the loader's shapes."""
    from efficientvideoclassification_youtube8m_torch.data import (
        AggregatedBatch,
        AggregatedDataLoader,
        FrameBatch,
    )

    b = loader.batch_size
    labels = np.zeros((b, loader.vocab_size), bool)
    if isinstance(loader, AggregatedDataLoader):
        return AggregatedBatch(video_ids=[""] * b, labels=labels, pad=b,
                               features=np.zeros((b, loader.total_size),
                                                 np.float32))
    rows = getattr(loader, "feature_rows", loader.max_frames)
    return FrameBatch(video_ids=[""] * b, labels=labels, pad=b,
                      features=np.zeros((b, rows, loader.total_size), np.uint8),
                      num_frames=np.ones((b,), np.int32))


def sync_host_streams(loader, mode: str = "train", mesh=None):
    """Keep every rank's step count identical. Shards are never perfectly
    balanced, and a rank that runs dry while the others step would leave
    them waiting in the next collective. Each iteration reduces a 1-bit
    "I have a batch" flag over the ranks:

      * mode="train": every rank stops as soon as ANY rank is dry (the
        cluster-wide drop_remainder);
      * mode="eval": run until EVERY rank is dry; a dry rank feeds fully
        padded dummy batches, whose rows the eval gather drops, so no
        real example is lost.

    Under tensor parallelism (`mesh.model` > 1) the ranks of a model group
    must step on the same rows, and a loader's order is not reproducible
    across processes (its reader threads race unless
    `--deterministic_input`). So only the group's first rank (model index
    0) reads `loader`; it broadcasts each batch over the model group, and
    the group's other ranks yield the batches it sent. One process: a
    passthrough."""
    if mode not in ("train", "eval"):
        raise ValueError(f"mode must be 'train' or 'eval', got {mode!r}")
    if world_size() == 1:
        yield from loader
        return
    op = dist.ReduceOp.MIN if mode == "train" else dist.ReduceOp.MAX
    group = mesh.model_group if mesh is not None and mesh.model > 1 else None
    reader = group is None or mesh.model_index == 0
    # a rank that does not read adds the reduction's neutral value
    idle = 1 if mode == "train" else 0
    it = iter(loader) if reader else None
    while True:
        batch = next(it, None) if reader else None
        flag = torch.tensor([int(batch is not None) if reader else idle],
                            dtype=torch.int32)
        dist.all_reduce(flag, op=op, group=_HOST_GROUP)
        if not int(flag):
            return
        if group is not None:
            box = [batch]
            dist.broadcast_object_list(box, src=mesh.rank - mesh.model_index,
                                       group=group)
            batch = box[0]
        yield _dummy_batch(loader) if batch is None else batch


def scatter_batches(loader, mesh=None):
    """The batches of `loader`, which reads GLOBAL batches, cut to this
    rank's rows in one process's row order: rank 0 alone reads, each
    batch is broadcast over the world, and each rank yields its data
    index's slice of the rows with its share of the padding (the global
    batch pads at its end). `video_ids` of a yielded batch are the GLOBAL
    batch's valid ids, the rows that `gather_eval_rows` of every rank's
    outputs gives back in order. A dry stream ends every rank together.
    One process: each batch whole, `video_ids` cut to its valid rows."""
    if world_size() == 1:
        for batch in loader:
            yield dataclasses.replace(
                batch, video_ids=batch.video_ids[:len(batch.video_ids) - batch.pad])
        return
    data = mesh.data if mesh is not None else world_size()
    index = mesh.data_index if mesh is not None else rank()
    it = iter(loader) if rank() == 0 else None
    rows_of = ("features", "labels", "num_frames")
    while True:
        box = [next(it, None) if it is not None else None]
        dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
        batch = box[0]
        if batch is None:
            return
        rows = len(batch.video_ids)
        if rows % data:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{data} data-parallel ranks")
        b = rows // data
        lo, valid = index * b, rows - batch.pad
        # an aggregated batch's num_frames is a property of its rows
        cut = {f.name: getattr(batch, f.name)[lo:lo + b]
               for f in dataclasses.fields(batch) if f.name in rows_of}
        yield dataclasses.replace(batch, video_ids=batch.video_ids[:valid],
                                  pad=b - min(b, max(0, valid - lo)), **cut)


def all_ranks_agree(value: bool) -> bool:
    """True on every rank when `value` holds on every rank. One process:
    `value`."""
    if world_size() == 1:
        return value
    flag = torch.tensor([1 if value else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=_HOST_GROUP)
    return bool(int(flag))


def broadcast_flag(value: bool) -> bool:
    """The MASTER's boolean decision on every rank: wall-clock triggers
    (save_model_secs, save_summaries_secs) must fire on every rank in the
    same step. One process: a passthrough."""
    if world_size() == 1:
        return value
    flag = torch.tensor([1 if value else 0], dtype=torch.int32)
    dist.broadcast(flag, src=0, group=_HOST_GROUP)
    return bool(int(flag))


_TOO_LONG = b"\x01TOO_LONG"


def broadcast_str(value: Optional[str], max_len: int = 1024) -> Optional[str]:
    """A (possibly None) string from the master on every rank: the
    checkpoint to resume or evaluate, so every rank restores the same
    one. A string longer than `max_len` raises on every rank together.
    One process: a passthrough."""
    if world_size() == 1:
        return value
    buf = torch.zeros(max_len, dtype=torch.uint8)
    if is_master() and value:
        raw = value.encode("utf-8")
        if len(raw) > max_len:
            raw = _TOO_LONG  # raising here would strand the other ranks
        buf[: len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=_HOST_GROUP)
    raw = bytes(buf[buf != 0].numpy())
    if raw == _TOO_LONG:
        raise ValueError(f"broadcast string longer than {max_len} bytes")
    return raw.decode("utf-8") if raw else None


def all_gather_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Each array of every rank, concatenated along axis 0 in rank order,
    in ONE collective on the host group. The ranks' arrays must agree in
    names, shapes and dtypes."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    raw = np.concatenate([v.reshape(-1).view(np.uint8) for v in arrays.values()])
    parts = [torch.empty(raw.size, dtype=torch.uint8) for _ in range(world_size())]
    dist.all_gather(parts, torch.from_numpy(raw), group=_HOST_GROUP)
    out: Dict[str, list] = {k: [] for k in arrays}
    for part in parts:
        buf, offset = part.numpy(), 0
        for key, value in arrays.items():
            out[key].append(buf[offset:offset + value.nbytes].view(value.dtype)
                            .reshape(value.shape))
            offset += value.nbytes
    return {k: np.concatenate(v) for k, v in out.items()}


def gather_eval_rows(arrays: Dict[str, Any], pad: int, model: int = 1
                     ) -> Tuple[Dict[str, np.ndarray], int]:
    """The GLOBAL eval rows of one step: every data index's valid rows
    (its batch without its `pad` trailing padding rows) in rank order, so
    the epoch metrics (GAP's global top-k heap in particular) see the
    stream a single process would, and the summed pad. The pad counts
    ride in the same collective as the rows. Under tensor parallelism
    (`model` > 1) the ranks of a model group hold the same rows (the
    batches `sync_host_streams` broadcast), and those of its first rank
    are kept. One process: the rows without the padding."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    if world_size() == 1:
        if pad:
            arrays = {k: v[: v.shape[0] - pad] for k, v in arrays.items()}
        return arrays, pad
    block = next(iter(arrays.values())).shape[0]
    gathered = all_gather_arrays(
        dict(arrays, __pad__=np.asarray([pad], np.int32)))
    pads = gathered.pop("__pad__")
    ranks = range(0, len(pads), model)
    keep = np.concatenate([np.arange(p * block, (p + 1) * block - int(pads[p]))
                           for p in ranks])
    return ({k: v[keep] for k, v in gathered.items()},
            int(sum(int(pads[p]) for p in ranks)))


def _paired_k(m: int):
    """The k with k + ceil(k/2) == m (the paired-index pack's index+value
    lane count), or None. At most one k matches."""
    k = (2 * m) // 3
    for cand in (k, k + 1):
        if cand > 0 and cand + (cand + 1) // 2 == m:
            return cand
    return None


def unpack_host_pack(pack: np.ndarray, labels) -> Dict[str, Any]:
    """Split one packed eval buffer (train/step.py:_pack_host_outputs)
    back into its fields, as the JAX package's `unpack_host_pack` does.
    Self-describing across the two layouts:
      * paired: [B, k + ceil(k/2) + 2], two indices per f32 lane, sign bit
        set (a wide pack's index lanes are non-negative floats);
      * wide: [B, 2k + 2], one float-encoded index per lane."""
    m = pack.shape[1] - 2
    k = _paired_k(m)
    if k is not None:
        h = (k + 1) // 2
        words = np.ascontiguousarray(pack[:, k:k + h]).view(np.int32)
        if words.size and words[0, 0] >= 0:
            k = None  # a wide pack whose lane count aliases a paired one
        else:
            words = words & np.int32(0x3FFFFFFF)  # drop the marker bits
            idx = np.empty((pack.shape[0], 2 * h), np.int32)
            idx[:, 0::2] = words & 0xFFFF
            idx[:, 1::2] = words >> 16
            idx = idx[:, :k]
    if k is None:
        k = m // 2
        idx = pack[:, k:2 * k].astype(np.int32)
    return {
        "topk_val": pack[:, :k],
        "topk_idx": idx,
        "per_example_loss": pack[:, m],
        "perr_precision": pack[:, m + 1],
        "labels": labels,
    }


def gather_step_outputs(out: Dict[str, Any], labels, pad: int,
                        model: int = 1) -> Dict[str, np.ndarray]:
    """The eval binaries' per-batch assembly: the step's packed host
    bundle crosses to the host in ONE transfer, is unpacked, and every
    data index's valid rows are gathered (`gather_eval_rows`)."""
    pack = out["host_pack"].cpu().numpy()
    rows, _ = gather_eval_rows(unpack_host_pack(pack, labels), pad, model)
    return rows
