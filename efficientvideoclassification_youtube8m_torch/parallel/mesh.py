"""The data-parallel mesh and its collectives (the counterpart of the JAX
package's parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model") mesh and
lets GSPMD or shard_map place the collectives. The port runs one process
per device, so its mesh is the process group: this rank, the number of
ranks and the rank's device. Every parallel step is a per-device program
with explicit collectives, the shard_map recipe:

  * `all_reduce_grads`: ONE summed all-reduce of a step's gradients,
    coalesced into buckets of `BUCKET_BYTES`;
  * `reduce_scalars`: the reported scalars in one all-reduce, averaged
    or summed;
  * `all_reduce_sum`: a differentiable all-reduce (its backward sums the
    gradient over the ranks), for synced batch-norm moments.

The column-sharded MoE head (`model > 1`) is not ported.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# bytes of gradient per all-reduce: large enough that the launches are
# few (the flagship's 2 x 572 MB of gradients go in 18), small enough
# that the flat copy stays a small part of device memory
BUCKET_BYTES = 64 * 2**20


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel mesh. `group` is None for a
    single process that joined no group: the steps are then the plain
    single-device steps."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world_size, MODEL_AXIS: 1}


def create_mesh(model: int = 1, device=None) -> Mesh:
    """The data-parallel mesh of the process group `initialize()` joined
    (a mesh of one without a group). `model > 1` (tensor parallelism)
    raises."""
    if model < 1:
        raise ValueError(f"model parallelism must be >= 1, got {model}")
    if model > 1:
        raise NotImplementedError(
            "--model_parallelism > 1 (the column-sharded MoE head) is not "
            "ported yet (ROADMAP Queue 1, the tensor-parallel MoE head)")
    device = torch.device("cpu") if device is None else torch.device(device)
    if not dist.is_initialized():
        return Mesh(group=None, rank=0, world_size=1, device=device)
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                world_size=dist.get_world_size(), device=device)


def _buckets(tensors: Iterable[torch.Tensor], limit: int
             ) -> List[List[torch.Tensor]]:
    """Consecutive runs of tensors of one dtype and device, each run at
    most `limit` bytes (a larger tensor goes alone)."""
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        last = buckets[-1] if buckets else None
        if (last is None or last[0].dtype != t.dtype
                or last[0].device != t.device
                or size + t.numel() * t.element_size() > limit):
            buckets.append([t])
            size = 0
        else:
            last.append(t)
        size += t.numel() * t.element_size()
    return buckets


def all_reduce_grads(grads: Sequence[Dict[str, torch.Tensor]], group,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum every gradient over the ranks of `group`, in place: each
    bucket is flattened into one buffer, all-reduced, and copied back."""
    tensors = [g for d in grads for g in d.values()]
    for bucket in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def reduce_scalars(scalars: Dict[str, torch.Tensor], group,
                   summed: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """The scalars averaged over the ranks (those in `summed` summed), in
    one all-reduce."""
    keys = list(scalars)
    dtype = functools.reduce(torch.promote_types, (scalars[k].dtype for k in keys))
    stacked = torch.stack([scalars[k].to(dtype).reshape(()) for k in keys])
    dist.all_reduce(stacked, group=group)
    n = dist.get_world_size(group)
    return {k: stacked[i] if k in summed else stacked[i] / n
            for i, k in enumerate(keys)}


def mean_tensors(tensors: Optional[Dict[str, torch.Tensor]], group
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """The tensors averaged over the ranks (one all-reduce), e.g. the
    batch-norm moving statistics each rank computed."""
    if not tensors:
        return tensors
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1) for k in keys])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    out, offset = {}, 0
    for k in keys:
        n = tensors[k].numel()
        out[k] = flat[offset:offset + n].view_as(tensors[k])
        offset += n
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x; the backward sums the incoming
    gradient over the ranks, the derivative of the ranks' summed loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A differentiable sum of `x` over the ranks of `group`."""
    return _AllReduceSum.apply(x, group)
