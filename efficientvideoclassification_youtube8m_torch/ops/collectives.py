"""The collectives of the parallel steps, over `torch.distributed`:
the leaf that the models, the train steps and `parallel/` share, with no
import of the package (the parallel layer's steps import the models and
the train steps, which use these).

  * `all_reduce_grads`: ONE summed all-reduce of a step's gradients over
    the data group, coalesced into buckets of `BUCKET_BYTES`;
  * `reduce_scalars`, `mean_tensors`: the reported scalars and DBoF's
    moving statistics over the data group;
  * `all_reduce_sum`: a differentiable all-reduce whose backward sums
    the gradient over the ranks (the ranks' losses differ), for synced
    batch-norm moments;
  * `copy_to_model`, `gather_columns`, `reduce_from_model`: the
    tensor-parallel collectives over a module's `ModelShards` (the layout
    `parallel.mesh.shard_module` records). Every rank of a model group
    computes the same loss on the same rows, so `gather_columns` keeps
    this rank's slice of the gradient and `reduce_from_model` passes it
    through; `copy_to_model` sums the input gradient of a column-parallel
    layer, of which each rank's columns give a part;
  * `gather_leaf`, `apply_gathered`: a sharded leaf made whole, for a
    checkpoint or for a forward that reads it whole.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


# bytes of gradient per all-reduce: large enough that the launches are
# few (the flagship's 2 x 572 MB of gradients go in 18), small enough
# that the flat copy stays a small part of device memory
BUCKET_BYTES = 64 * 2**20


@dataclasses.dataclass(frozen=True)
class ModelShards:
    """A module's tensor-parallel layout: the model group, its size, this
    rank's index in it, and the names (relative to the module) of the
    parameters that hold only this rank's columns."""

    group: object
    size: int
    index: int
    names: FrozenSet[str]  # a collective over them goes in sorted order

    def local(self, x):
        """This rank's columns of a whole tensor or array (a view)."""
        w = x.shape[-1] // self.size
        return x[..., self.index * w:(self.index + 1) * w]


# the heads that compute their own classes and gather the predictions
# (models/video_level.py, models/frame_level.py set this)
COLUMN_PARALLEL_ATTR = "column_parallel"


def _all_gather_last(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def gather_leaf(x: torch.Tensor, shards: Optional[ModelShards], name: str
                ) -> torch.Tensor:
    """The whole tensor of the leaf `name` (a parameter or a slot of it):
    its columns from every rank of the model group, or `x` itself where
    the leaf is not sharded. A collective of the model group."""
    if shards is None or name not in shards.names:
        return x
    return _all_gather_last(x.detach(), shards.group, shards.size)


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


class _GatherColumns(torch.autograd.Function):
    """y = the ranks' x side by side along the last dim, in rank order;
    the backward keeps this rank's columns of the incoming gradient (every
    rank computes the same loss from y, so nothing is summed)."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.width, ctx.index = x.shape[-1], index
        return _all_gather_last(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        local = grad.narrow(-1, ctx.index * ctx.width, ctx.width)
        return local.contiguous(), None, None, None


def gather_columns(x: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """A differentiable all-gather of `x` along its last dim over the
    model group of `shards`."""
    return _GatherColumns.apply(x, shards.group, shards.size, shards.index)


class _ReduceFromModel(torch.autograd.Function):
    """y = sum over the model group of x; the backward is the identity
    (every rank computes the same loss from y)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """y = x (the same on every rank of the model group); the backward
    sums the incoming gradient over the group: each rank's columns give
    only their own share of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_model(x: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """The input of a column-parallel layer: itself in the forward, its
    gradient summed over the model group of `shards` in the backward."""
    return _CopyToModel.apply(x, shards.group)


def reduce_from_model(x: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """A differentiable sum of `x` over the model group of `shards`, e.g.
    the l2 term of a column-parallel head's local weights."""
    return _ReduceFromModel.apply(x, shards.group)


def apply_gathered(module: nn.Module, *args, **kwargs):
    """`module(*args, **kwargs)` with each sharded parameter that no
    column-parallel head owns gathered where the forward reads it (the
    GSPMD placement of the JAX package's tensor-parallel step): the
    forward sees the whole tensor, and the backward brings the gradient of
    this rank's columns back to its shard. A sharded column-parallel head
    computes its own classes. Unsharded modules are called as they are."""
    shards = getattr(module, "model_shards", None)
    if shards is None or getattr(module, COLUMN_PARALLEL_ATTR, False):
        return module(*args, **kwargs)
    owned = set()
    for prefix, sub in module.named_modules():
        if sub is not module and "model_shards" in sub.__dict__:
            owned.update(f"{prefix}.{n}" for n in sub.model_shards.names)
    params = dict(module.named_parameters())
    whole = {n: gather_columns(params[n], shards)
             for n in sorted(shards.names - owned)}
    if not whole:
        return module(*args, **kwargs)
    return torch.func.functional_call(module, whole, args, kwargs)
