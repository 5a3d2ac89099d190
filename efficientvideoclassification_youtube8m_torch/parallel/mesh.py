"""The ("data", "model") mesh and the tensor-parallel column rule (the
counterpart of the JAX package's parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model") mesh and
lets GSPMD or shard_map place the collectives. The port runs one process
per device, so its mesh is a layout of the process group's ranks, as
JAX's ``np.asarray(devices).reshape(data, model)``: rank r has data index
``r // model`` and model index ``r % model``. The ranks of one data index
form a model group, those of one model index a data group. Every parallel
step is a per-device program with explicit collectives (`ops.collectives`).

Tensor parallelism (`model > 1`) is the JAX column rule (`_tp_spec`):
a parameter or optimizer slot whose last dim is at least `min_dim` and
divides by the model size holds only this rank's columns (`shard_state`).
The column-parallel heads (MoE, logistic, frame-level logistic) compute
their own classes and gather the predictions; every other sharded leaf
is gathered where the forward uses it (`ops.collectives.apply_gathered`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from efficientvideoclassification_youtube8m_torch.ops.collectives import (
    COLUMN_PARALLEL_ATTR,
    ModelShards,
    gather_leaf,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the JAX rule's default: the MoE columns (vocab 4716) shard, the LSTM
# kernels (4 x 1024 = 4096) replicate
MIN_DIM = 4200


def default_device() -> torch.device:
    """The rank's CUDA device: LOCAL_RANK's card (0 without a launcher),
    as `cli.flags.resolve_device` reads it. Raises where CUDA is not
    available: nothing falls back to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the ("data", "model") mesh. `group` is the data
    group (the gradients' and the reported scalars'), None for a single
    process that joined no group: the steps are then the plain
    single-device steps. `model_group` is None when model == 1."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device
    data: int = 1
    model: int = 1
    model_group: Optional[object] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def create_mesh(data: Optional[int] = None, model: int = 1,
                device=None) -> Mesh:
    """The ("data", "model") mesh of the process group `initialize()`
    joined (a group of one process without it). With `data=None` the
    ranks left over go to the data axis. A world size that `model` does
    not divide, or a `data * model` other than it, raises ValueError, as
    the JAX `create_mesh` does. `device` defaults to the rank's CUDA
    device (`default_device`).

    Every rank builds every data and model group, in the same order:
    `dist.new_group` is a collective of the whole world."""
    if model < 1:
        raise ValueError(f"model parallelism must be >= 1, got {model}")
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    device = default_device() if device is None else torch.device(device)
    if not dist.is_initialized():
        return Mesh(group=None, rank=0, world_size=1, device=device)
    rank = dist.get_rank()
    if model == 1:
        return Mesh(group=dist.group.WORLD, rank=rank, world_size=n,
                    device=device, data=data)
    data_group = model_group = None
    for j in range(model):
        g = dist.new_group([i * model + j for i in range(data)])
        if rank % model == j:
            data_group = g
    for i in range(data):
        g = dist.new_group([i * model + j for j in range(model)])
        if rank // model == i:
            model_group = g
    return Mesh(group=data_group, rank=rank, world_size=n, device=device,
                data=data, model=model, model_group=model_group)


# ------------------------------------------------ the column rule


def _is_tp_shardable(x, model_size: int, min_dim: int) -> bool:
    shape = tuple(getattr(x, "shape", ()))
    if not shape:
        return False
    d = shape[-1]
    return d >= min_dim and d % model_size == 0


def _tp_spec(x, model_size: int, min_dim: int) -> tuple:
    """The column-sharding rule, in ONE place: wide, model-divisible
    last dims shard over "model"; everything else replicates. A spec is
    the tuple of a JAX PartitionSpec: () or (None, ..., "model")."""
    if model_size > 1 and _is_tp_shardable(x, model_size, min_dim):
        return (None,) * (len(x.shape) - 1) + (MODEL_AXIS,)
    return ()


def _map_tree(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_params_specs(params: Any, model_size: int, min_dim: int = MIN_DIM) -> Any:
    """The spec of every leaf of a parameter tree (nested dicts, or a
    module's `state_dict` keys): kernels and their biases whose LAST dim
    is wide (>= min_dim) and divisible by the model size are
    column-sharded (the MoE gates and experts, last dim vocab 4716);
    everything else, the LSTM kernels (last dim 4 x 1024 = 4096) and the
    hidden layers, replicates. With model_size == 1 everything
    replicates."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    return _map_tree(lambda x: _tp_spec(x, model_size, min_dim), params)


def shard_state_specs(state: Any, model_size: int, min_dim: int = MIN_DIM) -> Any:
    """The specs of a whole (unsharded) DistillState/StudentState in the
    JAX state-tree layout (`train.state.state_tree`): parameters and
    their optimizer slots by the column rule, counters replicated."""
    from efficientvideoclassification_youtube8m_torch.train.state import (
        DistillState,
        StudentState,
        state_tree,
    )

    if isinstance(state, (DistillState, StudentState)):
        state = state_tree(state)
    return _map_tree(lambda x: _tp_spec(x, model_size, min_dim), state)



def _tower_shards(module: nn.Module, mesh: Mesh, min_dim: int) -> ModelShards:
    names = frozenset(n for n, p in module.named_parameters()
                      if _is_tp_shardable(p, mesh.model, min_dim))
    return ModelShards(mesh.model_group, mesh.model, mesh.model_index, names)


def shard_module(module: nn.Module, mesh: Mesh, min_dim: int = MIN_DIM
                 ) -> Optional[ModelShards]:
    """Keep only this rank's columns of every parameter the rule shards,
    in place, and record the layout on the module (`model_shards`) and on
    each column-parallel head that owns sharded parameters. A no-op
    (None) on a mesh with model == 1."""
    if mesh.model == 1:
        return None
    if getattr(module, "model_shards", None) is not None:
        raise ValueError("the module is sharded already")
    shards = _tower_shards(module, mesh, min_dim)
    for name in sorted(shards.names):
        _replace_parameter(module, name, shards.local(module.get_parameter(name)))
    module.model_shards = shards
    for prefix, sub in module.named_modules():
        if sub is module or not getattr(sub, COLUMN_PARALLEL_ATTR, False):
            continue
        own = frozenset(n[len(prefix) + 1:] for n in shards.names
                        if n.startswith(prefix + "."))
        if own:
            sub.model_shards = dataclasses.replace(shards, names=own)
    return shards


def _replace_parameter(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """A new parameter of `value`'s shape in place of `name` (assigning
    `.data` of another shape would leave autograd the old shape)."""
    owner, _, leaf = name.rpartition(".")
    sub = module.get_submodule(owner) if owner else module
    old = getattr(sub, leaf)
    setattr(sub, leaf, nn.Parameter(value.detach().clone(),
                                    requires_grad=old.requires_grad))


def _slice_slots(slots: dict, shards: Optional[ModelShards]) -> dict:
    if shards is None:
        return slots
    return {key: ({n: shards.local(t).clone() if n in shards.names else t
                   for n, t in value.items()} if isinstance(value, dict) else value)
            for key, value in slots.items()}


def shard_state(state, mesh: Mesh, min_dim: int = MIN_DIM):
    """Shard a whole DistillState/StudentState in place for `mesh`: each
    tower's parameters (`shard_module`) and their optimizer slots keep
    this rank's columns. Returns the state. A no-op with model == 1."""
    for tower in ("teacher", "student"):
        module = getattr(state, tower, None)
        if module is None or (tower == "teacher" and module is state.student):
            continue
        shards = shard_module(module, mesh, min_dim)
        slots = f"opt_{tower}"
        setattr(state, slots, _slice_slots(getattr(state, slots), shards))
    return state


def gather_state(state):
    """The inverse of `shard_state`, in place: every sharded parameter and
    slot made whole again on every rank, and the layout dropped."""
    for tower in ("teacher", "student"):
        module = getattr(state, tower, None)
        shards = getattr(module, "model_shards", None)
        if shards is None:
            continue
        for name in sorted(shards.names):  # every rank in one order
            _replace_parameter(module, name,
                               gather_leaf(module.get_parameter(name), shards, name))
        for sub in module.modules():
            if "model_shards" in sub.__dict__:
                del sub.model_shards
        slots = getattr(state, f"opt_{tower}")
        setattr(state, f"opt_{tower}", {
            key: ({n: gather_leaf(t, shards, n) for n, t in value.items()}
                  if isinstance(value, dict) else value)
            for key, value in slots.items()})
    return state
