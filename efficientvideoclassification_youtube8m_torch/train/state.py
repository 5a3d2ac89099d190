"""Training state (port of the JAX package's train/state.py).

The JAX pytree of parameters, optimizer slots and the shared global
step becomes a dataclass holding the two towers' `nn.Module`s, their
optimizer slots (dicts of tensors keyed by parameter name, plus Adam's
count), the global step (a Python int) and the dropout keep-prob. The
train steps update it in place. `state_tree` and `load_state_tree` map
it to and from the JAX state tree that checkpoints hold.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.train.optimizer import Optimizer
from efficientvideoclassification_youtube8m_torch.weights import load_jax_params
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig


def init_model(cfg: TrainConfig, key: Optional[prng.Key] = None,
               device=None) -> nn.Module:
    """`cfg.model` at the config's sizes, with the weights the JAX
    `model.init(key, ...)` draws (key (0, 0) when None)."""
    return get_model(cfg.model)(
        cfg.total_feature_size, cfg.num_classes,
        lstm_cells=cfg.lstm_cells, lstm_layers=cfg.lstm_layers,
        classifier=cfg.video_level_classifier_model,
        classifier_kwargs={"num_mixtures": cfg.moe_num_mixtures},
        key=key, device=device,
    )


def params_of(module: nn.Module) -> dict:
    """The module's parameters by name: what the optimizer updates."""
    return dict(module.named_parameters())


@dataclasses.dataclass
class DistillState:
    """Teacher + student joint training state (cli train.py)."""

    teacher: nn.Module
    student: nn.Module
    opt_teacher: dict
    opt_student: dict
    global_step: int  # shared, advances 2 per batch in faithful mode
    dropout_keep_prob: float  # the reference's dropout_var


@dataclasses.dataclass
class StudentState:
    """Student-only state (finetune)."""

    student: nn.Module
    opt_student: dict
    global_step: int
    dropout_keep_prob: float


def init_distill_state(cfg: TrainConfig, optimizer: Optimizer,
                       key: Optional[prng.Key] = None,
                       device=None) -> DistillState:
    """The JAX `init_distill_state`: teacher and student drawn from the
    two halves of `split(key)` (`PRNGKey(cfg.seed)` when None), so a seed
    gives both packages the same weights; zero optimizer slots, step 0."""
    kt, ks = prng.split(key or prng.prng_key(cfg.seed))
    teacher = init_model(cfg, kt, device)
    student = init_model(cfg, ks, device)
    return DistillState(
        teacher=teacher,
        student=student,
        opt_teacher=optimizer.init(params_of(teacher)),
        opt_student=optimizer.init(params_of(student)),
        global_step=0,
        dropout_keep_prob=cfg.dropout,
    )


def student_state_from_distill(state: DistillState, optimizer: Optimizer
                               ) -> StudentState:
    """The convert step (train_convert_model.py:360-401): keep the
    student, drop the teacher, and start the finetune phase from fresh
    optimizer slots and step 0."""
    return StudentState(
        student=state.student,
        opt_student=optimizer.init(params_of(state.student)),
        global_step=0,
        dropout_keep_prob=state.dropout_keep_prob,
    )


# ------------------------------------------------ the JAX state tree
#
# A JAX checkpoint holds `flax.serialization.to_state_dict` of the JAX
# DistillState / StudentState: a map of the fields below, list nodes as
# maps keyed "0", "1", ..., and 0-d arrays for the scalars. The optimizer
# slots are the JAX optimizers' trees (train/optimizer.py of the JAX
# package): TF-Adam {count, mu, nu}, RMSProp {ms, mom}, the bare
# accumulator tree for Momentum and Adagrad, {} for plain SGD.

_TOWERS = {DistillState: ("teacher", "student"), StudentState: ("student",)}


def _nest(named) -> dict:
    """{"rnn_l1.0.kernel": x, ...} -> {"rnn_l1": {"0": {"kernel": x}}}."""
    tree: dict = {}
    for name, value in named:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _slots_tree(slots: dict) -> dict:
    tree = {key: (np.asarray(value, np.int32) if key == "count"
                  else _nest(value.items()))
            for key, value in slots.items()}
    # the JAX Momentum and Adagrad slots are the bare accumulator tree
    return tree["accum"] if set(tree) == {"accum"} else tree


def state_tree(state) -> dict:
    """`state` in the JAX state-dict layout: parameters and optimizer
    slots as the state's own tensors (detached, not copied; the writer
    converts them to float32 host arrays), the scalars as 0-d numpy
    arrays of the JAX dtypes. Parameter names are `model.state_dict()`'s,
    as in `weights.to_jax_params`."""
    towers = _TOWERS[type(state)]
    tree = {f"params_{t}": _nest((name, value.detach()) for name, value
                                 in getattr(state, t).state_dict().items())
            for t in towers}
    tree.update({f"opt_{t}": _slots_tree(getattr(state, f"opt_{t}"))
                 for t in towers})
    tree["global_step"] = np.asarray(state.global_step, np.int32)
    tree["dropout_keep_prob"] = np.asarray(state.dropout_keep_prob, np.float32)
    return tree


def _check_tree(want: Any, got: Any, path: str) -> None:
    """Raise KeyError on a missing or unexpected name and ValueError on a
    structure or shape mismatch of `got` against the template `want`."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"{path}: the checkpoint holds a "
                             f"{type(got).__name__}, not a tree")
        missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
        if missing or unexpected:
            raise KeyError(f"{path}: names differ: missing {missing}, "
                           f"unexpected {unexpected}")
        for key in want:
            _check_tree(want[key], got[key], f"{path}/{key}")
        return
    if not isinstance(got, (np.ndarray, np.generic)):
        raise ValueError(f"{path}: the checkpoint holds a "
                         f"{type(got).__name__}, not an array")
    if tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{path}: the checkpoint has shape "
                         f"{tuple(got.shape)}, the state {tuple(want.shape)}")


def load_state_tree(state, tree: dict, fields: Optional[Sequence[str]] = None):
    """Copy a JAX state tree (numpy leaves, as `train.checkpoint` reads it)
    into `state` in place and return it. `fields` restricts the copy to
    those top-level fields (default: all of the state's); other fields of
    the tree are ignored, as flax ignores them. Everything is checked
    before anything is copied: a missing field or name raises KeyError, a
    structure or shape mismatch ValueError."""
    want = state_tree(state)
    fields = list(want) if fields is None else list(fields)
    for field in fields:
        if field not in want:
            raise KeyError(f"a {type(state).__name__} has no field {field!r}")
        if field not in tree:
            raise KeyError(f"the checkpoint has no field {field!r}")
        _check_tree(want[field], tree[field], field)
    with torch.no_grad():
        for field in fields:
            if field.startswith("params_"):
                load_jax_params(getattr(state, field[len("params_"):]), tree[field])
            elif field.startswith("opt_"):
                _load_slots(getattr(state, field), tree[field])
            elif field == "global_step":
                state.global_step = int(tree[field])
            else:
                state.dropout_keep_prob = float(tree[field])
    return state


def _load_slots(slots: dict, tree: dict) -> None:
    if set(slots) == {"accum"}:
        tree = {"accum": tree}
    for key in slots:
        if key == "count":
            slots[key] = int(tree[key])
            continue
        for name, tensor in slots[key].items():
            node = tree[key]
            for part in name.split("."):
                node = node[part]
            tensor.copy_(torch.from_numpy(np.array(node)))
