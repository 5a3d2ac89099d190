"""Parameter bridge between the JAX package's pytrees and the port's
modules.

The port's modules keep the JAX layouts (LSTM ``kernel [D+H, 4H]``,
``bias [4H]``; MoE ``gates.w [D, m+1, V]``, ...) and name their
parameters after the pytree paths, so the bridge is a name map with no
transposes: ``params["rnn_l1"][0]["kernel"]`` is ``rnn_l1.0.kernel``.
A tree is a nested dict/list of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from efficientvideoclassification_youtube8m_torch.ops.quantize import int_mm_layout


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for index, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}{index}.")
    else:
        yield prefix[:-1], tree


def load_jax_params(model: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX parameter tree into `model` in place (values are cast
    to each parameter's dtype and moved to its device). Raises KeyError
    on missing or unexpected names and ValueError on a shape mismatch,
    before anything is copied. Returns `model`."""
    flat: Dict[str, np.ndarray] = {
        name: np.asarray(value) for name, value in _flatten(tree)}
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, value in flat.items():
        if tuple(value.shape) != tuple(state[name].shape):
            raise ValueError(f"{name}: tree has shape {value.shape}, the "
                             f"module {tuple(state[name].shape)}")
    with torch.no_grad():
        for name, value in flat.items():
            # in the tree's own dtype; copy_ casts once, to the parameter's
            state[name].copy_(torch.from_numpy(np.array(value)))
    return model


_QUANTIZED_CELL = ("wx_q", "wx_scale", "wh_q", "wh_scale", "bias")
_QUANTIZED_MOE = ("gates_q", "gates_scale", "experts_q", "experts_scale",
                  "experts_b")


def load_jax_quantized_params(tree: Any, device="cpu") -> Dict[str, Any]:
    """The JAX package's `ops.quantize.quantize_hierarchical_params` tree
    (numpy leaves) as the port's quantized parameters, the layout that
    `ops.quantize.quantize_hierarchical_params` returns: ``{"rnn_l1":
    [cell, ...], "rnn_l2": [...], "classifier": {...}}`` with int8 ``*_q``
    leaves (in `int_mm_layout`, but for the kernel's row-major ``wh_q``)
    and float32 scales and biases, on `device`. Values are copied bit for
    bit. Raises KeyError on missing or unexpected names and
    TypeError on a leaf of another dtype."""

    def group(node: Any, keys, where: str) -> Dict[str, torch.Tensor]:
        if set(node) != set(keys):
            raise KeyError(f"{where}: names {sorted(node)}, expected {sorted(keys)}")
        out = {}
        for key in keys:
            value = np.asarray(node[key])
            want = np.int8 if key.endswith("_q") else np.float32
            if value.dtype != want:
                raise TypeError(f"{where}.{key} is {value.dtype}, not {np.dtype(want)}")
            out[key] = torch.from_numpy(np.array(value)).to(device)
            if key != "wh_q" and key.endswith("_q"):
                out[key] = int_mm_layout(out[key])
        return out

    if set(tree) != {"rnn_l1", "rnn_l2", "classifier"}:
        raise KeyError(f"names {sorted(tree)}, expected classifier, rnn_l1, rnn_l2")
    return {
        **{level: [group(cell, _QUANTIZED_CELL, f"{level}.{i}")
                   for i, cell in enumerate(tree[level])]
           for level in ("rnn_l1", "rnn_l2")},
        "classifier": group(tree["classifier"], _QUANTIZED_MOE, "classifier"),
    }


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(key.isdigit() for key in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {key: _lists(value) for key, value in node.items()}


def to_jax_params(model: nn.Module) -> Any:
    """The reverse of `load_jax_params`: `model`'s parameters as a nested
    dict/list of float32 numpy arrays in the JAX pytree layout."""
    tree: Dict[str, Any] = {}
    for name, tensor in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = tensor.detach().to("cpu", torch.float32).numpy().copy()
    return _lists(tree)
