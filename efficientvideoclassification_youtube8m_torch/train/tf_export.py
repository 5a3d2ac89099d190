"""Export the port's states as reference TF-V2 checkpoints (port of the
JAX package's train/tf_export.py).

The inverse of `train/tf_import.py`: a model trained here becomes a
`model.ckpt-<step>` Saver-V2 bundle that the reference's TF1 binaries
consume directly (`tf.train.Saver` restores by the variable names the
reference graphs create, `validate.py:350-381`,
`train_convert_model.py:501-513`). The MoE weights go back from the
`[D, K, V]` storage to the reference's class-interleaved `[D, V*K]`
columns, and the Adam moments export as `<var>/Adam` / `<var>/Adam_1`
with `beta{1,2}_power` from the optimizer's step count, so reference
training can resume from the bundle. For the same tree the bundle is
byte for byte the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from efficientvideoclassification_youtube8m_torch.data.tf_checkpoint import (
    write_tf_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    state_tree,
)
from efficientvideoclassification_youtube8m_torch.train.tf_import import (
    _ADAM_B1,
    SCOPES,
    _name_tree,
    name_leaves,
)

_ADAM_B2 = 0.999


def _host_f32(leaf: Any) -> np.ndarray:
    """A leaf as a float32 host array: the reference graphs are float32
    throughout."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(torch.float32).cpu().numpy()
    return np.asarray(leaf, np.float32)


def _dump_tree(name_tree: Any, params: Any, out: Dict[str, np.ndarray],
               suffix: str = "") -> None:
    for _, (tf_name, _, to_tf), leaf in name_leaves(name_tree, params):
        out[tf_name + suffix] = np.asarray(to_tf(_host_f32(leaf)))


def _dump_optimizer(name_tree: Any, slots: Any, ordinal: int,
                    out: Dict[str, np.ndarray]) -> None:
    """Adam slots + power variables of one tower's optimizer. `ordinal`
    follows the reference's optimizer creation order: the distill graph
    builds the teacher's first (`beta1_power`), the student's second
    (`beta1_power_1`); a finetune graph has one optimizer (ordinal 0).
    Other optimizers' slots have no reference counterpart and are not
    written."""
    if not (isinstance(slots, dict) and {"mu", "nu"} <= set(slots)):
        return
    _dump_tree(name_tree, slots["mu"], out, "/Adam")
    _dump_tree(name_tree, slots["nu"], out, "/Adam_1")
    # TF1 Adam stores b^(t+1) after t updates (initialized to b,
    # multiplied after each apply): the factor its NEXT apply uses. b^t
    # would give a fresh state power 1.0 and NaN TF's bias correction
    # (division by 1 - beta1_power).
    t = int(slots["count"])
    sfx = "" if ordinal == 0 else f"_{ordinal}"
    out[f"beta1_power{sfx}"] = np.float32(_ADAM_B1 ** (t + 1))
    out[f"beta2_power{sfx}"] = np.float32(_ADAM_B2 ** (t + 1))


def _export(prefix: str, state, ordinals: Dict[str, int]) -> str:
    tree = state_tree(state)
    tensors: Dict[str, np.ndarray] = {}
    names = {tower: _name_tree(SCOPES[tower], tree[f"params_{tower}"])
             for tower in ordinals}
    for tower in ordinals:
        _dump_tree(names[tower], tree[f"params_{tower}"], tensors)
    for tower, ordinal in ordinals.items():
        _dump_optimizer(names[tower], tree[f"opt_{tower}"], ordinal, tensors)
    tensors["global_step"] = np.asarray(int(state.global_step), np.int32)
    return write_tf_checkpoint(prefix, tensors)


def export_distill_state(prefix: str, state: DistillState) -> str:
    """DistillState -> reference distillation checkpoint: both towers'
    parameters under the scopes `model` / `model_student`, Adam slots,
    int32 global_step (train.py:222)."""
    return _export(prefix, state, {"teacher": 0, "student": 1})


def export_student_state(prefix: str, state) -> str:
    """StudentState -> reference finetune checkpoint: the student scope
    only, one optimizer, so its power variables are unsuffixed."""
    return _export(prefix, state, {"student": 0})


def export_tf_checkpoint(prefix: str, state) -> str:
    """Dispatch on the state type (DistillState or StudentState)."""
    if isinstance(state, DistillState):
        return export_distill_state(prefix, state)
    return export_student_state(prefix, state)
