"""Import reference TF-V2 checkpoints into the port's states (port of the
JAX package's train/tf_import.py).

A model trained with the reference's TF1 code can be served, evaluated or
finetuned here: this module maps the reference's variable names (the
hardcoded Saver maps, `validate.py:350-381`) onto the JAX state-tree
layout of `train.state.state_tree`, permuting the MoE weights from the
reference's class-interleaved columns to the `[D, K, V]` storage
(`models/video_level.py`), and loads the tree through
`train.state.load_state_tree`, which checks names, structure and shapes
before it copies anything.

Name map (teacher scope "model", student scope "model_student"):

  {scope}/RNN_L{1,2}/rnn/multi_rnn_cell/cell_{i}/basic_lstm_cell/kernel
      -> params/rnn_l{1,2}/{i}/kernel        (identity; same
         [in+cells, 4*cells] layout, same i,j,f,o gate order)
  {scope}/classifier/gates/weights   [D, V*(m+1)]
      -> params/classifier/gates/w   [D, m+1, V]
  {scope}/classifier/experts/weights [D, V*m]
      -> params/classifier/experts/w [D, m, V]
  {scope}/classifier/experts/biases  [V*m]
      -> params/classifier/experts/b [m, V]
  global_step -> global_step

DBoF's variables map as `_dbof_name_tree` says. Adam slot variables
(`<var>/Adam`, `<var>/Adam_1`) are imported when present, so training
can resume from a reference checkpoint with its moments; the TF update
count t comes from `beta1_power` = b1^(t+1) (`_adam_count`).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from efficientvideoclassification_youtube8m_torch.data.tf_checkpoint import (
    TFCheckpointReader,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    load_state_tree,
    state_tree,
)

logger = logging.getLogger("tf_import")

_ADAM_B1 = 0.9
SCOPES = {"teacher": "model", "student": "model_student"}


def moe_weights_from_tf(w_tf: np.ndarray, groups: int) -> np.ndarray:
    """[D, V*groups] class-interleaved columns -> [D, groups, V].
    TF column c*groups+k lands at [:, k, c]."""
    d, cols = w_tf.shape
    vocab = cols // groups
    return np.ascontiguousarray(w_tf.reshape(d, vocab, groups).transpose(0, 2, 1))


def moe_bias_from_tf(b_tf: np.ndarray, groups: int) -> np.ndarray:
    """[V*groups] -> [groups, V] with the same column mapping."""
    vocab = b_tf.shape[0] // groups
    return np.ascontiguousarray(b_tf.reshape(vocab, groups).T)


def moe_weights_to_tf(w: np.ndarray) -> np.ndarray:
    """[D, groups, V] -> the reference's [D, V*groups] (inverse map)."""
    d = w.shape[0]
    return np.ascontiguousarray(w.transpose(0, 2, 1).reshape(d, -1))


def moe_bias_to_tf(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b.T.reshape(-1))


Converter = Callable[[np.ndarray], np.ndarray]


def _ident(x: np.ndarray) -> np.ndarray:
    return x


def _is_name_leaf(x) -> bool:
    """Name-tree leaves are (tf_name, from_tf, to_tf) triples."""
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], str)


def _hierarchical_name_tree(scope: str, template: Any) -> Any:
    """A tree shaped like the parameter template (the state tree's
    `params_*` node: cells keyed "0", "1", ...) whose leaves are
    (tf_variable_name, from_tf, to_tf) triples; `to_tf` is what
    train/tf_export.py writes with. Cell and mixture counts come from
    the template, not from flags."""
    tree: Dict[str, Any] = {}
    for level_key, level_num in (("rnn_l1", 1), ("rnn_l2", 2)):
        base = f"{scope}/RNN_L{level_num}/rnn/multi_rnn_cell"
        tree[level_key] = {
            str(i): {
                "kernel": (f"{base}/cell_{i}/basic_lstm_cell/kernel",
                           _ident, _ident),
                "bias": (f"{base}/cell_{i}/basic_lstm_cell/bias",
                         _ident, _ident),
            }
            for i in range(len(template[level_key]))
        }
    tree["classifier"] = _moe_classifier_name_tree(
        f"{scope}/classifier", template["classifier"])
    return tree


def _moe_classifier_name_tree(prefix: str, clf_template: Any) -> Any:
    """Name/converter tree for a MoE head at `prefix` (the hierarchical
    model's `{scope}/classifier`, DBoF's bare `{scope}`: DBoF calls the
    video-level model without a variable_scope,
    frame_level_models.py:192-196)."""
    if set(clf_template) != {"gates", "experts"}:
        raise NotImplementedError(
            "TF import supports the MoE classifier (the reference "
            f"flagship); template has {sorted(clf_template)}")
    m_plus_1 = clf_template["gates"]["w"].shape[1]
    m = clf_template["experts"]["w"].shape[1]
    return {
        "gates": {
            "w": (f"{prefix}/gates/weights",
                  lambda x: moe_weights_from_tf(x, m_plus_1),
                  moe_weights_to_tf),
        },
        "experts": {
            "w": (f"{prefix}/experts/weights",
                  lambda x: moe_weights_from_tf(x, m), moe_weights_to_tf),
            "b": (f"{prefix}/experts/biases",
                  lambda x: moe_bias_from_tf(x, m), moe_bias_to_tf),
        },
    }


def _dbof_name_tree(scope: str, template: Any) -> Any:
    """DBoF variable map (frame_level_models.py:104-196): the FC kernels
    are UNNAMED tf.Variables, so TF names them `{scope}/Variable[_k]` in
    creation order: cluster_weights first, then (no-BN only)
    cluster_biases, then hidden1_weights, then hidden1_biases. The slim
    batch_norm scopes input_bn/cluster_bn/hidden1_bn carry
    gamma/beta/moving_mean/moving_variance (center=True, scale=True)."""
    add_bn = "input_bn" in template
    ordinal = iter(range(16))

    def unnamed():
        k = next(ordinal)
        return f"{scope}/Variable" if k == 0 else f"{scope}/Variable_{k}"

    def bn(name):
        return {
            "scale": (f"{scope}/{name}/gamma", _ident, _ident),
            "offset": (f"{scope}/{name}/beta", _ident, _ident),
            "moving_mean": (f"{scope}/{name}/moving_mean", _ident, _ident),
            "moving_var": (f"{scope}/{name}/moving_variance", _ident, _ident),
        }

    tree: Dict[str, Any] = {"cluster": {"w": (unnamed(), _ident, _ident)}}
    if not add_bn:
        tree["cluster"]["b"] = (unnamed(), _ident, _ident)
    tree["hidden1"] = {"w": (unnamed(), _ident, _ident)}
    if not add_bn:
        tree["hidden1"]["b"] = (unnamed(), _ident, _ident)
    if add_bn:
        for name in ("input_bn", "cluster_bn", "hidden1_bn"):
            tree[name] = bn(name)
    tree["classifier"] = _moe_classifier_name_tree(scope, template["classifier"])
    return tree


def _name_tree(scope: str, template: Any) -> Any:
    """Dispatch on the parameter template: hierarchical LSTM or DBoF."""
    if "rnn_l1" in template:
        return _hierarchical_name_tree(scope, template)
    if "cluster" in template:
        return _dbof_name_tree(scope, template)
    raise NotImplementedError(
        "TF import supports HierarchicalLstmModel and DbofModel "
        f"templates; got keys {sorted(template)}")


def name_leaves(name_tree: Any, tree: Any, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], tuple, Any]]:
    """(path, name leaf, leaf of `tree`) for every leaf of the name tree,
    in its order; `tree` must have the name tree's structure."""
    if _is_name_leaf(name_tree):
        yield path, name_tree, tree
        return
    if not isinstance(tree, dict) or set(tree) != set(name_tree):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{'/'.join(path) or 'params'}: the state holds "
                         f"{got}, the reference's names {sorted(name_tree)}")
    for key, sub in name_tree.items():
        yield from name_leaves(sub, tree[key], path + (key,))


def _set(tree: dict, path: Tuple[str, ...], value) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def _load_tree(reader: TFCheckpointReader, name_tree: Any, template: Any,
               suffix: str = "") -> Optional[dict]:
    """A parameter tree (numpy float32 leaves) read from the checkpoint.
    With a suffix ("/Adam", "/Adam_1") it reads the optimizer slot
    variables and returns None if any is absent (an inference bundle)."""
    out: dict = {}
    for path, (tf_name, convert, _), tmpl in name_leaves(name_tree, template):
        if not reader.has_tensor(tf_name + suffix):
            if suffix:
                return None
            raise KeyError(
                f"checkpoint {reader.prefix} lacks {tf_name!r}; not a "
                "reference checkpoint for this model?")
        arr = convert(reader.get_tensor(tf_name + suffix))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"{tf_name}{suffix}: checkpoint shape {arr.shape} != "
                f"template {tuple(tmpl.shape)} (flag mismatch?)")
        _set(out, path, np.asarray(arr, np.float32))
    return out


def _adam_count(reader: TFCheckpointReader, ordinal: int) -> int:
    """TF Adam's update count from beta1_power.

    TF1 Adam initializes beta1_power to b1 and multiplies AFTER each
    apply (adam.py _finish), so a checkpoint saved after t updates stores
    b1^(t+1), the factor its NEXT apply will use. The port's next update
    uses b1^(count+1), so count = t = log(b1p)/log(b1) - 1.

    The teacher optimizer is built before the student's
    (train.py:332,416), so its power variable is `beta1_power` and the
    student's `beta1_power_1`."""
    name = "beta1_power" if ordinal == 0 else f"beta1_power_{ordinal}"
    for candidate in (name, f"model/{name}", f"model_student/{name}"):
        if reader.has_tensor(candidate):
            b1p = float(reader.get_tensor(candidate))
            if 0.0 < b1p < 1.0:
                return max(0, int(round(math.log(b1p) / math.log(_ADAM_B1))) - 1)
    return 0


def _import_optimizer_slots(reader: TFCheckpointReader, name_tree: Any,
                            slots: Any, ordinal: int) -> Optional[dict]:
    """TF-Adam slots {count, mu, nu} from `<var>/Adam(,_1)`, or None when
    the bundle has none or the state's optimizer is not TF-Adam."""
    if not (isinstance(slots, dict) and {"count", "mu", "nu"} <= set(slots)):
        return None
    mu = _load_tree(reader, name_tree, slots["mu"], "/Adam")
    nu = _load_tree(reader, name_tree, slots["nu"], "/Adam_1")
    if mu is None or nu is None:
        return None
    return {"count": np.asarray(_adam_count(reader, ordinal), np.int32),
            "mu": mu, "nu": nu}


def _student_power_ordinal(reader: TFCheckpointReader) -> int:
    """Which beta1_power variable pairs with the student's Adam slots.

    A finetune graph builds ONE optimizer (train_finetune.py:231), so the
    student's power is `beta1_power` (ordinal 0). A DISTILL graph builds
    the teacher's optimizer first (train.py:332,416), so there the
    student's lives in `beta1_power_1`: restoring a distill bundle into a
    StudentState with ordinal 0 would take the TEACHER's step count."""
    for name in ("beta1_power_1", "model/beta1_power_1",
                 "model_student/beta1_power_1"):
        if reader.has_tensor(name):
            return 1
    return 0


def _read_tree(prefix: str, state, ordinals: Dict[str, int],
               fields: Optional[Sequence[str]]) -> dict:
    """The fields of the JAX state tree that the bundle holds, among
    `fields` (default: all of the state's)."""
    reader = TFCheckpointReader(prefix)
    template = state_tree(state)  # whole leaves, for a sharded state too
    fields = set(template if fields is None else fields)
    tree: dict = {}
    for tower, ordinal in ordinals.items():
        params = template[f"params_{tower}"]
        if not {f"params_{tower}", f"opt_{tower}"} & fields:
            continue
        names = _name_tree(SCOPES[tower], params)
        if f"params_{tower}" in fields:
            tree[f"params_{tower}"] = _load_tree(reader, names, params)
        if f"opt_{tower}" in fields:
            slots = _import_optimizer_slots(reader, names,
                                            template[f"opt_{tower}"], ordinal)
            if slots is None:
                logger.info("TF checkpoint has no Adam slots for the %s; "
                            "its optimizer state is left as it is", tower)
            else:
                tree[f"opt_{tower}"] = slots
    if "global_step" in fields and reader.has_tensor("global_step"):
        tree["global_step"] = np.asarray(
            int(reader.get_tensor("global_step")), np.int32)
    return tree


def read_tf_tree(prefix: str, state, fields: Optional[Sequence[str]] = None
                 ) -> dict:
    """The JAX state tree (numpy leaves) of the bundle at `prefix` (with
    or without `.index`), named after `state`: a DistillState reads both
    towers (teacher's Adam power `beta1_power`, student's
    `beta1_power_1`), a StudentState the student scope of a finetune,
    inference or distillation bundle. Only the fields among `fields`
    (default: all of the state's) that the bundle holds are read."""
    if prefix.endswith(".index"):
        prefix = prefix[: -len(".index")]
    if isinstance(state, DistillState):
        ordinals = {"teacher": 0, "student": 1}
    else:
        ordinals = {"student": _student_power_ordinal(TFCheckpointReader(prefix))}
    return _read_tree(prefix, state, ordinals, fields)


def _load(state, tree: dict, fields: Optional[Sequence[str]]):
    fields = [f for f in (state_tree(state, gather=False) if fields is None
                          else fields) if f in tree]
    return load_state_tree(state, tree, fields=fields)


def import_tf_checkpoint(prefix: str, state, fields=None):
    """The bundle at `prefix` into the DistillState or StudentState
    `state` in place (the JAX `import_distill_state` and
    `import_student_state`; `read_tf_tree` tells them apart): parameters,
    global_step and the Adam moments when present. `fields` restricts the
    import to those top-level fields; fields the bundle lacks keep their
    values."""
    return _load(state, read_tf_tree(prefix, state, fields), fields)
