"""Checkpoint interop of the port against the JAX package, on the CPU:
TF-V2 bundles (the reference's Saver format) written by real TensorFlow
and by the JAX package's writer, imported by both packages; the port's
export byte for byte the JAX export's and read by TensorFlow;
cli.export_tf; Predictor, cli.validate and cli.eval over a bundle
directory; and flax's chunked msgpack leaves in both directions. A port
counterpart of each case of tests/test_tf_checkpoint.py is here."""

import copy
import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow.compat.v1")

import flax.serialization  # noqa: E402
import jax  # noqa: E402

from efficientvideoclassification_youtube8m_tpu import train as jtrain  # noqa: E402
from efficientvideoclassification_youtube8m_tpu import parallel as jparallel  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.cli import export_tf as jexport_cli  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.cli import flags as jflags  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.cli import validate as jvalidate  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.data import tf_checkpoint as jtfc  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.parallel import distributed as jdist  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.serving import Predictor as JPredictor  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.train import tf_export as jexport  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.train import tf_import as jimport  # noqa: E402
from efficientvideoclassification_youtube8m_tpu.utils.summary import (  # noqa: E402
    NullSummaryWriter,
)
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli  # noqa: E402
from efficientvideoclassification_youtube8m_torch.cli import export_tf  # noqa: E402
from efficientvideoclassification_youtube8m_torch.cli import inspect_checkpoint  # noqa: E402
from efficientvideoclassification_youtube8m_torch.cli import validate  # noqa: E402
from efficientvideoclassification_youtube8m_torch.data import (  # noqa: E402
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_torch.data import tf_checkpoint as tfc  # noqa: E402
from efficientvideoclassification_youtube8m_torch.ops import prng  # noqa: E402
from efficientvideoclassification_youtube8m_torch.serving import Predictor  # noqa: E402
from efficientvideoclassification_youtube8m_torch.train import msgpack_io  # noqa: E402
from efficientvideoclassification_youtube8m_torch.train import tf_export  # noqa: E402
from efficientvideoclassification_youtube8m_torch.train import tf_import  # noqa: E402
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (  # noqa: E402
    latest_checkpoint,
    read_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import (  # noqa: E402
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (  # noqa: E402
    init_distill_state,
    state_tree,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.train.step import (  # noqa: E402
    forward_teacher,
    preprocess_batch,
)
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig  # noqa: E402

tf.disable_eager_execution()
torch.set_num_threads(1)

# tests/test_tf_checkpoint.py's tiny config
CFG = TrainConfig(
    num_classes=12, lstm_cells=6, lstm_layers=2, max_num_frames=20,
    num_inputs_to_lstm=4, num_inputs_L1=2, feature_sizes="5, 3",
    scan_unroll=1, compute_dtype="float32",
)
FLAGS = [
    "--num_classes", "12", "--lstm_cells", "6", "--num_inputs_to_lstm", "4",
    "--num_inputs_L1", "2", "--max_num_frames", "20", "--feature_sizes", "5, 3",
    "--scan_unroll", "1", "--compute_dtype", "float32",
]
# Predictor and cli.validate over a bundle against the JAX package's: f32
# forwards with sums in another order
RTOL, ATOL = 1e-5, 1e-6


def _opt(cfg=CFG):
    return make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, path))
        else:
            out[path] = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
                         else np.asarray(value))
    return out


def _jflat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        flax.serialization.to_state_dict(tree))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in leaves}


def _tf_vars(scope, params, with_adam, rng):
    """A tower's reference variables (validate.py:350-381 names, the
    reference's MoE columns) from a port parameter tree."""
    out = {}
    for name, (tf_name, _, to_tf), leaf in (
            (p, n, leaf) for p, n, leaf in tf_import.name_leaves(
                tf_import._name_tree(scope, params), params)):
        out[tf_name] = to_tf(leaf.detach().numpy().astype(np.float32))
    if with_adam:
        for name in list(out):
            out[name + "/Adam"] = rng.normal(size=out[name].shape).astype(np.float32)
            out[name + "/Adam_1"] = np.abs(rng.normal(size=out[name].shape)).astype(np.float32)
    return out


def _tf_save(directory, tensors, step=None):
    """Write `tensors` with TensorFlow's own tf.train.Saver."""
    g = tf.Graph()
    with g.as_default():
        tf_vars = {n: tf.get_variable(n, initializer=v) for n, v in tensors.items()}
        saver = tf.train.Saver(tf_vars)
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            return saver.save(sess, os.path.join(str(directory), "model.ckpt"),
                              global_step=step, write_meta_graph=False)


def _distill_fixture(directory, state, global_step=84, with_adam=True):
    """A reference distill bundle of `state`'s parameters, written by TF,
    with Adam slots for t = 5 (teacher) and 9 (student) when asked."""
    rng = np.random.default_rng(7)
    tree = state_tree(state)
    tensors = {"global_step": np.int64(global_step)}
    tensors.update(_tf_vars("model", tree["params_teacher"], with_adam, rng))
    tensors.update(_tf_vars("model_student", tree["params_student"], with_adam, rng))
    if with_adam:
        # TF1 Adam stores b^(t+1) after t updates
        tensors.update(beta1_power=np.float32(0.9 ** 6), beta1_power_1=np.float32(0.9 ** 10),
                       beta2_power=np.float32(0.999 ** 6),
                       beta2_power_1=np.float32(0.999 ** 10))
    return _tf_save(directory, tensors, global_step), tensors


def _golden():
    """The seed-0 distill state (the JAX package's init, bit for bit)."""
    return init_distill_state(CFG, _opt())


def _template(key=99, cfg=CFG):
    return init_distill_state(cfg, _opt(cfg), prng.prng_key(key))


def _stateful(cfg=CFG, t_teacher=5, t_student=9, step=84):
    """A distill state with non-trivial Adam moments and step counts, and
    the same state in the JAX package."""
    state = init_distill_state(cfg, _opt(cfg))
    rng = np.random.default_rng(3)
    for slots, t in ((state.opt_teacher, t_teacher), (state.opt_student, t_student)):
        slots["count"] = t
        for key in ("mu", "nu"):
            for tensor in slots[key].values():
                tensor.copy_(torch.from_numpy(rng.normal(size=tensor.shape).astype(np.float32)))
    state.global_step = step
    return state


def _jax_state_of(state, tmp_path):
    """The JAX package's DistillState holding `state` (through a port
    msgpack checkpoint, which the JAX package reads)."""
    path = save_checkpoint(str(tmp_path / "bridge"), state, state.global_step)
    jo = jtrain.make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    return jtrain.restore_checkpoint(path, jtrain.init_distill_state(CFG, jo))


def _assert_tree_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# -------------------------------------------------- the name maps


def test_moe_layout_round_trip_and_semantics():
    rng = np.random.default_rng(0)
    d, m, v = 5, 3, 7
    w_tf = rng.normal(size=(d, v * m)).astype(np.float32)
    w = tf_import.moe_weights_from_tf(w_tf, m)
    np.testing.assert_array_equal(w, jimport.moe_weights_from_tf(w_tf, m))
    for c in range(v):
        for k in range(m):
            np.testing.assert_array_equal(w[:, k, c], w_tf[:, c * m + k])
    np.testing.assert_array_equal(tf_import.moe_weights_to_tf(w), w_tf)
    b_tf = rng.normal(size=(v * m,)).astype(np.float32)
    b = tf_import.moe_bias_from_tf(b_tf, m)
    np.testing.assert_array_equal(b, jimport.moe_bias_from_tf(b_tf, m))
    np.testing.assert_array_equal(tf_import.moe_bias_to_tf(b), b_tf)


def test_reader_round_trips_tf_written_bundle(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {
        "a/kernel": rng.normal(size=(9, 33)).astype(np.float32),
        "a/bias": rng.normal(size=(33,)).astype(np.float32),
        "counts": rng.integers(0, 100, size=(4, 5)).astype(np.int64),
        "flags": np.array([True, False, True]),
        "scalar": np.float64(3.25),
    }
    prefix = _tf_save(tmp_path, tensors)
    assert tfc.is_tf_checkpoint(prefix) and tfc.is_tf_checkpoint(prefix + ".index")
    reader = tfc.TFCheckpointReader(prefix)
    assert reader.variable_names() == sorted(tensors)
    assert reader.list_variables() == jtfc.TFCheckpointReader(prefix).list_variables()
    for name, val in tensors.items():
        got = reader.get_tensor(name)
        assert got.dtype == val.dtype
        np.testing.assert_array_equal(got, val)


def test_writer_is_byte_identical_to_jax_writer_and_read_by_tf(tmp_path):
    rng = np.random.default_rng(2)
    tensors = {
        "model/w": rng.normal(size=(7, 11)).astype(np.float32),
        "model/b": rng.normal(size=(11,)).astype(np.float64),
        "global_step": np.asarray(12, np.int32),
        "steps64": np.asarray([1, 2], np.int64),
        "mask": np.array([[True], [False]]),
        "u8": rng.integers(0, 255, size=(3, 3)).astype(np.uint8),
        "beta1_power": np.float32(0.9 ** 4),
    }
    port = tfc.write_tf_checkpoint(str(tmp_path / "port" / "model.ckpt-12"), tensors)
    jax_prefix = jtfc.write_tf_checkpoint(str(tmp_path / "jax" / "model.ckpt-12"), tensors)
    for suffix in (".index", ".data-00000-of-00001"):
        assert open(port + suffix, "rb").read() == open(jax_prefix + suffix, "rb").read()
    reader = tf.train.NewCheckpointReader(port)
    for name, val in tensors.items():
        np.testing.assert_array_equal(reader.get_tensor(name), val)
    with pytest.raises(ValueError, match="no TF DataType"):
        tfc.write_tf_checkpoint(str(tmp_path / "bad"), {"x": np.zeros(2, np.complex64)})


def test_snappy_decoder():
    payload = b"hello "
    lit_tag = bytes([(len(payload) - 1) << 2])
    copy_tag = bytes([((6 - 4) & 0x7) << 2 | 1 | (0 << 5), 6])  # len 6, off 6
    raw = bytes([13]) + lit_tag + payload + copy_tag + bytes([0 << 2]) + b"!"
    assert tfc._snappy_decompress(memoryview(raw)) == b"hello hello !"


# -------------------------------------------------- import


def test_import_distill_state_full(tmp_path):
    golden = _golden()
    prefix, tensors = _distill_fixture(tmp_path, golden)
    state = _template()
    assert restore_checkpoint(prefix, state) is state
    tree, want = _flat(state_tree(state)), _flat(state_tree(golden))
    for key in want:
        if key.startswith("params_"):
            np.testing.assert_array_equal(tree[key], want[key], err_msg=key)
    assert state.global_step == 84
    assert state.opt_teacher["count"] == 5 and state.opt_student["count"] == 9
    np.testing.assert_array_equal(
        tree["opt_teacher/mu/rnn_l1/0/kernel"],
        tensors["model/RNN_L1/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel/Adam"])
    np.testing.assert_array_equal(
        tree["opt_student/nu/classifier/experts/b"],
        tf_import.moe_bias_from_tf(tensors["model_student/classifier/experts/biases/Adam_1"],
                                   CFG.moe_num_mixtures))
    # the JAX package's import of the same bundle, bit for bit
    jo = jtrain.make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    jstate = jtrain.restore_checkpoint(prefix, jtrain.init_distill_state(
        CFG, jo, rng=jax.random.PRNGKey(99)))
    _assert_tree_equal({k: v for k, v in tree.items() if k != "dropout_keep_prob"},
                       {k: v for k, v in _jflat(jstate).items()
                        if k != "dropout_keep_prob"})
    # the imported teacher's forward is the golden teacher's
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.integers(0, 256, size=(4, CFG.max_num_frames,
                                                        CFG.total_feature_size),
                                          dtype=np.uint8))
    nf = torch.tensor([20, 7, 13, 4], dtype=torch.int32)
    x = preprocess_batch(CFG, feats, nf)
    with torch.no_grad():
        np.testing.assert_array_equal(
            forward_teacher(CFG, state.teacher, x, nf, inference=True)["predictions"].numpy(),
            forward_teacher(CFG, golden.teacher, x, nf, inference=True)["predictions"].numpy())


def test_import_student_state_from_distill_bundle_adam_count(tmp_path):
    """A distill bundle into a StudentState pairs the student's slots with
    `beta1_power_1` (t = 9), not the teacher's `beta1_power` (t = 5)."""
    prefix, _ = _distill_fixture(tmp_path, _golden())
    student = student_state_from_distill(_template(5), _opt())
    restore_checkpoint(prefix, student)
    assert student.opt_student["count"] == 9


def test_import_student_state_without_adam(tmp_path):
    golden = _golden()
    prefix, _ = _distill_fixture(tmp_path, golden, global_step=12, with_adam=False)
    student = student_state_from_distill(_template(5), _opt())
    restore_checkpoint(prefix, student)
    want = _flat(state_tree(golden)["params_student"])
    got = _flat(state_tree(student)["params_student"])
    _assert_tree_equal(got, want)
    assert student.global_step == 12
    assert student.opt_student["count"] == 0  # no slots: a fresh Adam


@pytest.mark.parametrize("add_bn", [True, False])
def test_import_dbof_student_state(tmp_path, add_bn):
    """DBoF bundles with the reference's UNNAMED-Variable order, slim's
    batch-norm statistics and the MoE head at the bare scope, written by
    TensorFlow, import to the JAX package's state bit for bit."""
    cfg = CFG.replace(model="DbofModel", dbof_cluster_size=10, dbof_hidden_size=6,
                      dbof_add_batch_norm=add_bn)
    golden = student_state_from_distill(init_distill_state(cfg, _opt(cfg)), _opt(cfg))
    params = state_tree(golden)["params_student"]
    if add_bn:  # distinctive statistics, so the mapping is exercised
        rng = np.random.default_rng(3)
        for bn in ("input_bn", "cluster_bn", "hidden1_bn"):
            for k, t in params[bn].items():
                t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)))
    tensors = {"global_step": np.int64(7)}
    tensors.update(_tf_vars("model_student", params, False, None))
    names = sorted(tensors)
    assert ("model_student/Variable_3" in names) == (not add_bn)
    prefix = _tf_save(tmp_path, tensors, 7)
    state = student_state_from_distill(_template(9, cfg), _opt(cfg))
    restore_checkpoint(prefix, state)
    _assert_tree_equal(_flat(state_tree(state)["params_student"]), _flat(params))
    assert state.global_step == 7
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    jstate = jtrain.restore_checkpoint(prefix, jtrain.student_state_from_distill(
        jtrain.init_distill_state(cfg, jo, rng=jax.random.PRNGKey(9)), jo))
    _assert_tree_equal(_flat(state_tree(state)["params_student"]),
                       _jflat(jstate.params_student))


@pytest.mark.parametrize("model,add_bn", [("HierarchicalLstmModel", None),
                                          ("DbofModel", True), ("DbofModel", False)])
def test_jax_written_bundle_imports_alike_in_both_packages(tmp_path, model, add_bn):
    """A bundle written by the JAX package's exporter from the JAX state
    imports into both packages to the same state, bit for bit."""
    cfg = (CFG if model == "HierarchicalLstmModel" else CFG.replace(
        model=model, dbof_cluster_size=10, dbof_hidden_size=6, dbof_add_batch_norm=add_bn))
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    jstate = jtrain.init_distill_state(cfg, jo)
    if model == "DbofModel":
        jstate = jtrain.student_state_from_distill(jstate, jo)
    prefix = jexport.export_tf_checkpoint(str(tmp_path / "model.ckpt-0"), jstate)
    state = _template(4, cfg)
    if model == "DbofModel":
        state = student_state_from_distill(state, _opt(cfg))
    restore_checkpoint(prefix, state)
    want = jtrain.restore_checkpoint(prefix, jstate)
    got = _flat(state_tree(state))
    for key, value in _jflat(want).items():
        if key != "dropout_keep_prob":
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_latest_checkpoint_reads_reference_pointer_file(tmp_path):
    prefix, _ = _distill_fixture(tmp_path, _golden())
    assert os.path.exists(tmp_path / "checkpoint")  # tf.train.Saver's own
    assert latest_checkpoint(str(tmp_path)) == prefix
    assert tfc.latest_tf_checkpoint(str(tmp_path)) == prefix
    with pytest.raises(ValueError, match="pass the target state"):
        read_checkpoint(prefix)
    tree = read_checkpoint(prefix + ".index", _template(), ["params_student"])
    assert sorted(tree) == ["params_student"]


def test_inspect_checkpoint_prints_tf(tmp_path, capsys):
    prefix, _ = _distill_fixture(tmp_path, _golden(), with_adam=False)
    inspect_checkpoint.main(["--file_name", prefix])
    out = capsys.readouterr().out
    assert ("tensor_name: model/RNN_L1/rnn/multi_rnn_cell/cell_0/"
            "basic_lstm_cell/kernel") in out
    assert "tensor_name: global_step  shape: []  dtype: int64" in out


def test_adam_count_matches_live_tf_optimizer(tmp_path):
    """beta1_power against a live tf.train.AdamOptimizer: TF stores
    b1^(t+1) after t updates; the export of a fresh state stores b1."""
    g = tf.Graph()
    with g.as_default():
        v = tf.get_variable("model/v", initializer=np.float32([1.0, 2.0]))
        train_op = tf.train.AdamOptimizer(learning_rate=0.1).minimize(tf.reduce_sum(v * v))
        saver = tf.train.Saver()
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            for _ in range(3):
                sess.run(train_op)
            prefix = saver.save(sess, str(tmp_path / "model.ckpt"), write_meta_graph=False)
    reader = tfc.TFCheckpointReader(prefix)
    assert tf_import._adam_count(reader, 0) == 3 == jimport._adam_count(
        jtfc.TFCheckpointReader(prefix), 0)
    p3 = tf_export.export_tf_checkpoint(str(tmp_path / "ours.ckpt-0"), _golden())
    assert np.isclose(float(tfc.TFCheckpointReader(p3).get_tensor("beta1_power")), 0.9,
                      rtol=1e-6)


# -------------------------------------------------- export


@pytest.mark.parametrize("tower", ["distill", "student"])
def test_export_is_byte_identical_to_jax_export_and_round_trips(tmp_path, tower):
    """The port's export of a state and the JAX package's export of the
    same state are the same bytes; import(export(state)) is the state."""
    state = _stateful()
    jstate = _jax_state_of(state, tmp_path)
    if tower == "student":  # the convert step: fresh slots, step 0
        state = student_state_from_distill(state, _opt())
        jo = jtrain.make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
        jstate = jtrain.student_state_from_distill(jstate, jo)
    port = tf_export.export_tf_checkpoint(str(tmp_path / "port" / "model.ckpt-84"), state)
    jprefix = jexport.export_tf_checkpoint(str(tmp_path / "jax" / "model.ckpt-84"), jstate)
    for suffix in (".index", ".data-00000-of-00001"):
        assert open(port + suffix, "rb").read() == open(jprefix + suffix, "rb").read()
    reader = tfc.TFCheckpointReader(port)
    assert reader.has_tensor("beta1_power")
    assert reader.has_tensor("beta1_power_1") == (tower == "distill")
    fresh = _template(42)
    if tower == "student":
        fresh = student_state_from_distill(fresh, _opt())
    restore_checkpoint(port, fresh)
    want = _flat(state_tree(state))
    got = _flat(state_tree(fresh))
    for key in want:
        if key != "dropout_keep_prob":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_exported_bundle_consumed_by_real_tf(tmp_path):
    state = _stateful()
    prefix = tf_export.export_tf_checkpoint(str(tmp_path / "model.ckpt-84"), state)
    reader = tf.train.NewCheckpointReader(prefix)
    names = sorted(reader.get_variable_to_shape_map())
    for scope in ("model", "model_student"):
        for want in (
            f"{scope}/RNN_L1/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel",
            f"{scope}/RNN_L1/rnn/multi_rnn_cell/cell_1/basic_lstm_cell/bias",
            f"{scope}/RNN_L2/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel",
            f"{scope}/classifier/gates/weights",
            f"{scope}/classifier/experts/weights",
            f"{scope}/classifier/experts/biases",
            f"{scope}/classifier/experts/weights/Adam",
            f"{scope}/classifier/experts/weights/Adam_1",
        ):
            assert want in names, want
    for want in ("global_step", "beta1_power", "beta1_power_1", "beta2_power",
                 "beta2_power_1"):
        assert want in names, want
    assert reader.get_tensor("global_step") == 84
    np.testing.assert_allclose(reader.get_tensor("beta1_power"), 0.9 ** 6, rtol=1e-6)
    np.testing.assert_array_equal(
        reader.get_tensor("model/classifier/experts/weights"),
        tf_import.moe_weights_to_tf(state.teacher.classifier.experts.w.detach().numpy()))
    kname = "model/RNN_L1/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel"
    want_k = state.teacher.rnn_l1[0].kernel.detach().numpy()
    g = tf.Graph()
    with g.as_default():
        v = tf.get_variable(kname, shape=want_k.shape, dtype=tf.float32)
        saver = tf.train.Saver({kname: v})
        with tf.Session() as sess:
            saver.restore(sess, prefix)
            np.testing.assert_array_equal(sess.run(v), want_k)


def test_export_tf_cli_end_to_end(tmp_path, caplog):
    """cli.export_tf: a msgpack train_dir -> a TF bundle and a TF-style
    pointer file; the bundle is the JAX binary's, byte for byte, and
    re-imports bit for bit; an existing pointer file is never touched."""
    state = _stateful(step=12)
    train_dir = str(tmp_path / "model_train")
    save_checkpoint(train_dir, state, 12)
    out = export_tf.main(FLAGS + ["--train_dir", train_dir, "--device", "cpu"])
    export_dir = os.path.join(train_dir, "tf_export")
    prefix = os.path.join(export_dir, "model.ckpt-12")
    assert out == prefix and tfc.is_tf_checkpoint(prefix)
    assert latest_checkpoint(export_dir) == prefix
    assert tfc.latest_tf_checkpoint(export_dir) == prefix
    jexport_cli.main(FLAGS + ["--train_dir", train_dir,
                              "--output_prefix", str(tmp_path / "jax" / "model.ckpt")])
    for suffix in (".index", ".data-00000-of-00001"):
        assert (open(prefix + suffix, "rb").read()
                == open(str(tmp_path / "jax" / "model.ckpt-12") + suffix, "rb").read())
    fresh = _template(1)
    restore_checkpoint(prefix, fresh)
    for key, value in _flat(state_tree(state)["params_teacher"]).items():
        np.testing.assert_array_equal(_flat(state_tree(fresh)["params_teacher"])[key],
                                      value, err_msg=key)
    assert fresh.global_step == 12
    # the student tower, into the train_dir itself: its pointer stays
    pointer = open(os.path.join(train_dir, "checkpoint")).read()
    out = export_tf.main(FLAGS + ["--train_dir", train_dir, "--device", "cpu",
                                  "--tower", "student",
                                  "--output_prefix", os.path.join(train_dir, "ft")])
    assert out == os.path.join(train_dir, "ft-12")
    assert open(os.path.join(train_dir, "checkpoint")).read() == pointer
    assert not tfc.TFCheckpointReader(out).has_tensor(
        "model/RNN_L1/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel")


# -------------------------------------------------- the binaries over a bundle


def _batch_u8(seed, n=4):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(n, CFG.max_num_frames, CFG.total_feature_size),
                         dtype=np.uint8)
    return feats, np.asarray([20, 7, 13, 4][:n], np.int32)


def test_serving_predictor_from_tf_checkpoint_dir(tmp_path):
    """A reference train_dir serves both towers through the Predictor,
    as the JAX package's does."""
    _distill_fixture(tmp_path, _golden(), with_adam=False)
    feats, nf = _batch_u8(11)
    for tower in ("teacher", "student"):
        got = Predictor.from_checkpoint(str(tmp_path), CFG, tower=tower, serve_batch=4,
                                        device="cpu").predict(feats, nf)
        want = JPredictor.from_checkpoint(str(tmp_path), CFG, tower=tower,
                                          serve_batch=4).predict(feats, nf)
        assert got.shape == (4, CFG.num_classes)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a student-only (finetune) bundle has no teacher tower
    student_dir = tmp_path / "ft"
    tf_export.export_tf_checkpoint(str(student_dir / "model.ckpt-3"),
                                   student_state_from_distill(_golden(), _opt()))
    with pytest.raises(ValueError, match="no teacher tower"):
        Predictor.from_checkpoint(str(student_dir), CFG, tower="teacher", device="cpu")
    probs = Predictor.from_checkpoint(str(student_dir), CFG, device="cpu").predict(feats, nf)
    assert np.all(np.isfinite(probs))


def _eval_shard(tmp_path):
    write_synthetic_frame_shard(
        str(tmp_path / "validate-0000.tfrecord"), num_videos=6, seed=3,
        max_frames=CFG.max_num_frames, min_frames=3, vocab_size=CFG.num_classes,
        feature_sizes=(5, 3))
    return ["--eval_data_pattern", str(tmp_path / "validate-*.tfrecord"),
            "--every_n", "2", "--batch_size", "8", "--top_k", "5",
            "--num_readers", "1", "--run_once", "true"]


def test_validate_cli_over_tf_checkpoint_dir(tmp_path):
    """cli.validate at a reference train_dir evaluates the bundle; its
    epoch metrics are the JAX package's validate loop's."""
    prefix, _ = _distill_fixture(tmp_path, _golden(), with_adam=False)
    argv = FLAGS + ["--train_dir", str(tmp_path)] + _eval_shard(tmp_path)
    got = validate.main(argv + ["--device", "cpu"])
    jargs = jflags.base_parser("v").parse_args(argv)
    jcfg = jflags.config_from_args(jargs)
    jo = jtrain.make_optimizer(jcfg.optimizer, jcfg.clip_gradient_norm)
    mesh = jparallel.create_mesh()
    fields = ("params_teacher", "params_student")
    template = jparallel.place_fields(
        jtrain.init_distill_state(jcfg, jo, host_optimizer_state=True), mesh, fields)
    step = jparallel.build_sharded_validate_step(
        jcfg, mesh, template.params_teacher, template.params_student, top_k=5)
    jstate = jparallel.place_fields(jtrain.restore_checkpoint(prefix, template), mesh,
                                    fields)
    want = jvalidate.evaluation_loop(jcfg, jargs, jstate, step, mesh, NullSummaryWriter(),
                                     prefix, jdist.host_context(jcfg.batch_size))
    assert got["epoch_id"] == want["epoch_id"] == 84
    for key in ("avg_hit_at_one", "avg_perr", "gap", "avg_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)


def test_eval_cli_over_tf_bundle_matches_msgpack(tmp_path):
    """cli.eval over a student bundle gives the epoch metrics of the same
    state's msgpack checkpoint, bit for bit."""
    state = student_state_from_distill(_golden(), _opt())
    state.global_step = 3
    tf_export.export_tf_checkpoint(str(tmp_path / "tf" / "model.ckpt-3"), state)
    save_checkpoint(str(tmp_path / "mp"), state, 3)
    argv = FLAGS + _eval_shard(tmp_path) + ["--device", "cpu"]
    got = eval_cli.main(argv + ["--train_dir", str(tmp_path / "tf")])
    want = eval_cli.main(argv + ["--train_dir", str(tmp_path / "mp")])
    assert got == want


# -------------------------------------------------- flax's chunked leaves


CHUNK = 4096  # bytes: a few KiB, so small leaves take the chunked form


def _chunky_tree():
    rng = np.random.default_rng(5)
    return {
        "big": rng.normal(size=(37, 61)).astype(np.float32),  # 9028 B: 3 chunks
        "exact": np.arange(2048, dtype=np.int16),  # 4096 B: not over the limit
        "nested": {"ints": rng.integers(0, 9, size=(1500,)).astype(np.int64),
                   "small": np.ones(3, np.float32), "n": np.int32(5)},
        "list": [rng.normal(size=(2000,)).astype(np.float32)],  # flax chunks no list
        "step": 7,
    }


def test_chunked_leaves_pass_between_flax_and_port(monkeypatch):
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", CHUNK)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", CHUNK)
    tree = _chunky_tree()
    flax_bytes = flax.serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    port_bytes = msgpack_io.dumps(tree)
    assert b"__msgpack_chunked_array__" in port_bytes
    assert port_bytes == flax_bytes
    for decoded in (msgpack_io.loads(flax_bytes),
                    flax.serialization.msgpack_restore(port_bytes)):
        np.testing.assert_array_equal(decoded["big"], tree["big"])
        assert decoded["big"].dtype == np.float32 and decoded["big"].shape == (37, 61)
        np.testing.assert_array_equal(decoded["nested"]["ints"], tree["nested"]["ints"])
        np.testing.assert_array_equal(decoded["list"][0], tree["list"][0])
        np.testing.assert_array_equal(decoded["exact"], tree["exact"])
    # a whole-tree array is chunked too
    arr = tree["big"]
    assert msgpack_io.dumps(arr) == flax.serialization.msgpack_serialize(arr)
    np.testing.assert_array_equal(msgpack_io.loads(msgpack_io.dumps(arr)), arr)


def test_chunked_state_checkpoint_crosses_the_packages(tmp_path, monkeypatch):
    """A distill state whose MoE weights exceed the (lowered) limit: both
    packages write them chunked (in their own key order: the port's is
    the modules', flax's sorted), and each restores the other's file bit
    for bit."""
    limit = 1024  # the tiny MoE gate weights are 3456 bytes
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", limit)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", limit)
    state = _stateful()
    assert state.teacher.classifier.gates.w.numel() * 4 > limit
    path = save_checkpoint(str(tmp_path / "port"), state, 84)
    jstate = _jax_state_of(state, tmp_path)
    jpath = jtrain.save_checkpoint(str(tmp_path / "jax"), jstate, 84)
    for p in (path, jpath):
        assert open(p, "rb").read().count(b"__msgpack_chunked_array__") >= 6
    want = _flat(state_tree(state))
    fresh = _template(8)
    restore_checkpoint(jpath, fresh)
    _assert_tree_equal(_flat(state_tree(fresh)), want)
    jo = jtrain.make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    back = jtrain.restore_checkpoint(path, jtrain.init_distill_state(
        CFG, jo, rng=jax.random.PRNGKey(8)))
    _assert_tree_equal(_jflat(back), want)
