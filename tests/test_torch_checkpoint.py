"""The port's checkpoint bridge against the JAX package's, on the CPU at a
tiny config (tests/test_pipeline_e2e.py's widths): the pure-Python msgpack
codec against msgpack-python and flax, checkpoint files crossing between
the packages in both directions for every optimizer, the pointer file and
max_to_keep, template mismatches, the async saver, and the per-variable
histograms against the JAX package's."""

import glob
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import flax.serialization

from efficientvideoclassification_youtube8m_tpu.data.proto import iter_fields
from efficientvideoclassification_youtube8m_tpu.data.tfrecord import TFRecordReader
from efficientvideoclassification_youtube8m_tpu.train import checkpoint as jckpt
from efficientvideoclassification_youtube8m_tpu.train import optimizer as joptimizer
from efficientvideoclassification_youtube8m_tpu.train import state as jstate_lib
from efficientvideoclassification_youtube8m_tpu.utils import summary as jsummary
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig
from efficientvideoclassification_youtube8m_torch.train import checkpoint as tckpt
from efficientvideoclassification_youtube8m_torch.train import msgpack_io
from efficientvideoclassification_youtube8m_torch.train.optimizer import (
    _BUILDERS,
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    state_tree,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.utils import summary as tsummary
from efficientvideoclassification_youtube8m_torch.weights import to_jax_params

torch.set_num_threads(1)

TINY = TrainConfig(
    num_classes=40, batch_size=8, lstm_cells=8, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
)
OPTIMIZERS = sorted(_BUILDERS)


def _paths(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _numpy_tree(state):
    """The port state's tree with host float32 leaves (what the file holds)."""
    return {k: (tckpt._to_numpy(v) if isinstance(v, torch.Tensor) else v)
            for k, v in _paths(state_tree(state)).items()}


def _randomize_port(state, seed):
    """Fill every parameter and slot of a port state with distinct values,
    and set the scalars, so a copy that misses anything shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for leaf in _paths(state_tree(state)).values():
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
    for slots in (state.opt_teacher, state.opt_student):
        if "count" in slots:
            slots["count"] = 3
    state.global_step, state.dropout_keep_prob = 7, 0.5
    return state


# ---------------------------------------------------------------- codec

@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int8",
                                   "bool", "uint8", "float16", "int64"])
@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (0, 2)])
def test_codec_round_trips_arrays(dtype, shape):
    """Each leaf comes back bit-equal, and the bytes are msgpack-python's
    with flax's extension hook."""
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal(shape) * 50).astype(dtype)
    tree = {"x": arr, "scalar": np.asarray(arr).reshape(-1)[:1].sum().astype(dtype)}
    raw = msgpack_io.dumps(tree)
    assert raw == msgpack.packb(tree, default=flax.serialization._msgpack_ext_pack,
                                strict_types=True)
    back = msgpack_io.loads(raw)
    assert back["x"].dtype == arr.dtype and back["x"].shape == arr.shape
    np.testing.assert_array_equal(back["x"], arr)
    assert back["scalar"].dtype == arr.dtype and back["scalar"].shape == ()
    flax_back = flax.serialization.msgpack_restore(raw)
    np.testing.assert_array_equal(flax_back["x"], arr)


def test_codec_python_values_and_errors(tmp_path):
    tree = {"ints": [0, 127, 128, -32, -33, 70000, -70000, 2**40, -2**40, 2**63],
            "floats": [1.5, -0.0], "flags": [True, False, None],
            "text": "k" * 300, "blob": b"q" * 300,
            "map": {str(i): i for i in range(20)}, "empty": {}}
    raw = msgpack_io.dumps(tree)
    assert raw == msgpack.packb(tree, use_bin_type=True)
    assert msgpack_io.loads(raw) == tree
    # numpy scalars (flax's ext 3) decode as numpy scalars
    scalar = msgpack.packb({"s": np.float32(2.5)},
                           default=flax.serialization._msgpack_ext_pack)
    got = msgpack_io.loads(scalar)["s"]
    assert isinstance(got, np.float32) and got == np.float32(2.5)
    # a file read gives writable views of one buffer
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        msgpack_io.dump({"a": np.arange(6, dtype=np.float32)}, f)
    a = msgpack_io.load(path)["a"]
    assert a.flags.writeable and not a.flags.owndata
    with pytest.raises(ValueError, match="chunked"):
        msgpack_io.loads(msgpack.packb({"__msgpack_chunked_array__": True}))
    bad = msgpack.packb({"x": msgpack.ExtType(1, msgpack.packb(
        ((2,), "bfloat16", b"\0" * 4), use_bin_type=True))})
    with pytest.raises(ValueError, match="unknown array dtype name 'bfloat16'"):
        msgpack_io.loads(bad)
    with pytest.raises(TypeError):
        msgpack_io.dumps({"x": object()})


# ------------------------------------------ files across the two packages

@pytest.mark.parametrize("name", OPTIMIZERS)
def test_port_file_restores_in_jax(tmp_path, name):
    """A checkpoint the port writes is read by flax's msgpack_restore and by
    the JAX package's restore_checkpoint into the JAX template, every leaf
    bit-equal to the port state."""
    state = _randomize_port(init_distill_state(TINY, make_optimizer(name)), 1)
    path = tckpt.save_checkpoint(str(tmp_path), state, state.global_step)
    assert os.path.basename(path) == "model.ckpt-7.msgpack"
    want = _numpy_tree(state)
    with open(path, "rb") as f:
        raw = flax.serialization.msgpack_restore(f.read())
    assert _paths(raw).keys() == want.keys()
    template = jstate_lib.init_distill_state(TINY, joptimizer.make_optimizer(name))
    restored = jckpt.restore_checkpoint(path, template)
    got = _paths(flax.serialization.to_state_dict(restored))
    assert got.keys() == want.keys()
    for key, value in want.items():
        got_value = np.asarray(got[key])
        assert got_value.dtype == value.dtype, key
        np.testing.assert_array_equal(got_value, value, err_msg=key)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_jax_file_restores_in_port(tmp_path, name):
    """A checkpoint the JAX package writes is read by the port into a port
    state, every tensor bit-equal; the student-only state too."""
    jopt = joptimizer.make_optimizer(name)
    template = jstate_lib.init_distill_state(TINY, jopt)
    keys = iter(jax.random.split(jax.random.PRNGKey(3),
                                 len(jax.tree.leaves(template))))
    jstate = jax.tree.map(
        lambda x: (jax.random.normal(next(keys), x.shape, x.dtype)
                   if jnp.issubdtype(x.dtype, jnp.floating) else x + 5),
        template)
    path = jckpt.save_checkpoint(str(tmp_path), jstate, 12)
    want = {k: np.asarray(v) for k, v in
            _paths(flax.serialization.to_state_dict(jstate)).items()}

    state = init_distill_state(TINY, make_optimizer(name))
    assert tckpt.restore_checkpoint(path, state) is state
    got = _numpy_tree(state)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert state.global_step == 5
    assert state.dropout_keep_prob == float(want["dropout_keep_prob"])

    jstudent = jstate_lib.student_state_from_distill(jstate, jopt)
    spath = jckpt.save_checkpoint(str(tmp_path / "ft"), jstudent, 0)
    opt = make_optimizer(name)
    student = student_state_from_distill(init_distill_state(TINY, opt), opt)
    tckpt.restore_checkpoint(spath, student)
    for key, value in _paths(flax.serialization.to_state_dict(jstudent)).items():
        np.testing.assert_array_equal(_numpy_tree(student)[key], np.asarray(value),
                                      err_msg=key)


def test_pointer_file_and_max_to_keep_match_jax(tmp_path):
    """The same sequence of saves leaves the same files, pointer file and
    latest checkpoint in both packages, including a reference TF-format
    pointer line and the directory scan."""
    tree = {"w": np.arange(3, dtype=np.float32)}
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for step, keep in ((5, 1), (12, 3), (9, 3), (30, 2), (2, 0)):
        jckpt.save_checkpoint(str(dirs["jax"]), tree, step, max_to_keep=keep)
        tckpt.save_checkpoint(str(dirs["port"]), tree, step, max_to_keep=keep)
        listing = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
        assert listing["jax"] == listing["port"]
        pointers = {k: (d / "checkpoint").read_text() for k, d in dirs.items()}
        assert pointers["jax"] == pointers["port"]
        assert (os.path.basename(jckpt.latest_checkpoint(str(dirs["jax"])))
                == os.path.basename(tckpt.latest_checkpoint(str(dirs["port"]))))
    assert pointers["port"].splitlines()[0] == "model.ckpt-2.msgpack"
    for k, d in dirs.items():  # a reference train_dir's pointer + bundle
        (d / "model.ckpt-40.index").write_bytes(b"")
        (d / "checkpoint").write_text(
            'model_checkpoint_path: "model.ckpt-40"\n'
            'all_model_checkpoint_paths: "model.ckpt-40"\n')
    assert (jckpt.latest_checkpoint(str(dirs["jax"])).replace("jax", "port")
            == tckpt.latest_checkpoint(str(dirs["port"])))
    for d in dirs.values():  # no pointer file: the directory scan
        os.remove(d / "checkpoint")
    assert (os.path.basename(jckpt.latest_checkpoint(str(dirs["jax"])))
            == os.path.basename(tckpt.latest_checkpoint(str(dirs["port"])))
            == "model.ckpt-30.msgpack")
    assert tckpt.checkpoint_step("d/model.ckpt-30.msgpack") == 30
    with pytest.raises(NotImplementedError, match="TF-V2"):
        tckpt.restore_checkpoint(str(dirs["port"] / "model.ckpt-40"), None)
    (dirs["port"] / "model.ckpt-50").mkdir()
    with pytest.raises(NotImplementedError, match="item 13"):
        tckpt.restore_checkpoint(str(dirs["port"] / "model.ckpt-50"), None)
    with pytest.raises(NotImplementedError, match="item 13"):
        tckpt.save_checkpoint(str(dirs["port"]), tree, 1, backend="orbax")


def _snapshot(state):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in _paths(state_tree(state)).items()}


@pytest.mark.parametrize("case", ["width", "slot_shape", "student_file",
                                  "optimizer"])
def test_mismatched_template_raises_before_copying(tmp_path, case):
    """A name, shape or structure mismatch raises KeyError/ValueError and
    leaves every tensor of the target as it was, even where the mismatch
    sits in the last field checked."""
    opt = make_optimizer("AdamOptimizer")
    source = _randomize_port(init_distill_state(TINY, opt), 2)
    if case == "slot_shape":
        name = "classifier.experts.b"
        source.opt_student["nu"][name] = torch.zeros(3, 3)
    if case == "student_file":
        source = student_state_from_distill(source, opt)
    if case == "optimizer":
        rms = make_optimizer("RMSPropOptimizer")
        source.opt_teacher = rms.init(dict(source.teacher.named_parameters()))
    path = tckpt.save_checkpoint(str(tmp_path), source, 1)
    cfg = TINY.replace(lstm_cells=4) if case == "width" else TINY
    target = init_distill_state(cfg, opt)
    before = _snapshot(target)
    with pytest.raises((KeyError, ValueError)):
        tckpt.restore_checkpoint(path, target)
    after = _snapshot(target)
    for key, value in before.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(after[key], value), key
        else:
            assert after[key] == value, key
    if case == "student_file":
        with pytest.raises(KeyError, match="params_teacher"):
            tckpt.restore_subtree(path, target, ["params_teacher"])
        # the fields it has restore on their own
        tckpt.restore_subtree(path, target, ["params_student"])
        assert torch.equal(target.student.rnn_l1[0].kernel,
                           source.student.rnn_l1[0].kernel)


def test_async_saver_writes_the_sync_bytes_and_reraises(tmp_path):
    opt = make_optimizer("AdamOptimizer")
    state = _randomize_port(init_distill_state(TINY, opt), 4)
    sync = tckpt.save_checkpoint(str(tmp_path / "sync"), state, 7)
    saver = tckpt.AsyncCheckpointSaver()
    saver.save(str(tmp_path / "async"), state, state.global_step)
    with torch.no_grad():  # the next step's in-place update: not in the file
        state.student.rnn_l1[0].kernel.add_(1.0)
    saver.wait()
    async_path = tckpt.latest_checkpoint(str(tmp_path / "async"))
    with open(sync, "rb") as a, open(async_path, "rb") as b:
        assert a.read() == b.read()
    (tmp_path / "file").write_text("not a directory")
    saver.save(str(tmp_path / "file" / "sub"), state, 8)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # the failure is raised once
    off = tckpt.AsyncCheckpointSaver(enabled=False)
    off.save(str(tmp_path / "off"), state, 9)
    assert os.path.exists(tmp_path / "off" / "model.ckpt-9.msgpack")


# ---------------------------------------------------------------- summary

def _histograms(logdir):
    """{tag: {field number: value}} of every histogram event in logdir."""
    out = {}
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    for record in TFRecordReader(path):
        for fn, wt, v in iter_fields(record):
            if fn != 5:
                continue
            for _, _, sv in iter_fields(bytes(v)):
                tag, histo = None, {}
                for vfn, _, vv in iter_fields(bytes(sv)):
                    if vfn == 1:
                        tag = bytes(vv).decode()
                    elif vfn == 5:
                        for hfn, hwt, hv in iter_fields(bytes(vv)):
                            histo[hfn] = (np.frombuffer(bytes(hv), "<f8")
                                          if hwt == 2 else
                                          np.frombuffer(bytes(hv), "<f8")[0])
                out[tag] = histo
    return out


def test_variable_histograms_match_jax(tmp_path):
    """The port's device statistics give the histogram fields of the JAX
    package's for the same parameters: counts, num, min and max exactly;
    the f32 sums in another order to 1e-6 of sqrt(num * sum_squares), a
    bound of the sum of |x| (1.2e-6 absolute measured on a sum of -1.03
    over 512 values). Tags and order are JAX's."""
    state = init_distill_state(TINY, make_optimizer("AdamOptimizer"))
    with torch.no_grad():  # a non-finite value is dropped by both
        state.teacher.classifier.experts.b[0, 0] = float("nan")
        state.teacher.rnn_l1[0].bias[1] = float("inf")
    jtree = jax.tree.map(jnp.asarray, to_jax_params(state.teacher))
    writers = {}
    for pkg, lib, params in (("jax", jsummary, jtree),
                             ("port", tsummary, state.teacher)):
        writer = jsummary.SummaryWriter(str(tmp_path / pkg))
        lib.write_variable_histograms(writer, params, "model", 3)
        writer.close()
        writers[pkg] = _histograms(str(tmp_path / pkg))
    assert list(writers["jax"]) == list(writers["port"])
    assert "model/rnn_l1/0/kernel" in writers["port"]
    for tag, want in writers["jax"].items():
        got = writers["port"][tag]
        assert got.keys() == want.keys(), tag
        for field in (1, 2, 3, 6, 7):  # min, max, num, limits, counts
            np.testing.assert_array_equal(got[field], want[field], err_msg=tag)
        scale = np.sqrt(want[3] * want[5])
        for field in (4, 5):  # sum, sum of squares
            assert abs(got[field] - want[field]) <= 1e-6 * max(scale, want[5]), tag
