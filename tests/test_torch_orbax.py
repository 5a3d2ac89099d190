"""The port's orbax checkpoints (train/orbax_io.py) against the JAX
package, orbax and tensorstore on the CPU: JAX-written directories (a
DistillState and a StudentState, one process; the committed two-process
fixture with a sharded MoE head) read bit for bit; the port's
directories read by the JAX `restore_checkpoint` and `inspect_checkpoint`;
the OCDBT b-tree walk against tensorstore on a store with interior and
version-tree nodes; bfloat16 leaves both ways; the async saver, the
pointer file and `max_to_keep` over msgpack files and orbax directories;
and the errors of a truncated chunk, an unknown compressor, a bad frame
checksum and a missing zstd library."""

import contextlib
import io
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from efficientvideoclassification_youtube8m_tpu import train as jtrain
from efficientvideoclassification_youtube8m_tpu.cli import (
    inspect_checkpoint as jax_inspect,
)
from efficientvideoclassification_youtube8m_tpu.train import checkpoint as jckpt
from efficientvideoclassification_youtube8m_torch.cli import inspect_checkpoint
from efficientvideoclassification_youtube8m_torch.serving import Predictor
from efficientvideoclassification_youtube8m_torch.train import checkpoint as tckpt
from efficientvideoclassification_youtube8m_torch.train import orbax_io
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    state_tree,
    student_state_from_distill,
)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _orbax_fixture_writer as fixture_writer  # noqa: E402

FIXTURES = os.path.join(HERE, "fixtures", "orbax_jax")
CFG = fixture_writer.tiny_config()


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flat(value, path + "/"))
        else:
            out[path] = value
    return out


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        g = got[key]
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(value).dtype and g.shape == np.shape(value), key
        np.testing.assert_array_equal(g, np.asarray(value), err_msg=key)


def _jax_states():
    opt = jtrain.make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    distill = jtrain.init_distill_state(CFG, opt)
    return {"distill": distill, "student": fixture_writer.student_state()}


@pytest.mark.parametrize("kind", ["distill", "student"])
def test_reads_jax_written_directory_bit_for_bit(tmp_path, kind):
    state = _jax_states()[kind]
    path = jckpt.save_checkpoint(str(tmp_path), state, 3, backend="orbax")
    assert os.path.exists(os.path.join(path, "manifest.ocdbt"))
    _assert_bit_equal(_flat(tckpt.read_checkpoint(path)),
                      fixture_writer.flat_values(state))
    # into a port state through load_state_tree, the slots included
    opt = make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    target = init_distill_state(CFG, opt)
    if kind == "student":
        target = student_state_from_distill(target, opt)
    tckpt.restore_checkpoint(tckpt.latest_checkpoint(str(tmp_path)), target)
    _assert_bit_equal(_flat(state_tree(target)), fixture_writer.flat_values(state))


@pytest.mark.parametrize("name,ckpt", [("one", "model.ckpt-7"), ("two", "model.ckpt-2")])
def test_reads_committed_fixtures(name, ckpt):
    """The committed JAX-written directories: one process, and two
    processes whose MoE columns were split over four devices (a grid of
    four chunks, `ocdbt.process_0/` and `ocdbt.process_1/`)."""
    base = os.path.join(FIXTURES, name)
    want = dict(np.load(os.path.join(base, "values.npz")))
    path = tckpt.latest_checkpoint(base)
    assert os.path.basename(path) == ckpt
    _assert_bit_equal(_flat(tckpt.read_checkpoint(path)), want)
    if name == "two":
        names = sorted(os.listdir(path))
        assert "ocdbt.process_0" in names and "ocdbt.process_1" in names
        with open(os.path.join(path, "_METADATA")) as f:
            assert json.load(f)["use_ocdbt"]


def test_fixture_regenerates_to_the_same_values(tmp_path):
    """The one-process fixture, written anew by the JAX package: the same
    values (orbax's metadata holds timestamps, so not the same bytes)."""
    path = fixture_writer.write_one(str(tmp_path / "one"))
    want = dict(np.load(os.path.join(FIXTURES, "one", "values.npz")))
    _assert_bit_equal(_flat(orbax_io.read_orbax(path)), want)
    _assert_bit_equal(dict(np.load(str(tmp_path / "one" / "values.npz"))), want)


def _inspect(binary, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        binary.main(argv)
    return out.getvalue()


def test_jax_reads_port_directories(tmp_path):
    """A port state saved with backend="orbax": JAX's `restore_checkpoint`
    into its template and its template-less `inspect_checkpoint` read it;
    both inspectors print the same lines for it."""
    opt = make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    state = init_distill_state(CFG, opt)
    state.global_step = 5
    path = tckpt.save_checkpoint(str(tmp_path), state, 5, backend="orbax")
    with open(os.path.join(path, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is False
    jopt = jtrain.make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    restored = jckpt.restore_checkpoint(os.path.abspath(path),
                                        jtrain.init_distill_state(CFG, jopt))
    want = {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in _flat(state_tree(state)).items()}
    _assert_bit_equal(fixture_writer.flat_values(restored), want)
    for argv in (["--file_name", path],
                 ["--file_name", path, "--tensor_name", "rnn_l2/1/kernel"]):
        assert _inspect(inspect_checkpoint, argv) == _inspect(jax_inspect, argv)


def test_bfloat16_leaves_both_ways(tmp_path):
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)), jnp.bfloat16)
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(str(tmp_path / "jax"), {"a": {"w": x}})
    checkpointer.wait_until_finished()
    got = orbax_io.read_orbax(str(tmp_path / "jax"))["a"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(x).view(np.int16))
    orbax_io.write_orbax(str(tmp_path / "port"), {"a": {"w": got}})
    back = ocp.StandardCheckpointer().restore(str(tmp_path / "port"))["a"]["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back).view(np.int16),
                                  np.asarray(x).view(np.int16))


def test_ocdbt_walk_matches_tensorstore(tmp_path):
    """A store of 200 keys over 20 commits, nodes of at most 300 bytes and
    values over 16 bytes in data files: interior b-tree nodes, version-
    tree nodes and indirect values. Every key and value as tensorstore
    reads them."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    for t in range(20):
        txn = ts.Transaction()
        for i in range(10):
            kv.with_transaction(txn)[f"key{t:02d}_{i:03d}"] = (
                f"value{t}_{i}" * (1 + i % 3)).encode()
        txn.commit_sync()
    store = orbax_io._Ocdbt(str(tmp_path))
    keys = kv.list().result()
    assert sorted(store.entries) == sorted(k.decode() for k in keys)
    for key in keys:
        assert bytes(store.get(key.decode())) == kv.read(key).result().value


def test_multi_chunk_grid_of_one_process(tmp_path):
    """A leaf sharded over the 8 virtual devices is written as 8 chunks."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("x",))
    x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    arr = jax.device_put(x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x")))
    checkpointer = ocp.StandardCheckpointer()
    checkpointer.save(str(tmp_path / "c"), {"x": arr})
    checkpointer.wait_until_finished()
    np.testing.assert_array_equal(orbax_io.read_orbax(str(tmp_path / "c"))["x"], x)


def test_async_saver_matches_a_synchronous_save(tmp_path):
    opt = make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    state = init_distill_state(CFG, opt)
    sync = tckpt.save_checkpoint(str(tmp_path / "sync"), state, 4, backend="orbax")
    saver = tckpt.AsyncCheckpointSaver()
    saver.save(str(tmp_path / "async"), state, 4, backend="orbax")
    saver.wait()
    got = tckpt.latest_checkpoint(str(tmp_path / "async"))
    assert os.path.basename(got) == os.path.basename(sync) == "model.ckpt-4"
    _assert_bit_equal(_flat(tckpt.read_checkpoint(got)),
                      _flat(tckpt.read_checkpoint(sync)))


def test_pointer_file_and_max_to_keep_over_both_formats(tmp_path):
    """The same sequence of msgpack and orbax saves leaves the same names,
    pointer file and latest checkpoint in both packages."""
    tree = {"w": np.arange(3, dtype=np.float32)}
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for step, keep, backend in ((5, 1, "orbax"), (12, 3, "msgpack"), (9, 3, "orbax"),
                                (30, 2, "orbax"), (31, 3, "msgpack"), (2, 0, "orbax")):
        jckpt.save_checkpoint(str(dirs["jax"].absolute()), tree, step,
                              max_to_keep=keep, backend=backend)
        tckpt.save_checkpoint(str(dirs["port"]), tree, step, max_to_keep=keep,
                              backend=backend)
        listing = {k: sorted(os.listdir(d)) for k, d in dirs.items()}
        assert listing["jax"] == listing["port"], (step, listing)
        pointers = {k: (d / "checkpoint").read_text() for k, d in dirs.items()}
        assert pointers["jax"] == pointers["port"]
        latest = tckpt.latest_checkpoint(str(dirs["port"]))
        assert (os.path.basename(jckpt.latest_checkpoint(str(dirs["jax"])))
                == os.path.basename(latest))
        np.testing.assert_array_equal(tckpt.read_checkpoint(latest)["w"], tree["w"])


def _port_dir(tmp_path):
    return orbax_io.write_orbax(str(tmp_path / "c"),
                                {"w": np.arange(6, dtype=np.float32)})


def test_truncated_chunk_raises(tmp_path):
    path = _port_dir(tmp_path)
    with open(os.path.join(path, "w", "0"), "r+b") as f:
        f.truncate(20)
    with pytest.raises(orbax_io.OrbaxFormatError, match="20 bytes"):
        orbax_io.read_orbax(path)


def test_unknown_compressor_raises(tmp_path):
    path = _port_dir(tmp_path)
    meta_path = os.path.join(path, "w", ".zarray")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["compressor"] = {"id": "blosc", "cname": "lz4"}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(orbax_io.OrbaxFormatError, match="blosc"):
        orbax_io.read_orbax(path)


def test_corrupt_frame_and_missing_zstd_raise(tmp_path, monkeypatch):
    src = os.path.join(FIXTURES, "one", "model.ckpt-7")
    path = str(tmp_path / "c")
    shutil.copytree(src, path)
    # without a zstd library a zstd chunk names itself, never zeros
    monkeypatch.setitem(orbax_io._ZSTD, "lib", None)
    monkeypatch.setitem(orbax_io._ZSTD, "name", None)
    with pytest.raises(orbax_io.ZstdUnavailable, match="manifest.ocdbt"):
        orbax_io.read_orbax(path)
    monkeypatch.undo()
    manifest = os.path.join(path, "manifest.ocdbt")
    with open(manifest, "r+b") as f:
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(orbax_io.OrbaxFormatError, match="crc32c"):
        orbax_io.read_orbax(path)


def test_predictor_from_a_jax_written_directory(tmp_path):
    """`Predictor.from_checkpoint` over the committed JAX-written directory
    serves what it serves over a msgpack file of the same leaves."""
    base = os.path.join(FIXTURES, "one")
    tree = tckpt.read_checkpoint(tckpt.latest_checkpoint(base))
    tckpt.save_checkpoint(str(tmp_path), tree, 7)
    rng = np.random.default_rng(2)
    feats = rng.integers(0, 256, (3, CFG.max_num_frames, CFG.total_feature_size),
                         dtype=np.uint8)
    nf = np.asarray([40, 7, 19], np.int32)
    probs = [Predictor.from_checkpoint(d, CFG, serve_batch=4, device="cpu").predict(feats, nf)
             for d in (base, str(tmp_path))]
    assert os.path.isdir(tckpt.latest_checkpoint(base))
    np.testing.assert_array_equal(probs[0], probs[1])
    assert probs[0].shape == (3, CFG.num_classes) and np.all(np.isfinite(probs[0]))
