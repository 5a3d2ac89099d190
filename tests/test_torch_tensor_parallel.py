"""The port's tensor parallelism (--model_parallelism > 1) on the CPU.

Two gloo groups run in subprocesses (tests/_torch_tp_worker.py, 120 s
limit each, started together): two ranks on a (data 1, model 2) mesh and
four on a (2, 2) mesh, at tiny widths with min_dim 32, so that the MoE
head, the LSTM kernels and DBoF's cluster layer shard. Their results are
held against the JAX package's GSPMD steps on its virtual CPU devices
(tests/test_parallel.py's bars: losses rtol 2e-4, parameters rtol 1e-4
and atol 1e-6), the port's one-process step, gradients and clip in
float64, the JAX eval and validate steps, and the checkpoint files and
binaries of one process. Beside them: the column rule against the JAX
`shard_state_specs` for every registered model, the refusals JAX makes,
and the mesh's default device."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import _torch_parallel_worker as pworker
import _torch_tp_worker as worker
from efficientvideoclassification_youtube8m_tpu import parallel as jparallel
from efficientvideoclassification_youtube8m_tpu import train as jtrain
from efficientvideoclassification_youtube8m_tpu.models import MODEL_REGISTRY as JAX_MODELS
from efficientvideoclassification_youtube8m_tpu.train import checkpoint as jckpt
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import train as train_cli
from efficientvideoclassification_youtube8m_torch.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.parallel import mesh as tmesh
from efficientvideoclassification_youtube8m_torch.parallel import sharded_step
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.checkpoint import latest_checkpoint
from efficientvideoclassification_youtube8m_torch.train.msgpack_io import load as load_msgpack
from efficientvideoclassification_youtube8m_torch.train.optimizer import (
    clip_grads_per_variable,
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (
    init_distill_state,
    state_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

# tests/test_parallel.py:84-115
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-4, 1e-6
# the float64 gradients of two ranks against one process differ only by
# the order of sums (tests/test_torch_parallel.py's bar)
F64_RTOL = 1e-10
# tests/test_torch_eval_step.py's bar for the eval outputs against JAX's
TOL = 1e-5
LOSS_KEYS = sharded_step.DISTILL_SCALARS
MESHES = {"pair": (1, 2), "quad": (2, 2)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _write_data(data_dir):
    kw = dict(feature_sizes=(6, 2), max_frames=40, vocab_size=32, min_frames=3)
    for i, n in enumerate(worker.TRAIN_VIDEOS):
        write_synthetic_frame_shard(str(data_dir / f"train-{i:04d}.tfrecord"), n,
                                    seed=11 + i, **kw)
    for i, n in enumerate(worker.EVAL_VIDEOS):
        write_synthetic_frame_shard(str(data_dir / f"eval-{i:04d}.tfrecord"), n,
                                    seed=21 + i, **kw)
    # a JAX checkpoint with nonzero Adam slots: one JAX step from seed 0
    jo = jtrain.make_optimizer(worker.CFG.optimizer, worker.CFG.clip_gradient_norm)
    step = jax.jit(jtrain.build_distill_train_step(worker.CFG, jo, top_k=worker.TOP_K))
    state, _ = step(jtrain.init_distill_state(worker.CFG, jo),
                    *map(jnp.asarray, pworker.batch(worker.CFG, 1)))
    jckpt.save_checkpoint(str(data_dir / "jax_ckpt"), state, 2)
    return state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{mode: [rank results]} of both groups, and the run's directories."""
    out_dir = tmp_path_factory.mktemp("tp_ranks")
    data_dir = tmp_path_factory.mktemp("tp_data")
    jax_state = _write_data(data_dir)
    procs = []
    for mode, (data, model) in MESHES.items():
        port = _free_port()
        for rank in range(data * model):
            procs.append((mode, rank, subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "_torch_tp_worker.py"),
                 mode, str(out_dir), str(data_dir)],
                env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                         RANK=str(rank), WORLD_SIZE=str(data * model),
                         PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                cwd=REPO)))
    outs = []
    for _, _, p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for *_, q in procs:
                q.kill()
            pytest.fail("a tensor-parallel worker timed out (a deadlock?)")
    for (mode, rank, p), out in zip(procs, outs):
        assert p.returncode == 0 and f"WORKER_OK {mode} {rank}" in out, out[-4000:]
    results = {mode: [dict(np.load(out_dir / f"{mode}_rank{r}.npz"))
                      for r in range(data * model)]
               for mode, (data, model) in MESHES.items()}
    return {"results": results, "out": out_dir, "data": data_dir,
            "jax_state": jax_state}


def _named(tree, prefix=""):
    """A JAX tree as {"params_teacher/rnn_l1/0/kernel": array, ...}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                              for k in path): v for path, v in leaves}


def _jax_mesh(mode):
    data, model = MESHES[mode]
    return jparallel.create_mesh(data=data, model=model,
                                 devices=jax.devices()[:data * model])


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
@pytest.mark.parametrize("model_size,min_dim", [(2, 32), (3, 16)])
def test_rule_matches_jax_shard_state_specs(name, model_size, min_dim):
    """The port's column rule over its state tree equals the JAX
    `shard_state_specs` over the JAX state, leaf for leaf, and
    `shard_state` shards exactly the parameters the rule names, for every
    model of the JAX registry (a model only the port has gets its own
    case below)."""
    # the split heads' bands are those of the 4716-class vocab
    cfg = worker.DBOF.replace(model=name,
                              num_classes=4716 if name.startswith("Split") else 32)
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    want = _named(jparallel.shard_state_specs(jtrain.init_distill_state(cfg, jo),
                                              model_size, min_dim))
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    got = _flat_specs(tmesh.shard_state_specs(state, model_size, min_dim))
    want = {k: tuple(v) for k, v in want.items()}
    assert got == want
    assert any(v for v in got.values()) or model_size != 2
    mesh = tmesh.Mesh(group=None, rank=1, world_size=model_size, device=torch.device("cpu"),
                      data=1, model=model_size, model_group=None)
    sharded = tmesh.shard_module(state.student, mesh, min_dim)
    names = {k[len("params_student/"):].replace("/", ".") for k, v in got.items()
             if k.startswith("params_student/") and v}
    assert sharded.names == names


@pytest.mark.parametrize("model_size,min_dim", [(2, 32), (3, 16)])
def test_rule_over_the_gated_nextvlad(model_size, min_dim):
    """NeXtVLADGatedModel, which the JAX package lacks, at its published
    cluster and hidden widths over 12 + 4 features: the rule shards each
    leaf (parameter and optimizer slot) whose last dim is at least
    `min_dim` and divides by the model size, the 1-D batch-norm leaves of
    the codes among them, and `shard_module` shards exactly those."""
    cfg = worker.DBOF.replace(model="NeXtVLADGatedModel", feature_sizes="12, 4",
                              video_level_classifier_model="LogisticModel")
    state = init_distill_state(cfg, make_optimizer(cfg.optimizer, cfg.clip_gradient_norm))
    got = _flat_specs(tmesh.shard_state_specs(state, model_size, min_dim))
    leaves = _flat_specs(state_tree(state))
    want = {k: ((None,) * (v.ndim - 1) + ("model",)
                if np.ndim(v) and v.shape[-1] >= min_dim and v.shape[-1] % model_size == 0
                else ()) for k, v in leaves.items()}
    assert got == want
    sharded = {k for k, v in got.items() if v and k.startswith("params_student/")}
    if min_dim == 32 and model_size == 2:
        # the video code is 3 x 128 wide, the audio code 2 x 64, the hidden 2048
        assert {"params_student/video/vlad_bn/scale", "params_student/audio/vlad_bn/scale",
                "params_student/hidden/w", "params_student/classifier/fc/w"} <= sharded
    mesh = tmesh.Mesh(group=None, rank=1, world_size=model_size, device=torch.device("cpu"),
                      data=1, model=model_size, model_group=None)
    shards = tmesh.shard_module(state.student, mesh, min_dim)
    assert shards.names == {k[len("params_student/"):].replace("/", ".") for k in sharded}


def _flat_specs(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat_specs(value, path))
        else:
            out[path] = value
    return out


@pytest.fixture(scope="module")
def jax_distill():
    """The JAX GSPMD distill step at (1, 2) and (2, 2) from the seed-0
    init, min_dim 32."""
    cfg = worker.CFG
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    out = {}
    for mode in MESHES:
        host = jtrain.init_distill_state(cfg, jo)  # the step donates its state
        mesh = _jax_mesh(mode)
        step = jparallel.build_sharded_distill_step(cfg, jo, mesh, host, top_k=worker.TOP_K,
                                                    min_dim=worker.MIN_DIM)
        state, metrics = step(jparallel.place_state(host, mesh, min_dim=worker.MIN_DIM),
                              *jparallel.shard_batch(mesh, *pworker.batch(cfg, worker.DISTILL_SEED)))
        out[mode] = ({**_named(state.params_teacher, "params_teacher/"),
                      **_named(state.params_student, "params_student/")},
                     {k: float(metrics[k]) for k in LOSS_KEYS})
    return out


@pytest.mark.parametrize("mode", list(MESHES))
def test_distill_step_matches_jax_gspmd(ranks, jax_distill, mode):
    want, losses = jax_distill[mode]
    for got in ranks["results"][mode]:
        for k in LOSS_KEYS:
            np.testing.assert_allclose(got[f"distill/m/{k}"], losses[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        for key, value in want.items():
            np.testing.assert_allclose(got[f"distill/{key}"], np.asarray(value),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)
        assert int(got["distill/global_step"]) == 2


@pytest.mark.parametrize("mode", list(MESHES))
def test_dbof_finetune_matches_jax_gspmd(ranks, mode):
    """DBoF with random frame sampling: gather-on-use of the cluster layer
    and its batch norm, the sharded moving statistics, and (at (2, 2)) the
    global batch's draws and batch moments."""
    cfg = worker.DBOF
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    host = jtrain.student_state_from_distill(jtrain.init_distill_state(cfg, jo), jo)
    mesh = _jax_mesh(mode)
    step = jparallel.build_sharded_finetune_step(cfg, jo, mesh, host, top_k=worker.TOP_K,
                                                 min_dim=worker.MIN_DIM)
    state, metrics = step(jparallel.place_state(host, mesh, min_dim=worker.MIN_DIM),
                          *jparallel.shard_batch(mesh, *pworker.batch(cfg, worker.DBOF_SEED)))
    want = _named(state.params_student)
    assert any(k.startswith("cluster_bn/") for k in want)
    for got in ranks["results"][mode]:
        np.testing.assert_allclose(got["dbof/m/student_label_loss"],
                                   float(metrics["student_label_loss"]), rtol=LOSS_RTOL)
        for key, value in want.items():
            np.testing.assert_allclose(got[f"dbof/{key}"], np.asarray(value),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)


def test_gradients_and_clip_match_one_process(ranks):
    """The float64 gradients of the (1, 2) step, gathered, against one
    process's: a factor of the model size from the l2 term or a local clip
    norm would show far above the bar."""
    orig = pworker.float64_forward()
    try:
        opt = make_optimizer(worker.CFG.optimizer, worker.CFG.clip_gradient_norm)
        state = init_distill_state(worker.CFG, opt)
        state.teacher.double()
        state.student.double()
        _, _, g_t, g_s = tstep.distill_loss_and_grads(
            worker.CFG, state, *pworker.rows_of(pworker.batch(worker.CFG, worker.DISTILL_SEED),
                                                0, 1))
    finally:
        tstep._model_apply_kwargs = orig
    got = ranks["results"]["pair"][0]
    for tower, grads in (("teacher", g_t), ("student", g_s)):
        clipped = clip_grads_per_variable(grads, worker.CLIP)
        for name in grads:
            for kind, want in (("grad", grads[name]), ("clip", clipped[name])):
                want = want.numpy()
                scale = max(np.abs(want).max(), 1e-30)
                err = np.abs(got[f"{kind}/{tower}/{name}"] - want).max()
                assert err <= F64_RTOL * scale, (kind, tower, name, err / scale)
    # the clip bites: some whole-tensor norm is above the limit
    assert any(not np.array_equal(got[f"clip/teacher/{n}"], got[f"grad/teacher/{n}"])
               for n in g_t)


def test_eval_and_validate_match_jax_gspmd(ranks):
    cfg = worker.CFG
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    host = jtrain.init_distill_state(cfg, jo)
    mesh = _jax_mesh("pair")
    batch = jparallel.shard_batch(mesh, *pworker.batch(cfg, worker.EVAL_SEED))
    ev = jparallel.build_sharded_eval_step(cfg, mesh, host.params_student,
                                           top_k=worker.TOP_K, min_dim=worker.MIN_DIM)
    want = ev(host.params_student, *batch)
    va = jparallel.build_sharded_validate_step(cfg, mesh, host.params_teacher,
                                               host.params_student, top_k=worker.TOP_K,
                                               min_dim=worker.MIN_DIM)
    want_v = va(host.params_teacher, host.params_student, *batch)
    for got in ranks["results"]["pair"]:
        for key in ("predictions", "per_example_loss", "perr_precision"):
            np.testing.assert_allclose(got[f"eval/{key}"], np.asarray(want[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)
        np.testing.assert_allclose(got["validate/predictions"],
                                   np.asarray(want_v["predictions"]), rtol=TOL, atol=TOL)
        for key in LOSS_KEYS:
            np.testing.assert_allclose(got[f"validate/{key}"], float(want_v[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)


def test_checkpoint_under_model2_is_byte_equal_and_crosses(ranks):
    """The file the (1, 2) ranks saved from their columns is byte for byte
    the one saved from the gathered state; the JAX package reads it to the
    ranks' whole state; the JAX package's file restores into each rank's
    columns (the TF-V2 bundle and the port's own file were checked in the
    workers)."""
    out = ranks["out"]
    sharded = (out / "ckpt_model2" / "model.ckpt-2.msgpack").read_bytes()
    assert sharded == (out / "ckpt_whole" / "model.ckpt-2.msgpack").read_bytes()
    r0, r1 = ranks["results"]["pair"]
    assert int(r0["ckpt/tf_checked_leaves"]) > 0
    cfg = worker.CFG
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    restored = jckpt.restore_checkpoint(str(out / "ckpt_model2" / "model.ckpt-2.msgpack"),
                                        jtrain.init_distill_state(cfg, jo))
    tree = {**_named(restored.params_teacher, "params_teacher/"),
            **_named(restored.opt_student.mu, "opt_student/mu/")}
    for key, value in tree.items():
        np.testing.assert_array_equal(r0[f"distill/{key}"], np.asarray(value), err_msg=key)
    # the JAX package's file into the columns
    jax_state = ranks["jax_state"]
    specs = _named(jparallel.shard_state_specs(jax_state, 2, worker.MIN_DIM))
    leaves = _named(jax_state)
    cut = 0
    for rank, got in enumerate((r0, r1)):
        for key, value in leaves.items():
            if key not in ("global_step", "dropout_keep_prob") and not key.startswith(
                    ("params_", "opt_")):
                continue
            value = np.asarray(value)
            if tuple(specs[key]):
                w = value.shape[-1] // 2
                value = value[..., rank * w:(rank + 1) * w]
                cut += 1
            np.testing.assert_array_equal(got[f"jaxrestore/{key}"], value, err_msg=key)
    assert cut > 0


def test_cli_binaries_at_model_parallelism_2(ranks, tmp_path):
    """cli.train --model_parallelism 2 over two ranks against one process
    on the same shards (4 readers in their deterministic order); cli.eval
    of its checkpoint under model 2 and model 1 and one process's cli.eval
    agree, and cli.validate runs."""
    data = ranks["data"]
    flags = worker.CLI_FLAGS + worker.DETERMINISTIC + ["--train_dir", str(tmp_path / "one")]
    state = train_cli.main(flags + [
        "--start_new_model", "true", "--num_epochs", "1",
        "--train_data_pattern", str(data / "train-*.tfrecord")])
    r0 = ranks["results"]["pair"][0]
    assert int(r0["cli/global_step"]) == state.global_step == 4
    want = load_msgpack(latest_checkpoint(str(tmp_path / "one")))
    got = load_msgpack(latest_checkpoint(str(ranks["out"] / "cli_train")))
    for key, value in pworker.flat_tree(want["params_student"]).items():
        np.testing.assert_allclose(pworker.flat_tree(got["params_student"])[key], value,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=key)
    one = eval_cli.main(worker.CLI_FLAGS + [
        "--train_dir", str(ranks["out"] / "cli_train"), "--run_once", "true",
        "--eval_data_pattern", str(data / "eval-*.tfrecord")])
    for name in ("eval2", "eval1"):
        for key in ("avg_hit_at_one", "avg_perr", "gap", "avg_loss"):
            np.testing.assert_allclose(r0[f"cli_{name}/{key}"], one[key], rtol=TOL,
                                       atol=TOL, err_msg=f"{name} {key}")
    assert np.isfinite(r0["cli_validate2/avg_loss"])


def test_cli_train_ranks_of_a_model_group_step_on_the_same_rows(ranks):
    """cli.train --model_parallelism 2 with 4 reader threads over 2 shards
    in their own order (the threads race): the ranks of the model group
    step on the batches of one loader, so their whole states are equal
    bit for bit (ranks that read loaders of their own can train on
    different rows in that order, and their replicated leaves then
    part)."""
    r0, r1 = ranks["results"]["pair"]
    keys = sorted(k for k in r0 if k.startswith("cli_readers/"))
    assert keys and keys == sorted(k for k in r1 if k.startswith("cli_readers/"))
    for key in keys:
        np.testing.assert_array_equal(r1[key], r0[key], err_msg=key)


@pytest.mark.parametrize("mode", sorted(MESHES))
def test_model_group_steps_on_its_first_ranks_batches(ranks, mode):
    """`sync_host_streams` over a mesh: each rank's loader holds batches
    of its own (2 + rank of them), and every rank of a model group yields
    those of the group's first rank; train stops at the first dry reader,
    eval pads the dry ones to the longest (a padded batch's id is "")."""
    data, model = MESHES[mode]
    for rank, got in enumerate(ranks["results"][mode]):
        first = rank - rank % model
        readers = [r * model for r in range(data)]
        for stream, steps in (("train", min(2 + r for r in readers)),
                              ("eval", max(2 + r for r in readers))):
            want = [f"rank{first}-{i}" if i < 2 + first else "" for i in range(steps)]
            assert list(got[f"streams/{stream}"]) == want, (rank, stream)


def test_quad_mesh_layout(ranks):
    """Rank r of a (2, 2) mesh: data index r // 2, model index r % 2; its
    data group holds the ranks of its model index, its model group those
    of its data index (JAX's reshape(data, model))."""
    for rank, got in enumerate(ranks["results"]["quad"]):
        assert list(got["mesh/layout"]) == [2, 2, rank // 2, rank % 2]
        assert list(got["mesh/data_members"]) == [rank % 2, rank % 2 + 2]
        assert list(got["mesh/model_members"]) == [2 * (rank // 2), 2 * (rank // 2) + 1]


def test_refusals_match_jax():
    """The combinations the JAX package refuses raise ValueError here too:
    a model axis with int8 eval or the shard_map route, and a mesh that
    the world size does not fill."""
    cfg = worker.CFG
    jmesh = _jax_mesh("pair")
    mesh = tmesh.Mesh(group=None, rank=0, world_size=2, device=torch.device("cpu"),
                      data=1, model=2)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    with pytest.raises(ValueError, match="int8"):
        jparallel.build_sharded_quantized_eval_step(cfg, jmesh, {})
    with pytest.raises(ValueError, match="int8"):
        sharded_step.build_sharded_quantized_eval_step(cfg, mesh)
    with pytest.raises(ValueError, match="shard_map"):
        jparallel.build_shardmap_distill_step(cfg, jo, jmesh)
    with pytest.raises(ValueError, match="shard_map"):
        sharded_step.build_shardmap_distill_step(cfg, opt, mesh)
    with pytest.raises(ValueError, match="shard_map"):
        sharded_step.build_shardmap_finetune_step(cfg, opt, mesh)
    for kwargs in ({"model": 2}, {"data": 3, "model": 2}, {"model": 0}):
        with pytest.raises(ValueError):
            tmesh.create_mesh(device="cpu", **kwargs)
    with pytest.raises(ValueError):
        jparallel.create_mesh(data=3, model=2)
    with pytest.raises(ValueError, match="already"):
        state = init_distill_state(cfg, opt)
        tmesh.shard_module(state.student, mesh, worker.MIN_DIM)
        tmesh.shard_module(state.student, mesh, worker.MIN_DIM)


def test_default_device_is_the_ranks_card(monkeypatch):
    """`create_mesh` and `distributed.initialize` default to LOCAL_RANK's
    CUDA device, as `cli.flags.resolve_device` does, and raise where there
    is none: nothing runs on the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.create_mesh()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize()
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tmesh.create_mesh().device == torch.device("cuda", 3)
    calls = {}
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.update(set_device=d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(dist, "new_group", lambda **kw: "host group")
    monkeypatch.setattr(distributed, "_HOST_GROUP", None)
    distributed.initialize()
    assert calls["backend"] == "nccl" and calls["device_id"] == torch.device("cuda", 3)
    assert calls["set_device"] == torch.device("cuda", 3)
    assert (calls["world_size"], calls["rank"]) == (2, 1)
