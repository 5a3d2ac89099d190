"""The port's data-parallel and multi-host layer (parallel/) on the CPU.

Two real ranks over gloo (tests/_torch_parallel_worker.py, each a
subprocess with a 120 s limit, so a deadlock fails the test instead of
the suite) run the data-parallel distill step in float64 and float32,
DBoF's finetune step with and without --sync_batch_norm, and cli.train,
cli.eval and cli.validate over shards that give the ranks unequal work.
Their results are held against the single-process step on the whole
batch, the JAX package's shard_map step on a 2-device virtual CPU mesh
and its global-statistics DBoF step, and the single-process rows of the
same batches. Beside them: `parse_tf_config` against the JAX package's,
the single-process passthroughs, the refusals, and the TF_CONFIG start-up
that times out instead of waiting for a peer that never comes."""

import datetime
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from efficientvideoclassification_youtube8m_tpu import parallel as jparallel
from efficientvideoclassification_youtube8m_tpu import train as jtrain
from efficientvideoclassification_youtube8m_tpu.models import frame_level as jframe_level
from efficientvideoclassification_youtube8m_tpu.parallel import distributed as jdist
from efficientvideoclassification_youtube8m_torch.cli import flags
from efficientvideoclassification_youtube8m_torch.cli import validate as validate_cli
from efficientvideoclassification_youtube8m_torch.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_torch.metrics import EvaluationMetrics
from efficientvideoclassification_youtube8m_torch.ops import collectives
from efficientvideoclassification_youtube8m_torch.parallel import distributed
from efficientvideoclassification_youtube8m_torch.parallel import mesh as tmesh
from efficientvideoclassification_youtube8m_torch.parallel import sharded_step
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    read_checkpoint,
    restore_subtree,
    save_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    StudentState,
    init_distill_state,
    init_model,
    state_tree,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

# float64: the two ranks' halves against one program's whole batch differ
# only by the order of the gradient sums (3.9e-15 of the largest value
# measured); the bar is 1e-10
F64_RTOL = 1e-10
# float32: tests/test_torch_train_step.py's bars (loss 1e-5 relative +
# 2e-6, parameters 1e-5 relative + 2e-5: TF-Adam's normalized step
# magnifies a near-zero gradient element's rounding); L_PRED is a sum of
# nearly cancelling terms whose batch halves round apart (1.6e-7 absolute
# measured)
RTOL, LOSS_ATOL, PARAM_ATOL = 1e-5, 2e-6, 2e-5
LOSS_KEYS = sharded_step.DISTILL_SCALARS
# tests/test_parallel.py's synced-BN bars (SGD, so parameters are gradients)
BN_RTOL, BN_ATOL = 1e-4, 1e-6


def _write_shards(data_dir):
    """The cli runs' shards: rank 0 reads shard 0, rank 1 shard 1."""
    kw = dict(feature_sizes=(6, 2), max_frames=40, vocab_size=30, min_frames=3)
    for i, (n, seed) in enumerate(zip(worker.TRAIN_VIDEOS, worker.CLI_TRAIN_SHARD_SEEDS)):
        write_synthetic_frame_shard(str(data_dir / f"train-{i:04d}.tfrecord"), n,
                                    seed=seed, **kw)
    for i, (n, seed) in enumerate(zip(worker.EVAL_VIDEOS, worker.CLI_EVAL_SHARD_SEEDS)):
        write_synthetic_frame_shard(str(data_dir / f"eval-{i:04d}.tfrecord"), n,
                                    seed=seed, **kw)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results ({name: array}) and the run's directories."""
    out_dir = tmp_path_factory.mktemp("ranks")
    data_dir = tmp_path_factory.mktemp("shards")
    _write_shards(data_dir)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_parallel_worker.py"),
         str(out_dir), str(data_dir)],
        env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 RANK=str(rank), WORLD_SIZE=str(worker.WORLD),
                 PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for rank in range(worker.WORLD)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a parallel worker timed out (a deadlock?)")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {rank}" in out, out[-4000:]
    results = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(worker.WORLD)]
    rows = [dict(np.load(out_dir / f"rank{r}_rows.npz")) for r in range(worker.WORLD)]
    return {"results": results, "rows": rows, "out": out_dir, "data": data_dir}


def _single_distill(dtype):
    """Two single-process distill steps on the whole global batches."""
    orig = worker.float64_forward() if dtype == torch.float64 else None
    try:
        opt, state = worker.distill_state(worker.TINY, dtype)
        step = tstep.build_distill_train_step(worker.TINY, opt, top_k=worker.TOP_K)
        metrics = []
        for seed in worker.DISTILL_SEEDS:
            state, m = step(state, *map(torch.from_numpy, worker.batch(worker.TINY, seed)))
            metrics.append({k: m[k].item() for k in LOSS_KEYS})
        return worker.flat_tree(state_tree(state)), metrics
    finally:
        if orig is not None:
            tstep._model_apply_kwargs = orig


def test_ranks_hold_one_replicated_state(ranks):
    r0, r1 = ranks["results"]
    assert sorted(r0) == sorted(r1)
    for key in r0:
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_two_rank_distill_matches_single_process(ranks, dtype):
    tag = "distill64" if dtype == torch.float64 else "distill32"
    got = ranks["results"][0]
    want, metrics = _single_distill(dtype)
    for key, value in want.items():
        if value.dtype.kind != "f":
            np.testing.assert_array_equal(got[f"{tag}/{key}"], value, err_msg=key)
        elif dtype == torch.float64:
            scale = max(np.abs(value).max(), 1e-30)
            assert np.abs(got[f"{tag}/{key}"] - value).max() <= F64_RTOL * scale, key
        else:
            np.testing.assert_allclose(got[f"{tag}/{key}"], value, rtol=RTOL,
                                       atol=PARAM_ATOL, err_msg=key)
    for i, m in enumerate(metrics):
        for k in LOSS_KEYS:
            if dtype == torch.float64:
                np.testing.assert_allclose(got[f"{tag}/m{i}/{k}"], m[k], rtol=F64_RTOL,
                                           err_msg=k)
            else:
                np.testing.assert_allclose(got[f"{tag}/m{i}/{k}"], m[k], rtol=RTOL,
                                           atol=LOSS_ATOL, err_msg=k)
        assert int(got[f"{tag}/m{i}/global_step"]) == 2 * (i + 1)


def _named(tree, prefix=""):
    """A JAX tree as {"params_teacher/rnn_l1/0/kernel": array, ...}."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in leaves}


def test_two_rank_distill_matches_jax_shardmap(ranks):
    """The JAX package's shard_map distill step on a 2-device virtual CPU
    mesh, from the same seed-0 init and batches."""
    cfg = worker.TINY
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    mesh = jparallel.create_mesh(devices=jax.devices()[:2])
    state = jparallel.place_state(jtrain.init_distill_state(cfg, jo), mesh)
    step = jparallel.build_shardmap_distill_step(cfg, jo, mesh, top_k=worker.TOP_K)
    metrics = []
    for seed in worker.DISTILL_SEEDS:
        state, m = step(state, *jparallel.shard_batch(mesh, *worker.batch(cfg, seed)))
        metrics.append(jax.tree.map(np.asarray, m))
    got = ranks["results"][0]
    want = {**_named(state.params_teacher, "params_teacher/"),
            **_named(state.params_student, "params_student/"),
            **_named(state.opt_student.mu, "opt_student/mu/")}
    for key, value in want.items():
        np.testing.assert_allclose(got[f"distill32/{key}"], value, rtol=RTOL,
                                   atol=PARAM_ATOL, err_msg=key)
    for i, m in enumerate(metrics):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(got[f"distill32/m{i}/{k}"], float(m[k]),
                                       rtol=RTOL, atol=LOSS_ATOL, err_msg=k)
    assert int(got["distill32/global_step"]) == int(state.global_step) == 4


@pytest.fixture(scope="module")
def jax_dbof_global_stats():
    """tests/test_parallel.py's global-batch-statistics program: the JAX
    finetune step on the whole batch, frame sampling pinned to the even
    sampler."""
    cfg = worker.DBOF
    original = jframe_level.sample_random_frames
    jframe_level.sample_random_frames = (
        lambda x, nf, k, rng: jframe_level.sample_even_frames(x, nf, k))
    try:
        jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
        state = jtrain.student_state_from_distill(jtrain.init_distill_state(cfg, jo), jo)
        step = jax.jit(jtrain.build_finetune_step(cfg, jo, top_k=worker.TOP_K))
        state, m = step(state, *map(jnp.asarray, worker.batch(cfg, worker.DBOF_SEED)))
        return _named(state.params_student), float(m["student_label_loss"])
    finally:
        jframe_level.sample_random_frames = original


def test_synced_batch_norm_matches_jax_global_statistics(ranks, jax_dbof_global_stats):
    want, label_loss = jax_dbof_global_stats
    got = ranks["results"][0]
    np.testing.assert_allclose(got["dbof_sync/m/student_label_loss"], label_loss, rtol=2e-4)
    for key, value in want.items():
        np.testing.assert_allclose(got[f"dbof_sync/{key}"], value, rtol=BN_RTOL,
                                   atol=BN_ATOL, err_msg=key)
    # without the flag each rank normalizes with its own half's moments
    worst = max(np.abs(got[f"dbof_unsynced/{key}"] - value).max()
                for key, value in want.items())
    assert worst > 1e-6


def test_uneven_train_shards_stop_every_rank_together(ranks):
    """Rank 1 holds 3 local batches, rank 0 five: both stop after 3
    steps (global step 6), and the master alone wrote the checkpoint."""
    r0, r1 = ranks["results"]
    steps = min(n // 2 for n in worker.TRAIN_VIDEOS)
    assert int(r0["cli/global_step"]) == int(r1["cli/global_step"]) == 2 * steps
    train_dir = ranks["out"] / "train"
    assert sorted(os.listdir(train_dir)).count(f"model.ckpt-{2 * steps}.msgpack") == 1
    assert latest_checkpoint(str(train_dir)).endswith(f"model.ckpt-{2 * steps}.msgpack")


def _single_process_epoch(ranks, kind):
    """The eval epoch of one process over the same per-rank batches: each
    rank's loader (its shard, local batch 2, padded tail, dummy batches
    once dry), the same step on each batch, the valid rows in rank order,
    accumulated as the binary accumulates them."""
    args = flags.base_parser("t").parse_args(worker.CLI_FLAGS + [
        "--eval_data_pattern", str(ranks["data"] / "eval-*.tfrecord")])
    cfg = flags.config_from_args(args)
    ckpt = latest_checkpoint(str(ranks["out"] / "train"))
    student = init_model(cfg)
    if kind == "eval":
        state = StudentState(student=student, opt_student={}, global_step=0,
                             dropout_keep_prob=1.0)
        restore_subtree(ckpt, state, ("params_student",) + validate_cli.EVAL_FIELDS)
        step = tstep.build_eval_step(cfg, top_k=5, host_subsampled=True)
        run = lambda f, l, n: step(student, f, l, n)  # noqa: E731
        stride = cfg.every_n
    else:
        teacher = init_model(cfg)
        state = DistillState(teacher=teacher, student=student, opt_teacher={},
                             opt_student={}, global_step=0, dropout_keep_prob=1.0)
        restore_subtree(ckpt, state, ("params_teacher", "params_student")
                        + validate_cli.EVAL_FIELDS)
        step = tstep.build_validate_step(cfg, top_k=5)
        run = lambda f, l, n: step(teacher, student, f, l, n)  # noqa: E731
        stride = 1
    streams = [list(validate_cli.eval_loader(
        cfg, args, frame_stride=stride, host=distributed.HostContext(
            process_index=r, process_count=worker.WORLD, local_batch_size=2,
            is_master=r == 0))) for r in range(worker.WORLD)]
    dummy = distributed._dummy_batch(validate_cli.eval_loader(
        cfg, args, frame_stride=stride, host=distributed.HostContext(0, 2, 2, True)))
    metrics = EvaluationMetrics(cfg.num_classes, 5)
    for i in range(max(map(len, streams))):
        parts = []
        for stream in streams:
            b = stream[i] if i < len(stream) else dummy
            out = run(*(torch.from_numpy(a) for a in (b.features, b.labels, b.num_frames)))
            rows, _ = distributed.gather_eval_rows(distributed.unpack_host_pack(
                out["host_pack"].numpy(), b.labels), b.pad)
            parts.append(rows)
        rows = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        metrics.accumulate_topk(rows["topk_val"], rows["topk_idx"], rows["labels"],
                                rows["per_example_loss"],
                                perr_precision=rows["perr_precision"])
    return metrics.get(), sum(len(s) for s in streams)


@pytest.mark.parametrize("kind", ["eval", "validate"])
def test_uneven_eval_shards_gather_every_row(ranks, kind):
    """cli.eval and cli.validate on two ranks whose shards hold 7 and 3
    videos: the dry rank feeds padded dummies, the gather drops only
    padding, and the epoch metrics are bit for bit those of one process
    over the same batches, at one batch a launch and at three."""
    want, batches = _single_process_epoch(ranks, kind)
    assert batches == sum(-(-n // 2) for n in worker.EVAL_VIDEOS)
    for r0_r1 in ranks["results"]:
        for key in ("avg_hit_at_one", "avg_perr", "avg_loss", "gap"):
            assert float(r0_r1[f"cli_{kind}/{key}"]) == float(want[key]), key
            # three batches a fetch (the last group holds what is left):
            # the same rank metrics, the mean loss within an f32 ulp's bar
            got = float(r0_r1[f"cli_{kind}_k3/{key}"])
            if key == "avg_loss":
                np.testing.assert_allclose(got, float(want[key]), rtol=1e-6)
            else:
                assert got == float(want[key]), key


def test_parse_tf_config_matches_jax():
    envs = [
        {},
        {"TF_CONFIG": '{"cluster": {"master": ["m:1"]}, "task": {"type": "master"}}'},
        {"TF_CONFIG": '{"cluster": {"master": ["m:1"], "worker": ["a:2", "b:3"]}, '
                      '"task": {"type": "worker", "index": 1}}'},
        {"TF_CONFIG": '{"cluster": {"worker": ["a:2", "b:3"]}, '
                      '"task": {"type": "worker", "index": 0}}'},
        {"TF_CONFIG": '{"cluster": {}}'},
    ]
    for env in envs:
        assert distributed.parse_tf_config(env) == jdist.parse_tf_config(env), env


def test_single_process_helpers_pass_through():
    assert distributed.world_size() == 1 and distributed.is_master()
    host = distributed.host_context(8)
    assert (host.process_index, host.process_count, host.local_batch_size,
            host.multi_host) == (0, 1, 8, False)
    assert list(distributed.sync_host_streams(iter([1, 2, 3]), "train")) == [1, 2, 3]
    assert list(distributed.sync_host_streams(iter([4]), "eval")) == [4]
    assert distributed.broadcast_flag(True) and not distributed.broadcast_flag(False)
    assert distributed.broadcast_str("x/model.ckpt-3") == "x/model.ckpt-3"
    assert distributed.all_ranks_agree(True) and not distributed.all_ranks_agree(False)
    rows, pad = distributed.gather_eval_rows(
        {"a": np.arange(4), "b": np.ones((4, 2))}, 2)
    want, jpad = jdist.gather_eval_rows({"a": np.arange(4), "b": np.ones((4, 2))}, 2)
    assert pad == jpad == 2
    for k in want:
        np.testing.assert_array_equal(rows[k], want[k])
    mesh = tmesh.create_mesh(device="cpu")
    assert mesh.group is None and mesh.shape == {"data": 1, "model": 1}
    # the JAX create_mesh's refusal on one device
    with pytest.raises(ValueError, match="not divisible by model=2"):
        tmesh.create_mesh(model=2, device="cpu")
    # without a group the validate builder is the plain step
    assert sharded_step.build_sharded_validate_step(worker.TINY, mesh).__name__ == "step"


def test_buckets_keep_order_dtype_and_limit():
    ts = [torch.zeros(10), torch.zeros(30), torch.zeros(5, dtype=torch.float64),
          torch.zeros(100), torch.zeros(3)]
    buckets = collectives._buckets(ts, limit=160)
    assert [[t.numel() for t in b] for b in buckets] == [[10, 30], [5], [100], [3]]
    assert [t for b in buckets for t in b] == ts


def test_tf_config_start_up_times_out_instead_of_waiting(monkeypatch):
    """A two-host TF_CONFIG whose peer never comes: rank 0 waits for it
    for the timeout it is given and raises; a worker whose master is not
    there raises too. Both on localhost."""
    port = _free_port()
    for task in ("master", "worker"):
        monkeypatch.setenv("TF_CONFIG", '{"cluster": {"master": ["localhost:%d"], '
                           '"worker": ["localhost:1"]}, "task": {"type": "%s"}}'
                           % (port, task))
        with pytest.raises(torch.distributed.DistError):
            distributed.initialize(device="cpu",
                                   timeout=datetime.timedelta(seconds=2))
        assert not torch.distributed.is_initialized()



def test_dbof_faithful_eval_keys_are_the_global_batch(ranks):
    """Two ranks' halves of DBoF's faithful-mode eval step against the JAX
    sharded eval step over the whole batch on a 2-device virtual mesh,
    whose frame-sampling key folds the GLOBAL batch's frame count and
    whose draws are the global batch's: the same frame samples (top-k
    classes equal, values and losses to f32 rounding). A rank that folds
    its own half's frame count, as before, samples other frames."""
    cfg = worker.DBOF_FAITHFUL
    jo = jtrain.make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    jstate = jtrain.init_distill_state(cfg, jo)
    mesh = jparallel.create_mesh(devices=jax.devices()[:2])
    step = jparallel.build_sharded_eval_step(cfg, mesh, jstate.params_student,
                                             top_k=worker.TOP_K)
    feats, labels, nf = worker.batch(cfg, worker.DBOF_EVAL_SEED)
    want = np.asarray(step(jstate.params_student,
                           *jparallel.shard_batch(mesh, feats, labels, nf))["host_pack"])
    got = [distributed.unpack_host_pack(r["dbof_faithful/eval"], None)
           for r in ranks["rows"]]
    full = distributed.unpack_host_pack(want, labels)
    for key in ("topk_idx", "perr_precision"):
        np.testing.assert_array_equal(np.concatenate([g[key] for g in got]),
                                      full[key], err_msg=key)
    for key in ("topk_val", "per_example_loss"):
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]), full[key],
                                   rtol=RTOL, atol=LOSS_ATOL, err_msg=key)
    # the old rule: one process's step on rank 0's half alone
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    half = worker.rows_of((feats, labels, nf), 0)
    alone = tstep.build_eval_step(cfg, top_k=worker.TOP_K)(state.student, *half)
    assert np.abs(alone["host_pack"].numpy()
                  - ranks["rows"][0]["dbof_faithful/eval"]).max() > 1e-4


def _one_process_infer(binary, train_dir, pattern, out):
    binary.main(worker.CLI_FLAGS + [
        "--batch_size", "8", "--train_dir", train_dir,
        "--input_data_pattern", pattern, "--output_file", out])
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
def test_infer_on_ranks_writes_one_process_csv(ranks, tmp_path, layout):
    """cli.infer as two data ranks and as one model group of two: the
    master's CSV is byte for byte one process's (the rows of every rank in
    batch order), and holds the JAX binary's rows on its 8 virtual
    devices to the CSV bar of tests/test_torch_infer.py."""
    from efficientvideoclassification_youtube8m_tpu.cli import infer as jax_infer

    from efficientvideoclassification_youtube8m_torch.cli import infer

    with open(ranks["out"] / f"infer-{layout}.csv", "rb") as f:
        got = f.read()
    pattern, train_dir = str(ranks["data"] / "eval-*.tfrecord"), str(ranks["out"] / "train")
    want = _one_process_infer(infer, train_dir, pattern, str(tmp_path / "one.csv"))
    assert got == want and len(got.splitlines()) == 1 + sum(worker.EVAL_VIDEOS)
    # the JAX binary restores a student-only checkpoint: the same leaves
    tree = read_checkpoint(latest_checkpoint(train_dir))
    student = {k: tree[k] for k in ("params_student", "opt_student", "global_step",
                                    "dropout_keep_prob")}
    save_checkpoint(str(tmp_path / "student"), student, int(tree["global_step"]))
    jax_rows = _one_process_infer(jax_infer, str(tmp_path / "student"), pattern,
                                  str(tmp_path / "jax.csv"))
    for g, j in zip(got.decode().splitlines()[1:], jax_rows.decode().splitlines()[1:]):
        gv, gp = g.split(",")
        jv, jp = j.split(",")
        assert gv == jv
        np.testing.assert_allclose([float(x) for x in gp.split()[1::2]],
                                   [float(x) for x in jp.split()[1::2]], atol=1e-5)
