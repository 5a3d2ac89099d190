"""One rank of the tensor-parallel gloo runs of
tests/test_torch_tensor_parallel.py.

    MASTER_ADDR=localhost MASTER_PORT=<port> RANK=<r> WORLD_SIZE=<2|4> \
        python tests/_torch_tp_worker.py <pair|quad> <out_dir> <data_dir>

`pair` (two ranks, a (data 1, model 2) mesh): one distill step in
float32 and its gradients and clip in float64, a DBoF finetune step,
the eval and validate steps, the checkpoint saved sharded and whole,
restored into the columns from the file, from a TF-V2 bundle and from
the JAX package's <data_dir>/jax_ckpt, cli.train (4 readers over 2
shards, in their deterministic order and in their own), cli.eval (model
2 and model 1) and cli.validate at --model_parallelism 2. `quad` (four
ranks, a (2, 2) mesh): the mesh's layout, one distill step and one DBoF
finetune step with random frame sampling. Both: the batches the stream
sync yields each rank of a model group. All on the CPU at tiny widths, with min_dim 32 so that the
MoE head, the LSTM kernels and DBoF's cluster layer shard. Writes
<out_dir>/<mode>_rank<r>.npz.
"""

import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)

from _torch_parallel_worker import (  # noqa: E402
    batch,
    flat_tree,
    float64_forward,
    metrics_of,
    rows_of,
)
from efficientvideoclassification_youtube8m_torch.data import FrameBatch  # noqa: E402
from efficientvideoclassification_youtube8m_torch.ops.collectives import (  # noqa: E402
    gather_leaf,
)
from efficientvideoclassification_youtube8m_torch.parallel import distributed  # noqa: E402
from efficientvideoclassification_youtube8m_torch.parallel.mesh import (  # noqa: E402
    create_mesh,
    gather_state,
    shard_state,
)
from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (  # noqa: E402
    DISTILL_SCALARS,
    build_sharded_distill_step,
    build_sharded_eval_step,
    build_sharded_finetune_step,
    build_sharded_validate_step,
)
from efficientvideoclassification_youtube8m_torch.train import step as tstep  # noqa: E402
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.tf_export import (  # noqa: E402
    export_tf_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import (  # noqa: E402
    clip_grads_per_variable,
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (  # noqa: E402
    init_distill_state,
    state_tree,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.utils.config import (  # noqa: E402
    TrainConfig,
)

TOP_K = 5
# small enough that the 32-class MoE head, the LSTM kernels ([16, 32],
# [40, 32]) and DBoF's cluster layer ([8, 32]) shard
MIN_DIM = 32
# tests/test_parallel.py's config, in float32
CFG = TrainConfig(
    num_classes=32, batch_size=8, lstm_cells=8, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
    compute_dtype="float32",
)
# DBoF with random frame sampling, its cluster layer and batch norm wide
# enough to shard; under SGD, as tests/_torch_parallel_worker.py's DBoF
# case, so that the step's parameter change is the gradient (TF-Adam's
# normalized step turns a near-zero gradient's rounding into a full step)
DBOF = CFG.replace(model="DbofModel", dbof_cluster_size=32, dbof_hidden_size=8,
                   iterations=5, optimizer="GradientDescentOptimizer")
# a clip norm below the gradients' norms, so that the clip bites
CLIP = 1e-3
DISTILL_SEED, DBOF_SEED, EVAL_SEED = 0, 9, 5
CLI_FLAGS = [
    "--num_classes", "32", "--batch_size", "4", "--lstm_cells", "8",
    "--lstm_layers", "2", "--max_num_frames", "40",
    "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2", "--every_n", "2",
    "--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
    "--num_readers", "1", "--compute_dtype", "float32", "--top_k", "5",
    "--device", "cpu",
]
# two train shards, read by 4 reader threads; two eval shards, one per
# rank under --model_parallelism 1
TRAIN_VIDEOS, EVAL_VIDEOS = (4, 4), (3, 3)
READERS = ["--num_readers", "4"]
DETERMINISTIC = READERS + ["--deterministic_input", "true"]


class RankLoader:
    """A loader of `count` one-video batches whose video ids name the
    rank that made them (`sync_host_streams` must read only the model
    group's first rank's)."""

    batch_size, vocab_size, total_size, max_frames = 1, 4, 2, 3

    def __init__(self, rank: int, count: int):
        self.ids = [f"rank{rank}-{i}" for i in range(count)]

    def __iter__(self):
        for vid in self.ids:
            yield FrameBatch(video_ids=[vid], labels=np.zeros((1, 4), bool),
                             features=np.zeros((1, 3, 2), np.uint8),
                             num_frames=np.ones((1,), np.int32))


def distill_state(cfg, mesh):
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    return opt, shard_state(init_distill_state(cfg, opt), mesh, MIN_DIM)


def run_distill(mesh, tag):
    opt, state = distill_state(CFG, mesh)
    step = build_sharded_distill_step(CFG, opt, mesh, top_k=TOP_K)
    rows = rows_of(batch(CFG, DISTILL_SEED), mesh.data_index, mesh.data)
    state, metrics = step(state, *rows)
    out = metrics_of(metrics, f"{tag}/m")
    out.update({f"{tag}/{k}": v for k, v in flat_tree(state_tree(state)).items()})
    return out, state


def run_grads(mesh):
    """The distill gradients and their clip, in float64, gathered whole."""
    orig = float64_forward()
    try:
        opt = make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
        state = init_distill_state(CFG, opt)
        state.teacher.double()
        state.student.double()
        shard_state(state, mesh, MIN_DIM)
        _, _, g_t, g_s = tstep.distill_loss_and_grads(
            CFG, state, *rows_of(batch(CFG, DISTILL_SEED), 0, 1), mesh=mesh)
        out = {}
        for tower, grads in (("teacher", g_t), ("student", g_s)):
            shards = getattr(state, tower).model_shards
            clipped = clip_grads_per_variable(grads, CLIP, shards)
            for name in grads:
                out[f"grad/{tower}/{name}"] = gather_leaf(grads[name], shards, name).numpy()
                out[f"clip/{tower}/{name}"] = gather_leaf(clipped[name], shards, name).numpy()
        return out
    finally:
        tstep._model_apply_kwargs = orig


def run_dbof(mesh, tag):
    opt = make_optimizer(DBOF.optimizer, DBOF.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(DBOF, opt), opt)
    shard_state(state, mesh, MIN_DIM)
    step = build_sharded_finetune_step(DBOF, opt, mesh, top_k=TOP_K)
    rows = rows_of(batch(DBOF, DBOF_SEED), mesh.data_index, mesh.data)
    state, metrics = step(state, *rows)
    out = metrics_of(metrics, f"{tag}/m")
    out.update({f"{tag}/{k}": v for k, v in
                flat_tree(state_tree(state)["params_student"]).items()})
    return out


def run_eval(mesh):
    """The eval and validate steps on the seed-0 towers."""
    _, state = distill_state(CFG, mesh)
    feats, labels, nf = rows_of(batch(CFG, EVAL_SEED), 0, 1)
    out = build_sharded_eval_step(CFG, mesh, top_k=TOP_K)(
        state.student, feats, labels, nf)
    got = {f"eval/{k}": out[k].numpy() for k in ("predictions", "per_example_loss",
                                                 "perr_precision")}
    val = build_sharded_validate_step(CFG, mesh, top_k=TOP_K)(
        state.teacher, state.student, feats, labels, nf)
    got.update({f"validate/{k}": val[k].numpy()
                for k in (*DISTILL_SCALARS, "predictions")})
    return got


def run_checkpoint(mesh, state, out_dir):
    """The stepped distill state saved sharded, restored into a fresh
    sharded state (its columns bit for bit), then made whole and saved
    again."""
    sharded_dir = os.path.join(out_dir, "ckpt_model2")
    save_checkpoint(sharded_dir, state, state.global_step)
    local = flat_tree(state_tree(state, gather=False))
    _, fresh = distill_state(CFG, mesh)
    path = os.path.join(sharded_dir, f"model.ckpt-{state.global_step}.msgpack")
    restore_checkpoint(path, fresh)
    restored = flat_tree(state_tree(fresh, gather=False))
    assert sorted(local) == sorted(restored)
    for key in local:
        np.testing.assert_array_equal(restored[key], local[key], err_msg=key)
    gather_state(state)
    assert all(getattr(m, "model_shards", None) is None
               for m in state.teacher.modules())
    save_checkpoint(os.path.join(out_dir, "ckpt_whole"), state, state.global_step)
    # a TF-V2 bundle of the whole state, restored into the columns: the
    # importer's MoE column permutation comes before the cut
    prefix = os.path.join(out_dir, "tf", "model.ckpt")
    if mesh.rank == 0:
        export_tf_checkpoint(prefix, state)
    torch.distributed.barrier()
    _, fresh = distill_state(CFG, mesh)
    restore_checkpoint(prefix, fresh)
    imported = flat_tree(state_tree(fresh, gather=False))
    checked = [k for k in local if k.startswith(("params_", "opt_"))]
    for key in checked:
        np.testing.assert_array_equal(imported[key], local[key], err_msg=key)
    return {"ckpt/restored_local_leaves": np.asarray(len(local)),
            "ckpt/tf_checked_leaves": np.asarray(len(checked))}


def run_restore_jax(mesh, data_dir):
    """The JAX package's checkpoint restored into the columns."""
    _, state = distill_state(CFG, mesh)
    restore_checkpoint(os.path.join(data_dir, "jax_ckpt", "model.ckpt-2.msgpack"),
                       state)
    return {f"jaxrestore/{k}": v
            for k, v in flat_tree(state_tree(state, gather=False)).items()}


def run_streams(mesh):
    """The batches `sync_host_streams` yields on this rank in each mode,
    from a loader of this rank's own batches: 2 + rank of them (so that
    the ranks run dry at different steps)."""
    loader = RankLoader(mesh.rank, 2 + mesh.rank)
    return {f"streams/{mode}": np.asarray(
        [b.video_ids[0] for b in distributed.sync_host_streams(loader, mode, mesh)])
        for mode in ("train", "eval")}


def run_cli(out_dir, data_dir):
    from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
    from efficientvideoclassification_youtube8m_torch.cli import train, validate

    train_dir = os.path.join(out_dir, "cli_train")
    tp = ["--model_parallelism", "2"]
    pattern = ["--train_data_pattern", os.path.join(data_dir, "train-*.tfrecord")]
    state = train.main(CLI_FLAGS + tp + DETERMINISTIC + pattern + [
        "--train_dir", train_dir, "--start_new_model", "true", "--num_epochs", "1"])
    out = {"cli/global_step": np.asarray(state.global_step)}
    # the readers' own order (not --deterministic_input): each rank's
    # whole state, which the ranks of the model group must share
    state = train.main(CLI_FLAGS + tp + READERS + pattern + [
        "--train_dir", os.path.join(out_dir, "cli_train_readers"),
        "--start_new_model", "true", "--num_epochs", "1"])
    out.update({f"cli_readers/{k}": v for k, v in
                flat_tree(state_tree(state, gather=False)).items()})
    eval_argv = CLI_FLAGS + ["--train_dir", train_dir, "--run_once", "true",
                             "--eval_data_pattern",
                             os.path.join(data_dir, "eval-*.tfrecord")]
    for name, binary, extra in (("eval2", eval_cli, tp), ("eval1", eval_cli, []),
                                ("validate2", validate, tp)):
        epoch = binary.main(eval_argv + extra)
        out.update({f"cli_{name}/{k}": np.asarray(v) for k, v in epoch.items()
                    if np.ndim(v) == 0})
    return out


def run_pair(out_dir, data_dir):
    mesh = create_mesh(model=2, device="cpu")
    assert mesh.shape == {"data": 1, "model": 2} and mesh.group is not None
    results, state = run_distill(mesh, "distill")
    results.update(run_grads(mesh))
    results.update(run_dbof(mesh, "dbof"))
    results.update(run_eval(mesh))
    results.update(run_checkpoint(mesh, state, out_dir))
    results.update(run_restore_jax(mesh, data_dir))
    results.update(run_cli(out_dir, data_dir))
    results.update(run_streams(mesh))
    return results


def run_quad():
    mesh = create_mesh(model=2, device="cpu")
    results = {"mesh/layout": np.asarray([mesh.data, mesh.model, mesh.data_index,
                                          mesh.model_index])}
    # the groups' members, as each rank sees them
    for name, group in (("data", mesh.group), ("model", mesh.model_group)):
        members = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
        torch.distributed.all_gather(members, torch.tensor([mesh.rank]), group=group)
        results[f"mesh/{name}_members"] = torch.cat(members).numpy()
    out, _ = run_distill(mesh, "distill")
    results.update(out)
    results.update(run_dbof(mesh, "dbof"))
    results.update(run_streams(mesh))
    return results


def main():
    mode, out_dir, data_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout=datetime.timedelta(seconds=90))
    rank = distributed.rank()
    results = run_pair(out_dir, data_dir) if mode == "pair" else run_quad()
    np.savez(os.path.join(out_dir, f"{mode}_rank{rank}.npz"), **results)
    distributed.shutdown()
    print("WORKER_OK", mode, rank, flush=True)


if __name__ == "__main__":
    main()
