"""One rank of the two-rank gloo runs of tests/test_torch_parallel.py.

    MASTER_ADDR=localhost MASTER_PORT=<port> RANK=<r> WORLD_SIZE=2 \
        python tests/_torch_parallel_worker.py <out_dir> <data_dir>

Joins the group from the environment, then on the CPU: two data-parallel
distill steps in float64 and in float32, each rank on its half of the
global batch; one DBoF finetune step with and without synced batch norm;
cli.train over shards that give the ranks unequal numbers of batches;
cli.eval and cli.validate over unequal eval shards, one batch a launch
and three (`--steps_per_dispatch 3`); DBoF's faithful-mode
eval step (frame samples drawn for the global batch);
cli.infer at (data 2, model 1) and (1, 2), each writing
<out_dir>/infer-<data>x<model>.csv. Writes its results to
<out_dir>/rank<r>.npz, the rows of the DBoF step to
<out_dir>/rank<r>_rows.npz. The configs and batches are defined here and
imported by the test, so both sides see the same ones.
"""

import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from efficientvideoclassification_youtube8m_torch.models import frame_level  # noqa: E402
from efficientvideoclassification_youtube8m_torch.parallel import distributed  # noqa: E402
from efficientvideoclassification_youtube8m_torch.parallel.mesh import create_mesh  # noqa: E402
from efficientvideoclassification_youtube8m_torch.parallel.sharded_step import (  # noqa: E402
    build_sharded_distill_step,
    build_sharded_eval_step,
    build_sharded_finetune_step,
)
from efficientvideoclassification_youtube8m_torch.train import step as tstep  # noqa: E402
from efficientvideoclassification_youtube8m_torch.train.optimizer import (  # noqa: E402
    make_optimizer,
)
from efficientvideoclassification_youtube8m_torch.train.state import (  # noqa: E402
    init_distill_state,
    params_of,
    state_tree,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.utils.config import (  # noqa: E402
    TrainConfig,
)

WORLD = 2
TOP_K = 5
# tests/test_torch_train_step.py's tiny config, at a global batch of 8
TINY = TrainConfig(
    num_classes=30, batch_size=8, lstm_cells=8, lstm_layers=2,
    max_num_frames=40, num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    base_learning_rate=0.01, learning_rate_decay_examples=1000,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
    compute_dtype="float32",
)
# tests/test_parallel.py's synced-BN case: DBoF under SGD, so the step's
# parameter change is the gradient
DBOF = TrainConfig(
    num_classes=32, batch_size=8, lstm_cells=8, max_num_frames=40,
    num_inputs_to_lstm=4, num_inputs_L1=2, every_n=2,
    feature_names="rgb, audio", feature_sizes="6, 2", scan_unroll=1,
    model="DbofModel", dbof_cluster_size=16, dbof_hidden_size=8, iterations=5,
    sync_batch_norm=True, optimizer="GradientDescentOptimizer",
    compute_dtype="float32",
)
# DBoF's faithful-mode eval keys: random frame samples at eval, the key
# folded with the global batch's frame count
DBOF_FAITHFUL = DBOF.replace(faithful_quirks=True, sync_batch_norm=False)
DBOF_EVAL_SEED = 13
DISTILL_SEEDS = (3, 4)  # the global batches of the two distill steps
DBOF_SEED = 9
# cli runs: unequal shards (rank 0 reads shard 0, rank 1 shard 1)
CLI_FLAGS = [
    "--num_classes", "30", "--batch_size", "4", "--lstm_cells", "8",
    "--lstm_layers", "2", "--max_num_frames", "40",
    "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2", "--every_n", "2",
    "--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
    "--num_readers", "1", "--compute_dtype", "float32", "--top_k", "5",
    "--device", "cpu",
]
TRAIN_VIDEOS = (10, 6)  # rank 0: 5 local batches of 2, rank 1: 3
EVAL_VIDEOS = (7, 3)  # rank 0: 4 local batches (one padded), rank 1: 2
CLI_EVAL_SHARD_SEEDS = (21, 22)
CLI_TRAIN_SHARD_SEEDS = (11, 12)


def batch(cfg, seed):
    """The global batch of `cfg.batch_size` videos from `seed` (numpy)."""
    rng = np.random.default_rng(seed)
    B = cfg.batch_size
    feats = rng.integers(0, 256, size=(B, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    labels = np.zeros((B, cfg.num_classes), bool)
    for i in range(B):
        labels[i, rng.choice(cfg.num_classes, 3, replace=False)] = True
    nf = rng.integers(5, cfg.max_num_frames + 1, size=B).astype(np.int32)
    return feats, labels, nf


def rows_of(arrays, rank: int, world: int = WORLD):
    """This rank's contiguous slice of a global batch."""
    n = arrays[0].shape[0] // world
    return tuple(torch.from_numpy(np.ascontiguousarray(a[rank * n:(rank + 1) * n]))
                 for a in arrays)


def float64_forward():
    """Make the steps' models compute in float64 (the modules must be
    float64 too): wraps `train.step._model_apply_kwargs`; returns the
    original to put back."""
    orig = tstep._model_apply_kwargs

    def kwargs(*a, **k):
        kw = orig(*a, **k)
        kw["compute_dtype"] = torch.float64
        return kw

    tstep._model_apply_kwargs = kwargs
    return orig


def distill_state(cfg, dtype):
    """The seed-0 distill state (the JAX package's init), in `dtype`."""
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    if dtype == torch.float64:
        state.teacher.double()
        state.student.double()
        state.opt_teacher = opt.init(params_of(state.teacher))
        state.opt_student = opt.init(params_of(state.student))
    return opt, state


def flat_tree(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flat_tree(value, path))
        elif isinstance(value, torch.Tensor):
            out[path] = value.detach().cpu().numpy()
        else:
            out[path] = np.asarray(value)
    return out


def metrics_of(metrics, prefix):
    return {f"{prefix}/{k}": np.asarray(v.item() if isinstance(v, torch.Tensor)
                                        and v.dim() == 0 else v)
            for k, v in metrics.items() if k not in ("topk_val", "topk_idx",
                                                      "perr_precision")}


def run_distill(rank, dtype, tag):
    orig = float64_forward() if dtype == torch.float64 else None
    try:
        opt, state = distill_state(TINY, dtype)
        step = build_sharded_distill_step(TINY, opt, create_mesh(device="cpu"), top_k=TOP_K)
        out = {}
        for i, seed in enumerate(DISTILL_SEEDS):
            state, metrics = step(state, *rows_of(batch(TINY, seed), rank))
            out.update(metrics_of(metrics, f"{tag}/m{i}"))
        out.update({f"{tag}/{k}": v for k, v in flat_tree(state_tree(state)).items()})
        return out
    finally:
        if orig is not None:
            tstep._model_apply_kwargs = orig


def run_dbof(rank, sync):
    cfg = DBOF if sync else DBOF.replace(sync_batch_norm=False)
    tag = "dbof_sync" if sync else "dbof_unsynced"
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(cfg, opt), opt)
    step = build_sharded_finetune_step(cfg, opt, create_mesh(device="cpu"), top_k=TOP_K)
    state, metrics = step(state, *rows_of(batch(cfg, DBOF_SEED), rank))
    out = metrics_of(metrics, f"{tag}/m")
    out.update({f"{tag}/{k}": v for k, v in
                flat_tree(state_tree(state)["params_student"]).items()})
    return out


def run_dbof_faithful_eval(rank):
    """The eval step on this rank's half of one global batch, over the
    data group of two (DBoF has no validate step: distillation needs the
    hierarchical model's state, in both packages)."""
    cfg = DBOF_FAITHFUL
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    rows = rows_of(batch(cfg, DBOF_EVAL_SEED), rank)
    ev = build_sharded_eval_step(cfg, create_mesh(device="cpu"), top_k=TOP_K)(
        state.student, *rows)
    return {"dbof_faithful/eval": ev["host_pack"].numpy()}


def run_infer(out_dir, data_dir):
    """cli.infer over the eval shards at a global batch of 8, as two data
    ranks and as one model group of two."""
    from efficientvideoclassification_youtube8m_torch.cli import infer

    for data, model in ((2, 1), (1, 2)):
        infer.main(CLI_FLAGS + [
            "--batch_size", "8", "--model_parallelism", str(model),
            "--train_dir", os.path.join(out_dir, "train"),
            "--input_data_pattern", os.path.join(data_dir, "eval-*.tfrecord"),
            "--output_file", os.path.join(out_dir, f"infer-{data}x{model}.csv")])
    return {}


def run_cli(out_dir, data_dir):
    from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
    from efficientvideoclassification_youtube8m_torch.cli import train, validate

    train_dir = os.path.join(out_dir, "train")
    state = train.main(CLI_FLAGS + [
        "--train_dir", train_dir, "--start_new_model", "true", "--num_epochs", "1",
        "--train_data_pattern", os.path.join(data_dir, "train-*.tfrecord")])
    out = {"cli/global_step": np.asarray(state.global_step)}
    out.update({f"cli/{k}": v for k, v in
                flat_tree(state_tree(state)["params_student"]).items()})
    eval_argv = CLI_FLAGS + ["--train_dir", train_dir, "--run_once", "true",
                             "--eval_data_pattern",
                             os.path.join(data_dir, "eval-*.tfrecord")]
    for name, binary in (("eval", eval_cli), ("validate", validate)):
        for tag, extra in (("", []), ("_k3", ["--steps_per_dispatch", "3"])):
            epoch = binary.main(eval_argv + extra)
            out.update({f"cli_{name}{tag}/{k}": np.asarray(v)
                        for k, v in epoch.items() if np.ndim(v) == 0})
    return out


def main():
    out_dir, data_dir = sys.argv[1:3]
    torch.set_num_threads(1)
    distributed.initialize(device="cpu", timeout=datetime.timedelta(seconds=90))
    rank = distributed.rank()
    assert distributed.world_size() == WORLD, distributed.world_size()
    # tests/test_parallel.py's synced-BN comparison pins DBoF's frame
    # sampling to the even sampler: the ranks' sampling keys are
    # decorrelated on purpose and would differ from one program's anyway
    sample_random_frames = frame_level.sample_random_frames
    frame_level.sample_random_frames = (
        lambda x, nf, k, rng: frame_level.sample_even_frames(x, nf, k))
    results = {}
    results.update(run_distill(rank, torch.float64, "distill64"))
    results.update(run_distill(rank, torch.float32, "distill32"))
    results.update(run_dbof(rank, sync=True))
    results.update(run_dbof(rank, sync=False))
    results.update(run_cli(out_dir, data_dir))
    results.update(run_infer(out_dir, data_dir))
    frame_level.sample_random_frames = sample_random_frames
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    # each rank's own rows, which differ between the ranks
    np.savez(os.path.join(out_dir, f"rank{rank}_rows.npz"),
             **run_dbof_faithful_eval(rank))
    distributed.shutdown()
    print("WORKER_OK", rank, flush=True)


if __name__ == "__main__":
    main()
