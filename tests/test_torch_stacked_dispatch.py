"""`--steps_per_dispatch K > 1` in the port on the CPU: cli.eval (bf16,
int8) and cli.validate at K = 3 against K = 1 over 7 batches (a partial
last group of one batch), the JAX CLI identity tests' bars
(tests/test_stacked_eval.py, tests/test_pipeline_e2e.py: rank metrics
and every AP bit-equal, avg_loss within an f32 ulp's tolerance);
cli.infer at K = 3 against the JAX binary at K = 3 on a checkpoint whose
MoE classes come in identical pairs, so every row's top-k holds exact
probability ties, ranked lowest class first by both; `cli.loop`'s
`stacked_ring` against the JAX package's on streams of every length
class; and cli.eval at K = 3 sending every batch through
`device_prefetch` and launching the per-batch step once a batch."""

import jax
import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_tpu import parallel as jparallel
from efficientvideoclassification_youtube8m_tpu.cli import infer as jax_infer
from efficientvideoclassification_youtube8m_tpu.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_tpu.parallel import distributed as jdist
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state as jax_init_distill_state,
    make_optimizer as jax_make_optimizer,
    save_checkpoint as jax_save_checkpoint,
    student_state_from_distill as jax_student_state_from_distill,
)
from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import flags, infer, loop, validate
from efficientvideoclassification_youtube8m_torch.parallel import sharded_step
from efficientvideoclassification_youtube8m_torch.parallel.mesh import Mesh
from efficientvideoclassification_youtube8m_torch.train.checkpoint import save_checkpoint
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import init_distill_state

torch.set_num_threads(1)

TINY_FLAGS = [
    "--num_classes", "40", "--batch_size", "8", "--lstm_cells", "8",
    "--lstm_layers", "2", "--max_num_frames", "40",
    "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2", "--every_n", "2",
    "--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
    "--num_readers", "1", "--top_k", "5", "--scan_unroll", "1",
    "--device", "cpu", "--run_once", "true",
]
VIDEOS = 53  # 7 batches of 8, the last with 3 padding rows: groups 3 + 3 + 1
# the CSV bar of tests/test_torch_infer.py (6 printed decimals)
TOL_CSV = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("stacked")
    write_synthetic_frame_shard(str(root / "eval-0000.tfrecord"), VIDEOS, seed=5,
                                feature_sizes=(6, 2), max_frames=40, vocab_size=40)
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    opt = make_optimizer(cfg.optimizer)
    save_checkpoint(str(root / "train"), init_distill_state(cfg, opt), 3)
    # a JAX student whose classes 2j and 2j + 1 are the same class
    jopt = jax_make_optimizer(cfg.optimizer)
    state = jax_student_state_from_distill(jax_init_distill_state(cfg, jopt), jopt)
    rng = np.random.default_rng(1)

    def twin(x):
        x = np.asarray(x) + rng.normal(scale=0.3, size=np.shape(x)).astype(np.float32)
        if x.shape[-1] == cfg.num_classes:
            x[..., 1::2] = x[..., 0::2]
        return x

    params = jax.tree.map(twin, state.params_student)
    jax_save_checkpoint(str(root / "twins") + "/", state.replace(params_student=params), 7)
    return {"root": root, "pattern": str(root / "eval-*.tfrecord"),
            "train_dir": str(root / "train"), "twins": str(root / "twins")}


@pytest.mark.parametrize("binary,extra", [
    (eval_cli, ["--compute_dtype", "bfloat16"]),
    (eval_cli, ["--quantize", "int8", "--compute_dtype", "float32"]),
    (validate, ["--compute_dtype", "float32"]),
], ids=["eval-bf16", "eval-int8", "validate"])
def test_stacked_epoch_equals_per_batch(setup, binary, extra):
    argv = TINY_FLAGS + extra + ["--train_dir", setup["train_dir"],
                                 "--eval_data_pattern", setup["pattern"]]
    got = binary.main(argv + ["--steps_per_dispatch", "3"])
    want = binary.main(argv + ["--steps_per_dispatch", "1"])
    assert sorted(got) == sorted(want)
    for key in want:  # Hit@1, PERR, GAP, every AP
        if key != "avg_loss":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["avg_loss"], want["avg_loss"], rtol=1e-6)


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()[1:]
    out = []
    for line in lines:
        vid, pairs = line.split(",", 1)
        tokens = pairs.split(" ")
        out.append((vid, [int(t) for t in tokens[0::2]],
                    np.array([float(t) for t in tokens[1::2]])))
    return out


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_stacked_infer_rows_equal_jax_at_the_same_k(setup, tmp_path, quantize):
    """K = 3 rows from the device top-k: every row holds tied pairs, and
    both packages rank the lower class of a tie first, so the classes are
    the JAX binary's in order; the probabilities to the CSV bar."""
    paths = {}
    for name, binary in (("port", infer), ("jax", jax_infer)):
        paths[name] = str(tmp_path / f"{name}.csv")
        binary.main(TINY_FLAGS + [
            "--compute_dtype", "float32", "--quantize", quantize,
            "--steps_per_dispatch", "3", "--train_dir", setup["twins"],
            "--input_data_pattern", setup["pattern"], "--output_file", paths[name]])
    got, want = _rows(paths["port"]), _rows(paths["jax"])
    assert len(got) == len(want) == VIDEOS
    ties = 0
    for (gv, gc, gp), (wv, wc, wp) in zip(got, want):
        assert gv == wv and gc == wc, (gv, gc, wc)
        np.testing.assert_allclose(gp, wp, atol=TOL_CSV, err_msg=gv)
        ties += sum(gc[r + 1] == gc[r] + 1 and gc[r] % 2 == 0 and gp[r] == gp[r + 1]
                    for r in range(len(gc) - 1))
    assert ties >= VIDEOS  # every row's top-5 holds at least one pair


K = 3


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("length", [0, K - 1, K, 3 * K + 1])
def test_stacked_ring_matches_jax(length, depth):
    """Launch and yield events interleaved as the JAX `stacked_ring`
    interleaves them: a pop only when more than `depth` launches are in
    flight, the last partial stack launched as it is, FIFO order."""
    def run(ring_fn):
        events = []

        def launch(bufs):
            events.append(("launch", tuple(bufs)))
            return len([e for e in events if e[0] == "launch"]) - 1

        for handle in ring_fn(iter(range(length)), K, depth, launch):
            events.append(("yield", handle))
        return events

    got = run(loop.stacked_ring)
    assert got == run(jdist.stacked_ring)
    launches = [e[1] for e in got if e[0] == "launch"]
    assert [x for stack in launches for x in stack] == list(range(length))
    assert [e[1] for e in got if e[0] == "yield"] == list(range(len(launches)))
    in_flight = 0
    for kind, _ in got:
        in_flight += 1 if kind == "launch" else -1
        assert in_flight <= depth + 1


def test_stacked_int8_eval_is_data_parallel_only():
    """As in the JAX package (parallel/sharded_step.py:267-268): the int8
    eval step that every K runs refuses a model axis with the JAX stacked
    builder's message."""
    cfg = flags.config_from_args(flags.base_parser("").parse_args(TINY_FLAGS))
    mesh = Mesh(group=None, rank=0, world_size=2, device=torch.device("cpu"),
                data=1, model=2)
    with pytest.raises(ValueError, match="data-parallel only") as port:
        sharded_step.build_sharded_quantized_eval_step(cfg, mesh)
    jmesh = jparallel.create_mesh(model=2, devices=jax.devices()[:2])
    with pytest.raises(ValueError, match="data-parallel only") as jax_error:
        jparallel.build_sharded_eval_step_stacked(cfg, jmesh, {}, quantized=True)
    assert str(port.value) == str(jax_error.value)


def test_every_batch_is_prefetched_and_launched_once_at_k(setup, monkeypatch):
    """cli.eval at K = 3 over 7 batches: each batch goes through
    `cli.loop.device_prefetch` and the per-batch step runs once a batch,
    the last group holding its one batch and no dummies."""
    prefetched, launched = [], []
    real_prefetch, real_build = loop.device_prefetch, eval_cli.build_sharded_eval_step

    def prefetch(*a, **k):
        for item in real_prefetch(*a, **k):
            prefetched.append(item[1])
            yield item

    def build(*a, **k):
        step = real_build(*a, **k)

        def counted(*args):
            launched.append(args[1].shape)
            return step(*args)
        return counted

    monkeypatch.setattr(loop, "device_prefetch", prefetch)
    monkeypatch.setattr(eval_cli, "build_sharded_eval_step", build)
    eval_cli.main(TINY_FLAGS + ["--compute_dtype", "float32", "--steps_per_dispatch", "3",
                                "--train_dir", setup["train_dir"],
                                "--eval_data_pattern", setup["pattern"]])
    batches = -(-VIDEOS // 8)
    assert len(prefetched) == len(launched) == batches == 7
    assert [pad for _, pad in prefetched] == [0] * 6 + [batches * 8 - VIDEOS]
    assert all(shape[0] == 8 for shape in launched)
