"""`LstmModel`, the YouTube-8M starter's frame-level LSTM baseline, which
the port has and the JAX package does not, on the CPU: through the port's
eval step against the benchmark's plain reference
(`portbench/reference/lstm.py`) in float32; in float64 against the JAX
package's own parts (its `ops/lstm` scan and `MoeModel`) on the same
leaves; its kernel routes' plain versions against the plain scan; and
through `cli.eval`, `cli.validate`, `cli.infer` and `cli.finetune`, with
its spans. On the
card (`card`): the kernel route against the plain scan at the published
widths over 300 frames."""

import csv
import math

import numpy as np
import pytest
import torch

from efficientvideoclassification_youtube8m_torch.cli import eval as eval_cli
from efficientvideoclassification_youtube8m_torch.cli import finetune
from efficientvideoclassification_youtube8m_torch.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_torch.cli import infer as infer_cli
from efficientvideoclassification_youtube8m_torch.cli import validate as validate_cli
from efficientvideoclassification_youtube8m_torch.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_torch.models import get_model
from efficientvideoclassification_youtube8m_torch.ops import prng
from efficientvideoclassification_youtube8m_torch.train import step as tstep
from efficientvideoclassification_youtube8m_torch.train.checkpoint import (
    latest_checkpoint,
    read_checkpoint,
    save_checkpoint,
)
from efficientvideoclassification_youtube8m_torch.train.optimizer import make_optimizer
from efficientvideoclassification_youtube8m_torch.train.state import (
    DistillState,
    init_distill_state,
    init_model,
)
from efficientvideoclassification_youtube8m_torch.utils import profiling
from efficientvideoclassification_youtube8m_torch.utils.config import TrainConfig
from portbench import weights_lstm
from portbench.reference import lstm as ref_lstm

torch.set_num_threads(1)

FLAGS = {"feature_sizes": "12, 4", "num_classes": 24, "max_num_frames": 20, "every_n": 1,
         "lstm_cells": 8, "lstm_layers": 2, "moe_num_mixtures": 2}
B, T, D, H, V, M = 6, 20, 16, 8, 24, 2
# the lengths: one frame, every frame, between, and rows past the end
NUM_FRAMES = [1, 20, 7, 19, 12, 3]
# float32 on both sides, the same products and gate math; the program
# sums the projection and the recurrent product in another order: 6.0e-8
# measured on the predictions (seeds below)
F32_ATOL = 2e-6


def _module(seed, dtype=torch.float32):
    """The program's module holding the benchmark's seeded leaves, with the
    zero biases made random, and the leaves."""
    leaves = weights_lstm.draw(FLAGS, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    for name, t in leaves.items():
        if name.endswith("bias") or name.endswith(".b"):
            leaves[name] = 0.3 * torch.randn(t.shape, generator=g)
    module = get_model("LstmModel")(D, V, lstm_cells=H, lstm_layers=2,
                                    classifier_kwargs={"num_mixtures": M})
    assert set(leaves) == set(dict(module.named_parameters()))
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(leaves[name])
    return module.to(dtype), leaves


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    features = torch.randint(0, 256, (B, T, D), generator=g, dtype=torch.uint8)
    labels = torch.rand(B, V, generator=g) < 0.1
    return features, labels, torch.tensor(NUM_FRAMES, dtype=torch.int32)


def _cfg(dtype="float32"):
    return TrainConfig(model="LstmModel", feature_sizes="12, 4", num_classes=V,
                       max_num_frames=T, every_n=1, lstm_cells=H, lstm_layers=2,
                       moe_num_mixtures=M, compute_dtype=dtype)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 5])
def test_eval_step_matches_the_reference_in_float32(seed):
    module, leaves = _module(seed)
    features, labels, nf = _inputs(seed)
    got = tstep.build_eval_step(_cfg(), host_subsampled=True)(
        module, features, labels, nf)["predictions"]
    want = ref_lstm.predictions(leaves, features, nf, FLAGS)
    assert float((got - want).abs().max()) <= F32_ATOL


def _planted(monkeypatch, module, fault):
    """One fault in the program: the forget bias left out, the state reset
    halfway through the clip (each layer scanned as two halves, the second
    from a zero state), or the state not frozen past a row's length (its
    padding frames stepped)."""
    from efficientvideoclassification_youtube8m_torch.models import frame_level

    real = frame_level.multi_lstm_scan
    if fault == "forget_bias":
        monkeypatch.setattr(frame_level, "multi_lstm_scan",
                            lambda p, x, s, **kw: real(p, x, s, forget_bias=0.0, **kw))
    elif fault == "reset_halfway":
        def halves(p, x, s, **kw):
            half = x.shape[1] // 2
            first = real(p, x[:, :half], s.clamp(max=half), **kw)
            second = real(p, x[:, half:], (s - half).clamp(min=0), **kw)
            return torch.where((s > half)[:, None], second, first)

        monkeypatch.setattr(frame_level, "multi_lstm_scan", halves)
    else:
        real = module.forward
        monkeypatch.setattr(module, "forward", lambda x, nf, **kw: real(
            x, torch.full_like(nf, x.shape[1]), **kw))


@pytest.mark.parametrize("fault", ["forget_bias", "reset_halfway", "unmasked"])
def test_a_planted_fault_fails_the_comparison(monkeypatch, fault):
    module, leaves = _module(0)
    _planted(monkeypatch, module, fault)
    features, labels, nf = _inputs(0)
    got = tstep.build_eval_step(_cfg(), host_subsampled=True)(
        module, features, labels, nf)["predictions"]
    want = ref_lstm.predictions(leaves, features, nf, FLAGS)
    assert float((got - want).abs().max()) > 100 * F32_ATOL


@pytest.mark.parametrize("seed", [0, 3])
def test_forward_matches_the_jax_parts_in_float64(seed):
    """The JAX package has no flat LSTM model: the port's LstmModel in
    float64 against the JAX `ops/lstm.multi_lstm_scan` feeding the JAX
    `MoeModel.apply`, on the same leaves and preprocessed frames. The
    state is the same float64 math on both sides (to 1e-12); the JAX
    head returns its products in float32 (`preferred_element_type`), so
    the predictions agree to float32 rounding (3.2e-8 measured)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu.models import get_model as jget
    from efficientvideoclassification_youtube8m_tpu.ops import lstm as jlstm

    module, leaves = _module(seed, torch.float64)
    features, _, nf = _inputs(seed)
    x = tstep.preprocess_batch(_cfg(), features, nf).double()
    with torch.no_grad():
        got = module(x, nf, num_chunks=4, compute_dtype=torch.float64, num_mixtures=M)
    with jax.enable_x64(True):
        rnn = [{"kernel": jnp.asarray(leaves[f"rnn.{i}.kernel"].double().numpy()),
                "bias": jnp.asarray(leaves[f"rnn.{i}.bias"].double().numpy())}
               for i in range(2)]
        state = jlstm.multi_lstm_scan(rnn, jnp.asarray(x.numpy()), jnp.asarray(nf.numpy()),
                                      compute_dtype=jnp.float64)
        head = {"gates": {"w": jnp.asarray(leaves["classifier.gates.w"].double().numpy())},
                "experts": {"w": jnp.asarray(leaves["classifier.experts.w"].double().numpy()),
                            "b": jnp.asarray(leaves["classifier.experts.b"].double().numpy())}}
        want = jget("MoeModel").apply(head, state, V, num_mixtures=M,
                                      compute_dtype=jnp.float64)
        want_state, want_pred = np.asarray(state), np.asarray(want["predictions"])
        want_reg = float(want["regularization_loss"])
    assert got["state"].dtype == torch.float64 and want_state.dtype == np.float64
    np.testing.assert_allclose(got["state"].numpy(), want_state, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["predictions"].numpy(), want_pred, rtol=0, atol=2e-7)
    assert math.isclose(float(got["regularization_loss"]), want_reg, rel_tol=1e-12)


@pytest.mark.parametrize("route", ["use_kernel", "use_kernel_train"])
def test_kernel_routes_plain_versions_match_the_plain_scan(route):
    """On CPU tensors the kernels' wrappers run their plain versions: the
    same bf16 operands and float32 sums as the plain bf16 scan, added in
    another order (3.0e-8 measured on the state, 0 on the predictions)."""
    module, _ = _module(2)
    features, _, nf = _inputs(2)
    x = tstep.preprocess_batch(_cfg(), features, nf)
    kw = dict(num_chunks=4, compute_dtype=torch.bfloat16, num_mixtures=M)
    with torch.no_grad():
        want = module(x, nf, **kw)
        got = module(x, nf, **{route: True}, **kw)
    for key in ("state", "predictions"):
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=1e-5)


def test_published_widths():
    module = get_model("LstmModel")(1152, 4716, classifier_kwargs={"num_mixtures": 2},
                                    device="meta")
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert shapes == {"rnn.0.kernel": (2176, 4096), "rnn.0.bias": (4096,),
                      "rnn.1.kernel": (2048, 4096), "rnn.1.bias": (4096,),
                      "classifier.gates.w": (4096, 3, 4716),
                      "classifier.experts.w": (4096, 2, 4716),
                      "classifier.experts.b": (2, 4716)}
    assert sum(p.numel() for p in module.parameters()) == 113_902_808


def test_the_frame_level_kind_is_the_registrys():
    from efficientvideoclassification_youtube8m_torch.models import MODEL_REGISTRY

    frames = {n for n, cls in MODEL_REGISTRY.items() if cls.frame_level}
    assert frames == {"HierarchicalLstmModel", "LstmModel", "FrameLevelLogisticModel",
                      "DbofModel", "NetVLADModel", "NeXtVLADModel", "NeXtVLADGatedModel",
                      "GatedNetVLADModel"}
    with pytest.raises(ValueError, match="frame-level model"):
        tstep.forward_video_level(_cfg(), None, torch.zeros(2, D))


TINY = ["--model", "LstmModel", "--num_classes", str(V), "--batch_size", "8",
        "--lstm_cells", str(H), "--lstm_layers", "2", "--max_num_frames", str(T),
        "--every_n", "1", "--feature_names", "rgb, audio", "--feature_sizes", "12, 4",
        "--num_readers", "2", "--top_k", "5", "--device", "cpu", "--run_once", "true",
        "--compute_dtype", "float32", "--deterministic_input", "true"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """16 videos (two batches of 8) and a saved state of the tiny model."""
    root = tmp_path_factory.mktemp("lstm_model")
    write_synthetic_frame_shard(str(root / "eval-0.tfrecord"), 16, seed=4,
                                feature_sizes=(12, 4), max_frames=T, vocab_size=V)
    cfg = flags_lib.config_from_args(flags_lib.base_parser("").parse_args(TINY))
    save_checkpoint(str(root / "train"), init_distill_state(cfg, make_optimizer(cfg.optimizer)),
                    3)
    return root


def test_eval_runs_two_batches_with_its_spans(dirs, tmp_path):
    """cli.eval --model LstmModel over two batches under a trace: one
    `lstm.scan` and one `lstm.head` span a batch, inside `step.eval`; on
    the CPU the plain scan runs, so no kernel step is counted."""
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as t:
        epoch = eval_cli.main(TINY + ["--train_dir", str(dirs / "train"),
                                      "--eval_data_pattern", str(dirs / "eval-*.tfrecord")])
    assert all(math.isfinite(epoch[k]) for k in ("avg_hit_at_one", "avg_perr", "gap",
                                                 "avg_loss"))
    spans, counters = t.totals["spans"], t.totals["counters"]
    assert counters["eval.batches"] == 2 and "lstm.step_launches" not in counters
    assert spans["step.eval"]["count"] == 2
    assert spans["lstm.scan"]["count"] == 2 and spans["lstm.head"]["count"] == 2
    recs = profiling.records()
    steps = [r for r in recs if r[0] == "step.eval"]
    for r in recs:
        if r[0] in ("lstm.scan", "lstm.head"):
            assert any(s[1] == r[1] and s[2] <= r[2] and r[3] <= s[3] for s in steps)


def test_validate_and_infer_run(dirs, tmp_path):
    epoch = validate_cli.main(TINY + ["--train_dir", str(dirs / "train"),
                                      "--eval_data_pattern", str(dirs / "eval-*.tfrecord")])
    assert math.isfinite(epoch["avg_loss"])
    out = str(tmp_path / "pred.csv")
    infer_cli.main(TINY + ["--train_dir", str(dirs / "train"),
                           "--input_data_pattern", str(dirs / "eval-*.tfrecord"),
                           "--output_file", out])
    with open(out) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 17  # the header and 16 videos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finetune_trains_it(dirs, tmp_path, dtype):
    """Two steps of cli.finetune --start_new_model through the plain scan's
    autograd (the train kernels take a CUDA device): every leaf moves from
    the module's initial draw."""
    train_dir = str(tmp_path / "model") + "/"
    argv = [dtype if a == "float32" else a for a in TINY]
    finetune.main(argv + ["--train_dir", train_dir, "--start_new_model", "true",
                          "--train_data_pattern", str(dirs / "eval-*.tfrecord"),
                          "--num_epochs", "1", "--save_summaries_secs", "0"])
    ckpt = latest_checkpoint(train_dir)
    assert ckpt.endswith("model.ckpt-2.msgpack")
    trained = read_checkpoint(ckpt)["params_student"]
    cfg = flags_lib.config_from_args(flags_lib.base_parser("").parse_args(argv))
    start = init_model(cfg, prng.split(prng.prng_key(cfg.seed))[1])
    for name, p0 in start.named_parameters():
        node = trained
        for part in name.split("."):
            node = node[part]
        assert not np.array_equal(np.asarray(node), p0.detach().numpy()), name


# the kernel against the plain bf16 scan over 300 steps: both sum the same
# bf16 products in float32, in another order, and carry the difference
# through 600 dependent steps: 4.9e-05 on the state and 6.1e-06 on the
# predictions measured on the card (H100 80GB HBM3); ten times that here
CARD_STATE_ATOL = 5e-4
CARD_PRED_ATOL = 6e-5


@pytest.mark.card
def test_kernel_route_at_the_published_widths_on_the_card(tmp_path):
    """The published widths over all 300 frames at a batch of 32: the
    forward-only kernel route (`lstm.step_launches` 300 a layer, one kernel
    call a layer) against the plain bf16 scan on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan

    device = torch.device("cuda", 0)
    flags = dict(FLAGS, feature_sizes="1024, 128", num_classes=4716, max_num_frames=300,
                 lstm_cells=1024)
    module = get_model("LstmModel")(1152, 4716, classifier_kwargs={"num_mixtures": 2},
                                    device=device)
    leaves = weights_lstm.draw(flags, 11, device)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(leaves[name])
    g = torch.Generator().manual_seed(11)
    features = torch.randint(0, 256, (32, 300, 1152), generator=g, dtype=torch.uint8)
    nf = torch.tensor([1, 300, 299, 150] + [120 + 6 * i for i in range(28)],
                      dtype=torch.int32)
    cfg = TrainConfig(model="LstmModel", num_classes=4716, max_num_frames=300, every_n=1)
    x = tstep.preprocess_batch(cfg, features.to(device), nf.to(device))
    kw = dict(num_chunks=5, compute_dtype=torch.bfloat16, num_mixtures=2)
    calls = lstm_scan.lstm_chunk_scan.launches
    with torch.no_grad(), profiling.trace(str(tmp_path), device=device) as t:
        got = module(x, nf.to(device), use_kernel=True, **kw)
        torch.cuda.synchronize(device)
    assert lstm_scan.lstm_chunk_scan.launches - calls == 2
    assert t.totals["counters"]["lstm.step_launches"] == 600
    with torch.no_grad():
        want = module(x, nf.to(device), **kw)
    state = float((got["state"] - want["state"]).abs().max())
    pred = float((got["predictions"] - want["predictions"]).abs().max())
    print(f"kernel against plain over 300 steps: state {state:.3g}, predictions {pred:.3g}")
    assert state <= CARD_STATE_ATOL and pred <= CARD_PRED_ATOL


@pytest.mark.card
def test_the_binaries_take_the_kernel_at_the_published_widths_on_the_card(tmp_path):
    """cli.eval, cli.validate and cli.infer with --model LstmModel at the
    published widths on the card, over three batches of 64 full-frame
    videos: each forward takes the scan kernel, one call a layer (2 a
    batch in cli.eval and cli.infer, 4 in cli.validate, which runs both
    towers), and cli.eval's traced epoch counts 600 kernel steps a batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from efficientvideoclassification_youtube8m_torch.ops.kernels import lstm_scan

    for s in range(3):
        write_synthetic_frame_shard(str(tmp_path / f"eval-{s}.tfrecord"), 64, seed=20 + s,
                                    vocab_size=4716)
    argv = ["--model", "LstmModel", "--num_classes", "4716", "--batch_size", "64",
            "--every_n", "1", "--num_readers", "2", "--device", "cuda", "--run_once", "true",
            "--compute_dtype", "bfloat16", "--deterministic_input", "true",
            "--train_dir", str(tmp_path / "train")]
    cfg = flags_lib.config_from_args(flags_lib.base_parser("").parse_args(argv))
    device = torch.device("cuda", 0)
    state = DistillState(teacher=init_model(cfg, device=device),
                         student=init_model(cfg, device=device), opt_teacher={},
                         opt_student={}, global_step=1, dropout_keep_prob=1.0)
    save_checkpoint(str(tmp_path / "train"), state, 1)
    del state
    pattern = str(tmp_path / "eval-*.tfrecord")
    calls = lstm_scan.lstm_chunk_scan.launches
    with profiling.trace(str(tmp_path / "trace"), device=device) as t:
        epoch = eval_cli.main(argv + ["--eval_data_pattern", pattern])
    assert math.isfinite(epoch["avg_loss"])
    assert lstm_scan.lstm_chunk_scan.launches - calls == 2 * 3
    assert t.totals["counters"]["lstm.step_launches"] == 600 * 3
    assert t.totals["spans"]["lstm.scan"]["count"] == 3
    calls = lstm_scan.lstm_chunk_scan.launches
    epoch = validate_cli.main(argv + ["--eval_data_pattern", pattern])
    assert math.isfinite(epoch["avg_loss"])
    assert lstm_scan.lstm_chunk_scan.launches - calls == 4 * 3
    calls = lstm_scan.lstm_chunk_scan.launches
    infer_cli.main(argv + ["--input_data_pattern", pattern,
                           "--output_file", str(tmp_path / "pred.csv")])
    assert lstm_scan.lstm_chunk_scan.launches - calls == 2 * 3
    with open(tmp_path / "pred.csv") as f:
        assert len(list(csv.reader(f))) == 1 + 3 * 64
