"""The port's fidelity harness (efficientvideoclassification_youtube8m_torch/
scripts/fidelity_check.py) against the JAX package's
(scripts/fidelity_check.py): the same golden log, step regex and band
verdicts, with the same printed lines, on golden-shaped, diverging and
edge trajectories; `run` through the five stages at tiny widths on the
CPU; `main` on the card unless `--device cpu` is given."""

import importlib.util
import logging
import math
import os

import pytest
import torch

from efficientvideoclassification_youtube8m_torch.cli import convert
from efficientvideoclassification_youtube8m_torch.scripts import fidelity_check as port
from efficientvideoclassification_youtube8m_torch.train.checkpoint import latest_checkpoint

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_SCRIPT = os.path.join(ROOT, "scripts", "fidelity_check.py")


@pytest.fixture(scope="module")
def jax():
    spec = importlib.util.spec_from_file_location("jax_fidelity_check", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# tests/test_fidelity.py's golden-shaped trajectory
S2 = {"teacher": 1914.13, "l_rep": 1.16, "l_pred": 0.01, "l_ce": 1914.1}
S4 = {"teacher": 1908.5, "l_rep": 1.49, "l_pred": 0.01, "l_ce": 1913.3}


def steps(s2=None, s4=None):
    return {2: dict(S2, **(s2 or {})), 4: dict(S4, **(s4 or {}))}


# (trajectory, verdict): each band just inside and just outside its edge
CASES = {
    "golden_shaped": (steps(), True),
    # tests/test_fidelity.py's diverging trajectory
    "diverging": ({2: S2, 4: {"teacher": 1920.0, "l_rep": 0.9, "l_pred": 0.4,
                              "l_ce": 1916.0}}, False),
    "step_4_missing": ({2: S2}, False),
    "nothing_logged": ({}, False),
    "teacher_2_inside": (steps({"teacher": 1912.1}), True),
    "teacher_2_outside": (steps({"teacher": 1912.08}), False),
    "l_ce_2_inside": (steps({"l_ce": 1916.09}), True),
    "l_ce_2_outside": (steps({"l_ce": 1916.11}), False),
    "drop_above_1": (steps(s4={"teacher": S2["teacher"] - 1.01}), True),
    "drop_below_1": (steps(s4={"teacher": S2["teacher"] - 0.99}), False),
    "drop_below_20": (steps(s4={"teacher": S2["teacher"] - 19.99}), True),
    "drop_above_20": (steps(s4={"teacher": S2["teacher"] - 20.01}), False),
    "l_ce_4_falls": (steps(s4={"l_ce": S2["l_ce"] - 0.01}), True),
    "l_ce_4_flat": (steps(s4={"l_ce": S2["l_ce"]}), False),
    "l_rep_2_above_0": (steps({"l_rep": 0.01}), True),
    "l_rep_2_zero": (steps({"l_rep": 0.0}), False),
    "l_rep_2_below_3": (steps({"l_rep": 2.99}, {"l_rep": 3.5}), True),
    "l_rep_2_three": (steps({"l_rep": 3.0}, {"l_rep": 3.5}), False),
    "l_rep_grows": (steps(s4={"l_rep": S2["l_rep"] + 0.01}), True),
    "l_rep_flat": (steps(s4={"l_rep": S2["l_rep"]}), False),
    "l_pred_below": (steps({"l_pred": 0.19}, {"l_pred": 0.19}), True),
    "l_pred_2_at_edge": (steps({"l_pred": 0.2}), False),
    "l_pred_4_at_edge": (steps(s4={"l_pred": 0.2}), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verdict_and_lines_equal_the_jax_scripts(jax, capsys, case):
    trajectory, verdict = CASES[case]
    assert jax.check_trajectory(trajectory) is verdict
    want = capsys.readouterr().out
    assert port.check_trajectory(trajectory) is verdict
    assert capsys.readouterr().out == want
    assert ("[FAIL]" in want) == (not verdict)


def test_golden_regex_capture_and_flags_are_the_jax_scripts(jax):
    assert port.GOLDEN == jax.GOLDEN
    assert port.STEP_RE.pattern == jax._STEP_RE.pattern
    fmt = ("training step %d| Hit@1: %.2f| PERR: %.2f| GAP: %.2f| "
           "Teacher_Loss: %s| L_REP: %s| L_PRED: %s| L_CE: %s")
    captures = (jax._StepCapture(), port._StepCapture())
    for step, t, r, p, c in [(2, 1914.13, 1.16, 0.01, 1914.1),
                             (4, 1908.5, 1.49, 0.01, 1913.3), (6, 1, 2, 3, 4)]:
        record = logging.LogRecord("train", 20, "", 0, fmt,
                                   (step, 0.0, 0.0, 0.0, t, r, p, c), None)
        for capture in captures:
            capture.emit(record)
    assert captures[1].steps == captures[0].steps
    assert set(captures[1].steps) == {2, 4, 6}
    source = open(JAX_SCRIPT).read()
    for flag, value in zip(port.FLAGS[0::2], port.FLAGS[1::2]):
        assert f'"{flag}", "{value}",' in source
    assert f"--num_videos\", type=int, default={port.NUM_VIDEOS}" in source


# the tiny widths of tests/test_torch_acceptance.py at the harness's batch
TINY = ["--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
        "--model", "HierarchicalLstmModel", "--num_classes", "40",
        "--batch_size", "5", "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2",
        "--lstm_cells", "8", "--lstm_layers", "2", "--max_num_frames", "40",
        "--every_n", "2", "--num_epochs", "2", "--num_readers", "2",
        "--compute_dtype", "float32", "--scan_unroll", "1"]


def test_run_goes_through_the_five_stages(tmp_path, capsys):
    """`run` at tiny widths on the CPU: 10 videos a split, 2 epochs at
    batch 5 (steps 2-8 logged), the student in the reference's finetune
    directory and finetuned there for one epoch, then evaluated."""
    torch.manual_seed(0)
    workdir = str(tmp_path / "fidelity")
    result = port.run(workdir, TINY, num_videos=10, device="cpu",
                      shard_kwargs=dict(feature_sizes=(6, 2), max_frames=40,
                                        vocab_size=40))
    out = capsys.readouterr().out
    stages = ["train (teacher+student)", "validate", "convert", "finetune", "eval"]
    positions = [out.index(f"=== {stage} ===") for stage in stages]
    assert positions == sorted(positions)
    assert sorted(result["steps"]) == [2, 4, 6, 8]
    assert set(result["steps"][2]) == {"teacher", "l_rep", "l_pred", "l_ce"}
    train_dir = os.path.join(workdir, "model_train") + "/"
    assert result["train_dir"] == train_dir
    assert result["finetune_dir"] == train_dir.replace("train", "") + "finetune/"
    assert result["finetune_dir"] == convert.finetune_dir(train_dir)
    assert latest_checkpoint(result["finetune_dir"]).endswith("model.ckpt-2.msgpack")
    assert result["validate"]["epoch_id"] == 8 and result["eval"]["epoch_id"] == 2
    for epoch in (result["validate"], result["eval"]):
        assert math.isfinite(epoch["avg_loss"]) and 0.0 <= epoch["gap"] <= 1.0
    assert set(result["seconds"]) == {"train", "validate", "convert", "finetune", "eval"}


@pytest.mark.parametrize("argv,device", [([], "/gpu:0"), (["--device", "cpu"], "cpu")])
@pytest.mark.parametrize("s4,code", [(S4, 0), ({**S4, "teacher": 1920.0}, 1)])
def test_main_runs_on_the_card_unless_asked(monkeypatch, tmp_path, capsys, argv,
                                            device, s4, code):
    """main() is run() at the canonical flags on the card by default; only
    --device cpu takes the CPU; a missed band exits 1."""
    seen = {}

    def fake_run(workdir, flags, num_videos, device):
        seen.update(workdir=workdir, flags=flags, num_videos=num_videos, device=device)
        return {"steps": {2: S2, 4: s4}}

    monkeypatch.setattr(port, "run", fake_run)
    assert port.main(["--workdir", str(tmp_path)] + argv) == code
    assert seen == {"workdir": str(tmp_path), "flags": port.FLAGS,
                    "num_videos": port.NUM_VIDEOS, "device": device}
    out = capsys.readouterr().out
    assert ("trajectory check vs the reference golden log: OK" in out) == (code == 0)


def test_default_device_needs_a_card(tmp_path):
    """Without a card the default device raises before any stage runs:
    nothing falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.run(str(tmp_path), num_videos=2)
    assert not os.path.exists(os.path.join(tmp_path, "model_train"))
