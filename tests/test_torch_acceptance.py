"""The port's convergence gate (scripts/acceptance_run.py) at tiny
dimensions on the CPU: `run` sees every logged train step, fills the
held-out epoch through the port's EvaluationMetrics, reuses its shards,
and replays its trajectory; the band logic on made-up results. The bands
themselves hold only at the flagship recipe, on the card."""

import re

import pytest

from efficientvideoclassification_youtube8m_torch.metrics import eval_util
from efficientvideoclassification_youtube8m_torch.scripts import acceptance_run

TINY = [
    "--feature_names", "rgb, audio", "--feature_sizes", "6, 2",
    "--model", "HierarchicalLstmModel", "--num_classes", "40", "--batch_size", "8",
    "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2", "--lstm_cells", "8",
    "--lstm_layers", "2", "--max_num_frames", "40", "--every_n", "2",
    "--num_readers", "2", "--deterministic_input", "true",
    "--compute_dtype", "float32", "--save_model_secs", "100000",
]
SHARDS = dict(train_videos=32, heldout_videos=12, per_shard=16, vocab=40,
              shard_kwargs=dict(feature_sizes=(6, 2), max_frames=40))
EPOCHS = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("gate"))
    return [acceptance_run.run(workdir, TINY, num_epochs=EPOCHS, device="cpu", **SHARDS)
            for _ in range(2)]


def test_run_sees_every_step_and_the_epoch(runs):
    result = runs[0]
    batches = EPOCHS * SHARDS["train_videos"] // 8
    # the faithful global step advances 2 a batch; every step is logged
    assert result["steps"] == list(range(2, 2 * batches + 1, 2))
    assert result["last"][0] == 2 * batches and 0.0 <= result["last"][1] <= 1.0
    assert result["trajectory_steps"] == batches
    assert re.fullmatch(r"[0-9a-f]{40}", result["trajectory_sha1"])
    epoch = result["epoch"]
    assert {"avg_hit_at_one", "avg_perr", "avg_loss", "aps", "gap"} <= set(epoch)
    assert len(epoch["aps"]) == 40 and 0.0 <= epoch["gap"] <= 1.0
    assert result["map"] == pytest.approx(sum(epoch["aps"]) / 40)
    assert set(result["seconds"]) == {"shards", "train", "validate"}
    # the capture is undone
    assert eval_util.EvaluationMetrics.get.__name__ == "get"


def test_second_run_reuses_the_shards_and_replays(runs, capsys):
    """Deterministic input and a seeded init: the second run's loss
    trajectory and epoch equal the first's."""
    first, second = runs
    assert second["trajectory_sha1"] == first["trajectory_sha1"]
    assert second["epoch"] == first["epoch"]
    acceptance_run.report(second)
    assert "trajectory sha1: " + second["trajectory_sha1"] in capsys.readouterr().out


@pytest.mark.parametrize("step,hit,gap,missed", [
    (338, 0.97, 0.78, []),
    (None, 0.97, 0.78, ["by step 700"]),
    (701, 0.97, 0.78, ["by step 700"]),
    (700, 0.949, 0.74, ["Hit@1"]),
    (10, 0.96, 0.7399, ["GAP >= 0.74"]),
])
def test_bands(step, hit, gap, missed, capsys):
    result = {"first_converged_step": step,
              "epoch": {"avg_hit_at_one": hit, "gap": gap}}
    checks = acceptance_run.band_checks(result)
    assert [ok for ok, _ in checks].count(False) == len(missed)
    if not missed:
        acceptance_run.check_bands(result)
        return
    with pytest.raises(AssertionError) as info:
        acceptance_run.check_bands(result)
    for text in missed:
        assert text in str(info.value)
    assert "[FAIL]" in capsys.readouterr().out


def test_recipe_is_the_jax_scripts():
    """The flags, sizes and bands of scripts/acceptance_run.py."""
    flags = dict(zip(acceptance_run.FLAGSHIP_FLAGS[0::2], acceptance_run.FLAGSHIP_FLAGS[1::2]))
    assert flags["--num_classes"] == "256" and flags["--batch_size"] == "128"
    assert flags["--lstm_cells"] == "1024" and flags["--every_n"] == "10"
    assert flags["--deterministic_input"] == "true"
    assert flags["--compute_dtype"] == "bfloat16"
    assert "--seed" not in flags  # the JAX script's seed 0, hence its init
    assert (acceptance_run.TRAIN_VIDEOS, acceptance_run.HELDOUT_VIDEOS,
            acceptance_run.NUM_EPOCHS) == (2048, 512, 30)
    assert (acceptance_run.CONVERGED_GAP, acceptance_run.CONVERGED_BY_STEP,
            acceptance_run.MIN_HELDOUT_HIT, acceptance_run.MIN_HELDOUT_GAP) == (
                0.995, 700, 0.95, 0.74)


@pytest.mark.parametrize("hit,code", [(0.97, 0), (0.5, 1)])
def test_main_runs_the_recipe_with_extra_flags(monkeypatch, tmp_path, capsys, hit, code):
    """main() appends --extra_flags to the recipe's flags and exits 1 on a
    missed band (the run itself is the card's; here it is replaced)."""
    seen = {}

    def fake_run(workdir, flags, device):
        seen.update(workdir=workdir, flags=flags, device=device)
        return {"first_converged_step": 300, "last": (960, 1.0), "steps": [],
                "trajectory_sha1": "0" * 40, "trajectory_steps": 480,
                "epoch": {"avg_hit_at_one": hit, "avg_perr": 0.8, "gap": 0.8,
                          "aps": [0.8]}, "map": 0.8, "seconds": {}}

    monkeypatch.setattr(acceptance_run, "run", fake_run)
    assert acceptance_run.main(["--workdir", str(tmp_path), "--device", "cpu",
                                "--extra_flags", "--seed 0 --lstm_pallas_train false"]) == code
    assert seen["flags"] == acceptance_run.FLAGSHIP_FLAGS + [
        "--seed", "0", "--lstm_pallas_train", "false"]
    assert seen["device"] == "cpu" and seen["workdir"] == str(tmp_path)
    assert ("acceptance bands: OK" in capsys.readouterr().out) == (code == 0)
