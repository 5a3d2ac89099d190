"""The port's bash drivers (efficientvideoclassification_youtube8m_torch/
scripts/*.sh) against the JAX package's (scripts/*.sh), with no card: a
fake `python` first on PATH records the argv, LOCAL_RANK and TF_CONFIG
of each call and exits with the code the test asks for. The drivers'
argv equal the JAX drivers' up to the package name, their backup steps
leave the same trees, the port's default directories chain from convert
to finetune and eval (the JAX defaults do not), the launcher gives every
process of the cluster its own rank, and a failing binary fails its
driver."""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from efficientvideoclassification_youtube8m_torch.cli import convert, train
from efficientvideoclassification_youtube8m_torch.data import write_synthetic_frame_shard
from efficientvideoclassification_youtube8m_torch.parallel.distributed import (
    parse_tf_config,
)
from efficientvideoclassification_youtube8m_torch.train.checkpoint import latest_checkpoint

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = "efficientvideoclassification_youtube8m_tpu"
PORT_PACKAGE = "efficientvideoclassification_youtube8m_torch"
JAX_SCRIPTS = ROOT / "scripts"
PORT_SCRIPTS = ROOT / PORT_PACKAGE / "scripts"
DRIVERS = ("run_train.sh", "run_validate.sh", "run_convert_model.sh",
           "run_finetune.sh", "run_eval.sh", "run_train_multihost.sh")

FAKE_PYTHON = f"""#!{sys.executable}
import json, os, sys, time, uuid
if sys.argv[1:2] == ["-c"]:  # the launcher's device count
    print(os.environ.get("FAKE_DEVICE_COUNT", "0"))
    sys.exit(0)
failing = os.environ.get("FAKE_FAIL_RANK")
if failing is not None and failing != os.environ.get("LOCAL_RANK"):
    time.sleep(float(os.environ.get("FAKE_SLEEP", "0")))
record = {{"argv": sys.argv[1:], "local_rank": os.environ.get("LOCAL_RANK"),
          "tf_config": os.environ.get("TF_CONFIG")}}
with open(os.path.join(os.environ["FAKE_RECORDS"], uuid.uuid4().hex + ".json"), "w") as f:
    json.dump(record, f)
if failing is None or failing == os.environ.get("LOCAL_RANK"):
    sys.exit(int(os.environ.get("FAKE_EXIT", "0")))
"""

# the environment the drivers read, set alike for both packages
DIRS = {"TRAIN_DIR": "./model_train", "FT_DIR": "./model_finetune/",
        "DATA": "./data/part*.tfrecord", "EPOCH": "3"}


@pytest.fixture
def fake_python(tmp_path):
    """run(driver path, cwd, **env) -> (CompletedProcess, records)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(FAKE_PYTHON)
    (bin_dir / "python").chmod(0o755)

    def run(script, cwd, **env):
        records = cwd / ".records"
        records.mkdir(parents=True)
        full = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
                    FAKE_RECORDS=str(records), **env)
        for name in ("TF_CONFIG", "LOCAL_RANK"):
            if name not in env:
                full.pop(name, None)
        proc = subprocess.run(["bash", str(script)], cwd=cwd, env=full,
                              capture_output=True, text=True, timeout=60)
        calls = [json.loads(p.read_text()) for p in sorted(records.iterdir())]
        for p in records.iterdir():
            p.unlink()
        records.rmdir()
        return proc, calls

    return run


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_argv_equals_the_jax_drivers(fake_python, tmp_path, name):
    """Each driver runs the port's binary with the JAX driver's argv (the
    package name swapped); the launcher at one process a host also gives
    the JAX launcher's TF_CONFIG and LOCAL_RANK 0."""
    env = dict(DIRS, NUM_HOSTS="2", HOST_INDEX="1", NPROC_PER_HOST="1",
               COORDINATOR="10.0.0.1:7077")
    runs = {}
    for pkg, scripts in (("jax", JAX_SCRIPTS), ("port", PORT_SCRIPTS)):
        cwd = tmp_path / pkg
        cwd.mkdir()
        proc, calls = fake_python(scripts / name, cwd, **env)
        assert proc.returncode == 0, proc.stderr
        assert len(calls) == 1
        runs[pkg] = calls[0]
    jax, port = runs["jax"], runs["port"]
    assert jax["argv"][:3] == ["-u", "-m", f"{JAX_PACKAGE}.cli." + {
        "run_convert_model.sh": "convert", "run_train_multihost.sh": "train"}.get(
            name, name[4:-3])]
    assert port["argv"] == [a.replace(JAX_PACKAGE, PORT_PACKAGE) for a in jax["argv"]]
    assert JAX_PACKAGE not in " ".join(port["argv"])
    if name == "run_train_multihost.sh":
        assert port["tf_config"] == jax["tf_config"]
        assert port["local_rank"] == "0"
        assert parse_tf_config({"TF_CONFIG": port["tf_config"]})["process_id"] == 1
    else:
        assert port["tf_config"] is None and port["local_rank"] is None


def tree(root: Path):
    """{relative path: bytes, or None for a directory} under `root`."""
    return {str(p.relative_to(root)): None if p.is_dir() else p.read_bytes()
            for p in sorted(root.rglob("*"))}


@pytest.mark.parametrize("name,dir_var,moved", [
    ("run_train.sh", "TRAIN_DIR", "events.out.tfevents.1.host"),
    ("run_finetune.sh", "FT_DIR", "train/events.out.tfevents.1.host"),
])
def test_backup_trees_equal_the_jax_drivers(fake_python, tmp_path, name, dir_var, moved):
    """The per-epoch backup protocol on pre-made checkpoint files (a
    msgpack file, an orbax directory, the pointer file, an events file):
    the same tree as the JAX driver's, log file included."""
    trees = {}
    for pkg, scripts in (("jax", JAX_SCRIPTS), ("port", PORT_SCRIPTS)):
        cwd = tmp_path / pkg
        model = cwd / DIRS[dir_var]
        (model / "model.ckpt-4").mkdir(parents=True)
        (model / "model.ckpt-4" / "_METADATA").write_text("{}")
        (model / "model.ckpt-4.msgpack").write_bytes(b"\x81\xa1s\x04")
        (model / "checkpoint").write_text('model_checkpoint_path: "model.ckpt-4"\n')
        (model / "events.out.tfevents.1.host").write_bytes(b"events")
        (model / "eval").mkdir()
        proc, _ = fake_python(scripts / name, cwd, **DIRS)
        assert proc.returncode == 0, proc.stderr
        trees[pkg] = tree(cwd)
    assert trees["port"] == trees["jax"]
    model = DIRS[dir_var].strip("./")
    backup = f"{model}/backup_epc3/"
    backed = {k[len(backup):] for k in trees["port"] if k.startswith(backup)}
    assert {"model.ckpt-4.msgpack", "model.ckpt-4/_METADATA", "checkpoint",
            moved} <= backed
    assert f"{model}/events.out.tfevents.1.host" not in trees["port"]


def default_of(script: Path, var: str) -> str:
    (value,) = re.findall(rf"^{var}=\${{{var}:-(\S+)}}$", script.read_text(), re.M)
    return value


TINY = ["--num_classes", "8", "--batch_size", "4", "--lstm_cells", "8",
        "--lstm_layers", "2", "--max_num_frames", "20", "--num_inputs_to_lstm", "4",
        "--num_inputs_L1", "2", "--every_n", "2", "--feature_names", "rgb, audio",
        "--feature_sizes", "6, 2", "--num_readers", "1", "--compute_dtype", "float32",
        "--device", "cpu"]


def test_port_defaults_chain_from_convert_to_finetune_and_eval(tmp_path, monkeypatch):
    """From run_train.sh's default TRAIN_DIR, cli.convert writes into the
    default FT_DIR of run_finetune.sh and run_eval.sh (a tiny train and
    convert on the CPU, from the directory the drivers run in)."""
    train_dir = default_of(PORT_SCRIPTS / "run_train.sh", "TRAIN_DIR")
    ft_dir = default_of(PORT_SCRIPTS / "run_finetune.sh", "FT_DIR")
    assert default_of(PORT_SCRIPTS / "run_eval.sh", "FT_DIR") == ft_dir
    for name in ("run_validate.sh", "run_convert_model.sh"):
        assert default_of(PORT_SCRIPTS / name, "TRAIN_DIR") == train_dir
    assert convert.finetune_dir(train_dir) == ft_dir
    monkeypatch.chdir(tmp_path)
    write_synthetic_frame_shard("shard.tfrecord", 8, feature_sizes=(6, 2),
                                max_frames=20, vocab_size=8)
    train.main(TINY + ["--train_dir", train_dir, "--train_data_pattern", "shard.tfrecord",
                       "--start_new_model", "true"])
    path = convert.main(TINY + ["--train_dir", train_dir])
    assert os.path.samefile(os.path.dirname(path), ft_dir)
    assert latest_checkpoint(ft_dir) == path


def test_jax_defaults_do_not_chain():
    """The JAX drivers' default TRAIN_DIR ends in a slash, so the
    reference's rule (the JAX cli/convert.py's, the port's
    convert.finetune_dir) puts the student in ./..._every10_/finetune/,
    not in their default FT_DIR: run in order with their defaults, the
    JAX drivers stop at finetune."""
    train_dir = default_of(JAX_SCRIPTS / "run_train.sh", "TRAIN_DIR")
    ft_dir = default_of(JAX_SCRIPTS / "run_finetune.sh", "FT_DIR")
    assert convert.finetune_dir(train_dir) == "./model_HLSTM_TeaStud_every10_/finetune/"
    assert convert.finetune_dir(train_dir) != ft_dir
    assert "train_dir.replace(\"train\", \"\") + \"finetune/\"" in (
        ROOT / JAX_PACKAGE / "cli" / "convert.py").read_text()


def launch(fake_python, cwd, **env):
    proc, calls = fake_python(PORT_SCRIPTS / "run_train_multihost.sh", cwd, **env)
    return proc, sorted(calls, key=lambda c: int(c["local_rank"]))


def test_launcher_gives_every_process_its_own_rank(fake_python, tmp_path):
    """Two hosts of two processes: the four TF_CONFIGs parse to ranks 0-3,
    a world of 4 and one coordinator; each host's LOCAL_RANKs are 0 and 1
    and every process runs the same argv (the global --batch_size)."""
    coordinator = "10.0.0.1:7077"
    parsed, argvs = [], []
    for host in (0, 1):
        proc, calls = launch(fake_python, tmp_path / f"host{host}", NUM_HOSTS="2",
                             HOST_INDEX=str(host), NPROC_PER_HOST="2",
                             COORDINATOR=coordinator)
        assert proc.returncode == 0, proc.stderr
        assert [c["local_rank"] for c in calls] == ["0", "1"]
        for c in calls:
            cfg = parse_tf_config({"TF_CONFIG": c["tf_config"]})
            assert cfg["process_id"] == 2 * host + int(c["local_rank"])
            parsed.append(cfg)
            argvs.append(c["argv"])
    assert sorted(c["process_id"] for c in parsed) == [0, 1, 2, 3]
    assert {c["num_processes"] for c in parsed} == {4}
    assert {c["coordinator"] for c in parsed} == {coordinator}
    hosts = json.loads(calls[0]["tf_config"])["cluster"]
    assert hosts["master"] == [coordinator]
    assert hosts["worker"] == [f"10.0.0.1:{7077 + i}" for i in (1, 2, 3)]
    assert all(a == argvs[0] for a in argvs)
    flags = dict(zip(argvs[0][3::2], argvs[0][4::2]))
    assert (flags["--batch_size"], flags["--checkpoint_format"],
            flags["--start_new_model"]) == ("512", "orbax", "False")


@pytest.mark.parametrize("count,processes", [("3", 3), ("0", 0)])
def test_launcher_counts_the_cards(fake_python, tmp_path, count, processes):
    """Without NPROC_PER_HOST the launcher starts one process a card
    (torch.cuda.device_count(), here the fake's); no card is an error."""
    proc, calls = launch(fake_python, tmp_path, NUM_HOSTS="1", FAKE_DEVICE_COUNT=count)
    assert len(calls) == processes
    if processes:
        assert proc.returncode == 0, proc.stderr
        assert [c["local_rank"] for c in calls] == ["0", "1", "2"]
        assert {parse_tf_config({"TF_CONFIG": c["tf_config"]})["num_processes"]
                for c in calls} == {3}
    else:
        assert proc.returncode == 1 and "no CUDA device" in proc.stderr


@pytest.mark.parametrize("scripts", [JAX_SCRIPTS, PORT_SCRIPTS], ids=["jax", "port"])
def test_launcher_refuses_a_coordinator_without_port(fake_python, tmp_path, scripts):
    proc, calls = fake_python(scripts / "run_train_multihost.sh", tmp_path,
                              COORDINATOR="10.0.0.1", NPROC_PER_HOST="1")
    assert proc.returncode == 1 and not calls
    assert "COORDINATOR must be host:port" in proc.stderr


@pytest.mark.parametrize("name", DRIVERS)
def test_failing_binary_fails_its_driver(fake_python, tmp_path, name):
    """`time python ... &> log` under `set -e`: a binary that exits 3
    fails the driver, before any backup step runs."""
    proc, calls = fake_python(PORT_SCRIPTS / name, tmp_path, FAKE_EXIT="3",
                              NUM_HOSTS="1", NPROC_PER_HOST="1", **DIRS)
    assert proc.returncode == 3
    assert len(calls) == 1
    assert not list(tmp_path.rglob("backup_epc*"))


def test_launcher_fails_when_one_process_fails(fake_python, tmp_path):
    """One failed process of a host fails the launcher with its code and
    stops the host's other processes at once (here they would sleep for
    a minute before they record their call)."""
    t0 = time.perf_counter()
    proc, calls = launch(fake_python, tmp_path, NUM_HOSTS="1", NPROC_PER_HOST="3",
                         FAKE_EXIT="3", FAKE_FAIL_RANK="1", FAKE_SLEEP="60")
    assert proc.returncode == 3
    assert time.perf_counter() - t0 < 30
    assert [c["local_rank"] for c in calls] == ["1"]
