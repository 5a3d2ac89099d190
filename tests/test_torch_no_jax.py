"""The PyTorch port must run where JAX and the JAX package are not
installed: importing every module of the port loads no JAX, flax or
msgpack, and no module of the JAX package; no source of the port, and not
chip_smoke.py, imports that package. tests/conftest.py imports jax into
this process, so the import check runs in a fresh interpreter."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import efficientvideoclassification_youtube8m_torch as port

ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = "efficientvideoclassification_youtube8m_tpu"

CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "msgpack", "efficientvideoclassification_youtube8m_tpu"))
assert not loaded, loaded
print(len(sys.argv) - 1)
"""


def test_port_imports_no_jax():
    modules = [port.__name__] + [
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in ("ops.kernels.lstm_scan", "ops.kernels.lstm_train",
                 "ops.kernels.lstm_scan_int8", "ops.quantize", "losses",
                 "metrics.eval_util", "metrics.average_precision",
                 "metrics.mean_average_precision", "train.optimizer",
                 "train.state", "train.step", "train.msgpack_io",
                 "train.checkpoint", "utils.summary", "utils.config",
                 "parallel.distributed", "parallel.mesh",
                 "parallel.sharded_step", "train.tf_import", "train.tf_export",
                 "utils.profiling", "cli.export_tf", "data.loader", "data.native",
                 "data.tf_checkpoint", "ensemble", "cli.flags", "cli.loop",
                 "cli.train", "cli.validate", "cli.convert", "cli.finetune",
                 "cli.eval", "cli.infer", "cli.inference_bias",
                 "cli.max_ensemble", "cli.inspect_checkpoint",
                 "cli.hash_check", "scripts.acceptance_run",
                 "scripts.fidelity_check", "serving"):
        assert f"{port.__name__}.{name}" in modules
    out = subprocess.run([sys.executable, "-c", CHECK, *modules], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(modules))]


def _imported_names(path: Path):
    """Every module name an import statement of `path` names."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


SOURCES = sorted(Path(port.__path__[0]).rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_the_jax_package(path):
    names = [n for n in _imported_names(path)
             if n.split(".")[0] in (JAX_PACKAGE, "jax", "jaxlib", "flax")]
    assert not names, f"{path.relative_to(ROOT)} imports {names}"


DRIVERS = sorted(Path(port.__path__[0]).rglob("*.sh"))


def test_the_port_has_its_drivers():
    assert [p.name for p in DRIVERS] == sorted([
        "run_train.sh", "run_validate.sh", "run_convert_model.sh",
        "run_finetune.sh", "run_eval.sh", "run_train_multihost.sh"])


@pytest.mark.parametrize("path", DRIVERS, ids=lambda p: str(p.relative_to(ROOT)))
def test_driver_names_nothing_of_the_jax_package(path):
    """The port's shell drivers run the port's binaries only: the JAX
    package's name appears nowhere, and no command names jax."""
    text = path.read_text()
    assert JAX_PACKAGE not in text
    commands = [line for line in text.splitlines() if not line.lstrip().startswith("#")]
    assert not [line for line in commands if "jax" in line.lower()]
