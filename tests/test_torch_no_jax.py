"""The PyTorch port must run where JAX is not installed: importing every
module of the port loads no JAX, flax or msgpack. tests/conftest.py imports jax into this
process, so the check runs in a fresh interpreter."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import efficientvideoclassification_youtube8m_torch as port

ROOT = Path(__file__).resolve().parent.parent

CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack"))
assert not loaded, loaded
print(len(sys.argv) - 1)
"""


def test_port_imports_no_jax():
    modules = [port.__name__] + [
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in ("ops.kernels.lstm_scan", "ops.kernels.lstm_train",
                 "ops.kernels.lstm_scan_int8", "ops.quantize", "losses",
                 "metrics.eval_util", "train.optimizer", "train.state",
                 "train.step", "train.msgpack_io", "train.checkpoint",
                 "utils.summary", "parallel.distributed", "cli.flags",
                 "cli.loop", "cli.train", "cli.validate", "cli.convert",
                 "cli.finetune", "cli.eval", "cli.infer", "serving"):
        assert f"{port.__name__}.{name}" in modules
    out = subprocess.run([sys.executable, "-c", CHECK, *modules], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(modules))]
