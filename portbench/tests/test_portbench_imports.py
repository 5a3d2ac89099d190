"""Nothing the benchmark runs loads JAX or the JAX package, the benchmark
reads none of the files that measured the JAX package, and the reference
imports nothing of the program. Module names are compared whole, by
their top-level part: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "efficientvideoclassification_youtube8m_tpu"}
PORT = "efficientvideoclassification_youtube8m_torch"
# the files that measured the JAX package, spelled in pieces so that this
# file does not name them itself
OLD = ["bench" + ".py", "BENCH" + "_", "BASE" + "LINE", "MULTI" + "CHIP_",
       "chip" + "_smoke", "scripts" + "/"]
SOURCES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_old_bench_file_named(path):
    text = path.read_text()
    assert not [name for name in OLD if name in text]


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "math", "typing", "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_a_run_loads_no_jax():
    """A small run of a cell on the CPU, then the process's modules."""
    code = (
        "import sys, json, time, torch\n"
        "from portbench import run\n"
        "from portbench.tests.small import resize\n"
        "bench = json.loads((run.ROOT / 'BENCHMARK.json').read_text())\n"
        "r = run.run_cell(bench, 'student_eval.b256', 1, 0.5, False, torch.device('cpu'),\n"
        "                 time.perf_counter, resize)\n"
        "print(json.dumps({'found': run.loaded_forbidden(), 'correct': r['correct'],\n"
        "                  'port': " + repr(PORT) + " in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"found": [], "correct": True, "port": True}
