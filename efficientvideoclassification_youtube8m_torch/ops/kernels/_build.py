"""Build and load the hand-written CUDA kernels.

Each `ops/csrc/<name>.cu` has a plain C interface and is compiled with
`nvcc` into a shared library, loaded with `ctypes`. The build happens at
first use, never at import, into `build/kernels/` at the root of the
checkout, keyed by a hash of the source, the shared headers and the
flags, so a fresh checkout builds once and an edited source or header
rebuilds. A missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the library for `ops/csrc/<name>.cu` is (or will be) built.
    The key covers the source, every header in `ops/csrc/` (the sources
    share them) and the flags."""
    digest = hashlib.sha256()
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> None:
    """Build the libraries of `ops/csrc/<name>.cu` that are missing, one
    nvcc process per source, all started together. The compiler's
    output, with ptxas' register and shared-memory report, is kept beside
    each library as `<library>.log`. Raises if any build fails."""
    jobs = []
    for name in dict.fromkeys(names):
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, cmd, proc))
    failed = []
    for name, out, tmp, cmd, proc in jobs:
        output, _ = proc.communicate()
        log = f"$ {' '.join(cmd)}\n{output}"
        if proc.returncode != 0:
            failed.append(f"building {name}.cu failed:\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, declare: Callable[[ctypes.CDLL], None]
                 ) -> ctypes.CDLL:
    """Build `ops/csrc/<name>.cu` if needed and load it (once per process);
    `declare` sets the argument and result types of its C functions."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    declare(lib)
    _LIBS[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler's output from building `ops/csrc/<name>.cu`."""
    path = library_path(name)
    return path.with_name(path.name + ".log").read_text()


def sass_counts(name: str, opcodes: Sequence[str]) -> Dict[str, Dict[str, int]]:
    """How many instructions of each of `opcodes` (SASS mnemonics, e.g.
    "HGMMA") each kernel of the built `ops/csrc/<name>.cu` holds, by
    `cuobjdump -sass` (beside nvcc). Keys are the mangled kernel names."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = counts.setdefault(line.split("Function :")[1].strip(),
                                        dict.fromkeys(opcodes, 0))
        elif current is not None:
            for op in opcodes:
                if f" {op}" in line or f"\t{op}" in line:
                    current[op] += 1
    return counts


def loaded() -> Dict[str, ctypes.CDLL]:
    """The libraries this process has loaded so far, by name."""
    return dict(_LIBS)
