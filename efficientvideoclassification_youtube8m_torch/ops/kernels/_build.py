"""Build and load the hand-written CUDA kernels.

Each `ops/csrc/<name>.cu` has a plain C interface and is compiled with
`nvcc` into a shared library, loaded with `ctypes`. The build happens at
first use, never at import, into `build/kernels/` at the root of the
checkout, keyed by a hash of the source and the flags, so a fresh
checkout builds once and an edited source rebuilds. A missing `nvcc` or
a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict

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
    """Where the library for `ops/csrc/<name>.cu` is (or will be) built."""
    digest = hashlib.sha256(
        (CSRC_DIR / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str, declare: Callable[[ctypes.CDLL], None]
                 ) -> ctypes.CDLL:
    """Build `ops/csrc/<name>.cu` if needed and load it (once per process);
    `declare` sets the argument and result types of its C functions.
    The compiler's output, with ptxas' register and shared-memory report,
    is kept beside the library as `<library>.log`."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            raise RuntimeError(f"building {name}.cu failed:\n{log}")
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    declare(lib)
    _LIBS[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler's output from building `ops/csrc/<name>.cu`."""
    path = library_path(name)
    return path.with_name(path.name + ".log").read_text()


def loaded() -> Dict[str, ctypes.CDLL]:
    """The libraries this process has loaded so far, by name."""
    return dict(_LIBS)
