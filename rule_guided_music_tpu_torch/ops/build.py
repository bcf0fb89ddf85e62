"""Build the port's CUDA sources into plain-C shared libraries at first use.

``nvcc`` compiles each ``csrc/*.cu`` file into ``_build/lib<name>.so`` for
sm_90a, and ``ctypes`` loads it: a file with a plain C interface builds in
seconds, where one that includes PyTorch's headers takes minutes. A library
newer than its source is reused. ``_build/`` is listed in ``.gitignore``,
so a run writes nothing outside the checkout.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's CUDA kernels")


class BuildResult:
    """A built library: its path, the compiler's log and the build seconds
    (0 when a library newer than its source was reused)."""

    def __init__(self, path: Path, log: str, seconds: float):
        self.path, self.log, self.seconds = path, log, seconds


def build_library(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>.so``."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return BuildResult(out, "", 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return BuildResult(out, proc.stdout + proc.stderr, seconds)


def load_library(name: str) -> tuple:
    """Build if needed and load; returns (ctypes.CDLL, BuildResult)."""
    result = build_library(name)
    return ctypes.CDLL(str(result.path)), result

