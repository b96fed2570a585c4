"""Build the port's CUDA kernels from ``hifiasm_tpu_torch/csrc`` at first use.

Each ``.cu`` source has a plain C interface.  ``nvcc`` compiles it for
``sm_90a`` into a shared library under the gitignored ``build/kernels``
directory beside the package, named by a hash of the source so an edited
kernel is rebuilt; the library is loaded with ``ctypes``.  A build that
fails raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# kernel name -> source file under csrc/
SOURCES = {"banded_tb": "banded_tb.cu"}

BUILD_LOGS: Dict[str, str] = {}       # compiler output (ptxas -v) per kernel
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    src = os.path.join(CSRC, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, compiled on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = library_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        r = subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        BUILD_LOGS[name] = r.stdout.decode(errors="replace")
        if r.returncode != 0 or not os.path.exists(tmp):
            raise RuntimeError(f"CUDA kernel build failed: {name}:\n"
                               f"{BUILD_LOGS[name]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    _LIBS[name] = lib
    return lib
