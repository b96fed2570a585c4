"""Build the port's CUDA kernels from ``hifiasm_tpu_torch/csrc`` at first use.

Each ``.cu`` source has a plain C interface.  ``nvcc`` compiles it for
``sm_90a`` into a shared library under the gitignored ``build/kernels``
directory beside the package, named by a hash of the source and the
``csrc`` headers it includes, so an edited kernel or header is rebuilt;
the library is loaded with ``ctypes``.  ``build``
starts one ``nvcc`` per missing library, all at once.  A build that
fails raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

# kernel name -> source file under csrc/
SOURCES = {"banded_tb": "banded_tb.cu", "banded_fwd": "banded_fwd.cu",
           "vote_scatter": "vote_scatter.cu"}

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(fname: str, seen: List[str]) -> List[str]:
    """``fname`` under ``CSRC`` and, depth first, every ``csrc`` file it
    ``#include``s in quotes, each once."""
    if fname not in seen:
        seen.append(fname)
        with open(os.path.join(CSRC, fname), "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                if os.path.exists(os.path.join(CSRC, inc.decode())):
                    _sources(inc.decode(), seen)
    return seen


def library_path(name: str) -> str:
    """The library's path, named by a hash of its source and every header
    of ``csrc`` it includes, so an edited header rebuilds its kernels."""
    h = hashlib.sha256()
    for fname in _sources(SOURCES[name], []):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build(names=None) -> None:
    """Compile the libraries of ``names`` (default: every kernel) that are
    not built yet, one nvcc process per source, all started together."""
    todo = [n for n in (SOURCES if names is None else names)
            if not os.path.exists(library_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = f"{library_path(n)}.{os.getpid()}.tmp"
        procs[n] = (tmp, subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for n, (tmp, p) in procs.items():
        BUILD_LOGS[n] = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0 or not os.path.exists(tmp):
            failed.append(n)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(
            f"{n}:\n{BUILD_LOGS[n]}" for n in failed))


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, compiled on first use together with every
    other library not built yet."""
    lib = _LIBS.get(name)
    if lib is None:
        build()
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
    return lib


def info(name: str) -> Dict[str, int]:
    """Registers a thread, shared memory a block (bytes) and resident
    blocks per SM of the kernel's build, from its ``<name>_info``."""
    fn = getattr(load(name), f"{name}_info")
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    rc = fn(*map(ctypes.byref, vals))
    if rc != 0:
        raise RuntimeError(f"{name}_info failed: cudaError {rc}")
    return dict(zip(("regs", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def dump_sass(out_dir: str) -> None:
    """Write ``cuobjdump -sass`` of every built kernel library to
    ``out_dir/<name>.sass`` (the source of the instruction counts behind
    the operation bounds that chip_smoke.py reports)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    os.makedirs(out_dir, exist_ok=True)
    for n in SOURCES:
        with open(os.path.join(out_dir, f"{n}.sass"), "w") as f:
            subprocess.run([cuobjdump, "-sass", library_path(n)], stdout=f,
                           stderr=subprocess.STDOUT, check=True)


if __name__ == "__main__":
    # python -m hifiasm_tpu_torch.ops.cuda_build [SASS_DIR]: build every
    # kernel, print the compiler's output, and dump the SASS if asked
    import sys

    build()
    for n, log in BUILD_LOGS.items():
        print(f"[{n}]\n{log}")
    if len(sys.argv) > 1:
        dump_sass(sys.argv[1])
