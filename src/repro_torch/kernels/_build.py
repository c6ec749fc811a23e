"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file with a plain C entry point under its
package's ``csrc/``.  ``load_library(name)`` compiles it with ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` at the repository root —
a directory ``.gitignore`` lists — the first time it is asked for, and
loads the shared library with ``ctypes``.  The file name carries a hash of
the source, so an edited kernel is rebuilt and a stale one never loads.
Nothing here runs at import time: the CPU tests import every module, and
this host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()


def source_path(name: str) -> pathlib.Path:
    """``kernels/<name>/csrc/<name>.cu``."""
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the path,
    or the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(pathlib.Path(on_path))
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def build(name: str) -> pathlib.Path:
    """Compile kernel ``name`` unless a build of this exact source exists;
    returns the shared library's path.  Concurrent builds in one process
    serialise on a lock; across processes the finished library is moved
    into place atomically."""
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    with _LOCK:
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load kernel ``name``'s shared library, once
    per process."""
    return ctypes.CDLL(str(build(name)))
