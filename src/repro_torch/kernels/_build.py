"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file with a plain C entry point under its
package's ``csrc/``.  ``load_library(name)`` compiles it with ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` at the repository root —
a directory ``.gitignore`` lists — the first time it is asked for, and
loads the shared library with ``ctypes``.  The file name carries a hash of
the sources (the ``.cu`` and the headers beside it), so an edited kernel
is rebuilt and a stale one never loads.
``build_all(names)`` builds several kernels at once, one ``nvcc`` each.
``ptxas -v``'s report of every kernel's registers, spills and shared
memory is kept beside the library (``build_log(name)``).  Nothing here
runs at import time: the CPU tests import every module, and
this host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
# -Xptxas=-v: ptxas reports each kernel's registers and spill bytes, which
# the build keeps (a kernel that spills is a kernel to redesign)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


class KernelError(RuntimeError):
    """A hand-written kernel that could not be built, loaded or launched.
    Callers that contain failures per job (the job service) catch this;
    nothing catches it to compute the result some other way."""


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
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _target(name: str) -> pathlib.Path:
    """Where a build of kernel ``name``'s current source lives: the name
    carries a hash of every file in its ``csrc/`` (the ``.cu`` and the
    headers it includes) and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(source_path(name).parent.iterdir()):
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, pathlib.Path]:
    """Compile every kernel in ``names`` that has no build of its exact
    source yet, one ``nvcc`` process each, all started together; returns
    each kernel's shared-library path.  Every build writes a temporary
    file that is moved into place atomically, so concurrent builds (of one
    kernel or several, from threads or processes) never see a partial
    library."""
    running = []
    for name in names:
        out = _target(name)
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source_path(name))]
        running.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True),
                        name, tmp, out))
    failed = []
    for proc, name, tmp, out in running:
        report, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {source_path(name)}:\n{err}")
        else:
            out.with_suffix(".log").write_text(report + err)
            os.replace(tmp, out)
    if failed:
        raise KernelError("\n".join(failed))
    return {name: _target(name) for name in names}


def build_log(name: str) -> str:
    """What ``nvcc`` and ``ptxas -v`` reported when kernel ``name``'s
    current source was built ("" before its first build)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def ptxas_usage(report: str) -> dict[str, dict[str, int]]:
    """Per kernel (mangled name) in a ``ptxas -v`` report: its
    ``registers``, and its ``stack_frame`` (local memory: arrays the
    compiler could not keep in registers), ``spill_stores`` and
    ``spill_loads`` in bytes."""
    usage, current = {}, None
    for line in report.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$.]+)'?", line)
        if entry:
            current = usage.setdefault(entry.group(1), {})
            continue
        if current is None:
            continue
        stack = re.search(r"(\d+) bytes stack frame", line)
        if stack:
            current["stack_frame"] = int(stack.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            current["spill_stores"] = int(spill.group(1))
            current["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            current["registers"] = int(regs.group(1))
    return usage


def build(name: str) -> pathlib.Path:
    """Compile kernel ``name`` unless a build of this exact source exists;
    returns the shared library's path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load kernel ``name``'s shared library, once
    per process."""
    path = build(name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as exc:
        raise KernelError(f"cannot load {path}: {exc}") from exc
