"""The port stands alone and never falls back.

* ``repro_torch`` (and ``chip_smoke.py``) import torch and numpy, never
  JAX and nothing of the ``repro`` package — checked in a fresh
  interpreter that builds and runs a pipeline, and by a source scan.
* Entry points default to the card: on a host without CUDA a build that
  does not ask for ``device="cpu"`` raises.
* The fold wrapper takes its plain version only for CPU tensors: any
  other tensor goes to the kernel or raises, whatever the build's state.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.kernels.fused_fold import ops
from repro_torch.pipeline import Pipeline, Windowing

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import sys
import repro_torch
from repro_torch.core import MemoryStore
from repro_torch.pipeline import Pipeline, Windowing
events = [(float(t), f"k{t % 4}", float(t % 5)) for t in range(300)]
built = (Pipeline.from_source(records=events, batch_records=64).key_by()
         .window(Windowing.sliding(20.0, 5.0)).reduce("mean")
         .build(num_buckets=8, n_workers=4, device="cpu", job_id="iso"))
outputs, report = built.run(store=MemoryStore())
assert outputs and report.windows_emitted == len(outputs)
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "repro" or m.startswith("repro."))
print("LOADED", loaded)
"""


def test_import_and_run_load_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_sources_import_no_jax_and_no_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_build_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = (Pipeline.from_source(records=[(0.0, "a", 1.0)]).key_by()
            .window(Windowing.tumbling(10.0)).reduce("sum"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.build(num_buckets=8, n_workers=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.build(num_buckets=8, n_workers=4, device="cuda:0")
    assert pipe.build(num_buckets=8, n_workers=4,
                      device="cpu").device.type == "cpu"


_GEOMETRY = dict(fanout=2, n_slots=4, num_buckets=8, carry_buckets=8)


def test_non_cpu_tensor_never_reaches_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: with the
    kernel's library missing the call raises, and the plain version is
    never consulted (meta tensors stand in for CUDA ones here)."""
    def missing(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(ops, "load_library", missing)
    monkeypatch.setattr(ops, "fused_streaming_fold_ref", plain)
    rows = torch.zeros((16, 5), device="meta")
    carry = torch.zeros((32, 2), device="meta")
    before = ops.fold.launches
    with pytest.raises(OSError, match="cannot open"):
        ops.fold(rows, carry, 0, **_GEOMETRY)
    assert ops.fold.launches == before
    # the same call on CPU tensors is the plain version's to answer
    with pytest.raises(AssertionError, match="plain version ran"):
        ops.fold(torch.zeros((16, 5)), torch.zeros((32, 2)), 0, **_GEOMETRY)


def test_wrapper_rejects_mismatched_arguments():
    with pytest.raises(ValueError, match="width-5"):
        ops.fold(torch.zeros((4, 4)), torch.zeros((32, 2)), 0, **_GEOMETRY)
    with pytest.raises(ValueError, match="carry has shape"):
        ops.fold(torch.zeros((4, 5)), torch.zeros((30, 2)), 0, **_GEOMETRY)
    with pytest.raises(TypeError, match="float32"):
        ops.fold(torch.zeros((4, 5), dtype=torch.float64),
                 torch.zeros((32, 2)), 0, **_GEOMETRY)
    with pytest.raises(ValueError, match="unknown fold kind"):
        ops.fold(torch.zeros((4, 5)), torch.zeros((32, 2)), 0,
                 kind="median", **_GEOMETRY)


@pytest.mark.cuda
def test_cuda_fold_launches_the_kernel(cuda_device, monkeypatch):
    """On the card the wrapper launches the kernel — the launch counter
    moves and the plain version is never called."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ops, "fused_streaming_fold_ref", plain)
    rows = torch.zeros((16, 5), device=cuda_device)
    rows[:, 1] = 1.0
    rows[:, 4] = 1.0
    carry = torch.zeros((32, 2), device=cuda_device)
    before = ops.fold.launches
    _, stats = ops.fold(rows, carry, 0, **_GEOMETRY)
    assert ops.fold.launches == before + 1
    assert stats.tolist() == [0, 16, 0]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or on a host without CUDA, the smoke script
    exits non-zero and prints no result line."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (lone, REPO / "chip_smoke.py"):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              cwd=script.parent, env=dict(
                                  os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
