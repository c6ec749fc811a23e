"""The port stands alone and never falls back.

* ``repro_torch`` (and ``chip_smoke.py``) import torch and numpy, never
  JAX and nothing of the ``repro`` package — checked in a fresh
  interpreter that builds and runs a streaming and an array pipeline,
  serves two requests each on a reduced Gemma 2 and a reduced Falcon
  Mamba, submits a job to the job service and runs a host batch job, and
  by a source scan of every subpackage.
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
import torch
from repro_torch.core.mapreduce import wordcount_map_factory
shards = torch.stack([torch.arange(64).reshape(4, 16) % 5,
                      torch.ones(4, 16, dtype=torch.int64)], -1)
array = (Pipeline.from_source(shards=shards).map(wordcount_map_factory(5))
         .reduce("sum").build(num_buckets=5, n_workers=4, device="cpu"))
counts, stats = array.run()
assert counts.tolist()[:5] == [13.0, 13.0, 13.0, 13.0, 12.0], counts
import numpy as np
from repro_torch import configs
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import init_params
cfg = configs.get_reduced("gemma2-9b")
server = BatchedServer(cfg, init_params(0, cfg, device="cpu"), 2, 32,
                       device="cpu")
reqs = [Request(id=i, prompt=np.arange(5, dtype=np.int32) + i, max_new=4)
        for i in range(2)]
for r in reqs:
    server.submit(r)
while any(server.slots) or server.queue:
    server.step()
assert all(r.done and len(r.tokens) == 5 for r in reqs), reqs
cfg = configs.get_reduced("falcon-mamba-7b")
server = BatchedServer(cfg, init_params(0, cfg, device="cpu"), 2, 32,
                       device="cpu")
reqs = [Request(id=i, prompt=np.arange(5, dtype=np.int32) + i, max_new=4)
        for i in range(2)]
for r in reqs:
    server.submit(r)
while any(server.slots) or server.queue:
    server.step()
assert all(r.done and len(r.tokens) == 5 for r in reqs), reqs
from repro_torch.core import (Coordinator, MetadataStore, make_wordcount_job,
                              read_final_output)
from repro_torch.data import synth_corpus
from repro_torch.service import JobServer
from repro_torch.streaming import write_event_log
store = MemoryStore()
write_event_log(store, "gps/", events, segment_records=64)
server = JobServer(store, MetadataStore())
server.add_tenant("alice")
job = (Pipeline.from_source(batch_records=64).key_by()
       .window(Windowing.tumbling(20.0)).reduce("sum")
       .build(num_buckets=8, n_workers=4, device="cpu", job_id="iso-svc"))
server.submit("alice", job, source_prefix="gps/")
assert server.run_until_complete() == {"iso-svc": "DONE"}
text = synth_corpus(2000, vocab_words=40, seed=1)
store = MemoryStore()
store.put("input/corpus.txt", text.encode())
cfg = make_wordcount_job(job_id="iso-wc", n_mappers=2, n_reducers=2)
assert Coordinator(store, MetadataStore()).run_job(cfg).state == "DONE"
assert sum(read_final_output(cfg, store).values()) == 2000
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
    scanned = {p.relative_to(REPO / "src" / "repro_torch").parts[0]
               for p in files[:-1]}
    assert {"configs", "core", "data", "kernels", "launch", "models",
            "service", "streaming"} <= scanned
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


def test_array_build_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = (Pipeline.from_source(shards=torch.zeros((4, 2, 2)))
            .map(lambda s: (s[:, 0], s[:, 1], s[:, 0] >= 0)).reduce("sum"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.build(num_buckets=8, n_workers=4)
    built = pipe.build(num_buckets=8, n_workers=4, device="cpu")
    assert built.device.type == "cpu" and built.is_array


def test_model_and_server_default_to_cuda_and_refuse_without_it(
        monkeypatch):
    from repro_torch import configs
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.convert import params_from_reference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("gemma2-9b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    params = init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServer(cfg, params, 2, 16)
    tree = {"embed": params["embed"].numpy(),
            "final_norm": {"w": params["final_norm"]["w"].numpy()},
            "layers": {"norm1": {"w": torch.stack(
                [lp["norm1"]["w"] for lp in params["layers"]]).numpy()}}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_reference(tree, cfg)
    assert params_from_reference(tree, cfg, device="cpu")["layers"][3][
        "norm1"]["w"].shape == (cfg.d_model,)
    assert BatchedServer(cfg, params, 2, 16, device="cpu").device.type == \
        "cpu"


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
