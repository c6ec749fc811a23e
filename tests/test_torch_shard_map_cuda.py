"""A windowed join and the job service under ``shard_map`` on the card, in
a world of one NCCL rank, against the same programs built for the CPU.

No JAX here: these tests run on the card machine
(``python -m pytest -m cuda tests/test_torch_shard_map_cuda.py``) and skip
elsewhere.  ``test_torch_shard_map_join.py`` and
``test_torch_shard_map_service.py`` hold the CPU builds over 2 and 4 gloo
ranks against the reference.  Each world is joined through a file store
and bounded by a timeout of its own.
"""

import datetime
import os
import tempfile

import pytest

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.core import FileStore, MemoryStore, MetadataStore
from repro_torch.kernels.fused_fold import ops
from repro_torch.pipeline import Pipeline, Windowing
from repro_torch.streaming import write_event_log

import _torch_ranks as ranks

#: seconds a world's collectives may wait
TIMEOUT = datetime.timedelta(seconds=120)


def _world_of_one(fn):
    """``fn()`` with the default group a world of one NCCL rank."""
    import torch
    import torch.distributed as dist
    root = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        root, "pg"), rank=0, world_size=1, timeout=TIMEOUT)
    try:
        return fn()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ranks.JOIN_CASES))
def test_join_under_shard_map_on_the_card_equals_plain(cuda_device, case):
    """Every join case under ``shard_map`` on the card: the sinks equal
    the fused build on the CPU (the plain fold) byte for byte, and each
    fold step is one ``fused_fold`` launch."""
    def run(**build):
        built = ranks.join_program(Pipeline, Windowing, case, **build)
        store = MemoryStore()
        rep = built.run(store=store, meta=MetadataStore(), mode="streaming")
        return built.collect_outputs(store), rep

    want, _ = run(device="cpu")

    def card():
        ops.fold.launches = 0
        got, rep = run(device=cuda_device, n_workers=1, backend="shard_map")
        return got, rep, ops.fold.launches

    got, rep, launches = _world_of_one(card)
    assert want and got == want
    assert launches == rep.folds >= 2 * rep.batches


@pytest.mark.cuda
def test_service_under_shard_map_on_the_card_equals_plain(cuda_device,
                                                          tmp_path):
    """Three tenants on one shared ingest, parked, appended to and
    cold-restored under ``shard_map`` on the card: every tenant's sinks,
    state and registry record (apart from host times) equal the same
    service built with ``backend="vmap"`` for the CPU."""
    def write(store, events):
        write_event_log(store, "gps/", events, segment_records=64)

    ns = ranks._port_service()
    want = ranks.service_scenario(ns, MemoryStore(), MetadataStore(), 1,
                                  write, backend="vmap", device="cpu")
    got = _world_of_one(lambda: ranks.service_scenario(
        ns, FileStore(str(tmp_path / "store")), MetadataStore(), 1, write,
        backend="shard_map", device=cuda_device))
    assert all(want["sinks"].values())
    for key in ("parked", "states", "records", "index", "sinks"):
        assert got[key] == want[key], key
