"""The ``vmap`` and ``shard_map`` backends on the card against their plain
versions.

No JAX here: these tests run on the card machine
(``python -m pytest -m cuda tests/test_torch_backends_cuda.py``) and skip
elsewhere.  ``test_torch_backends.py`` and ``test_torch_shard_map.py``
hold the CPU builds against the reference.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.core import MemoryStore, MetadataStore
from repro_torch.engine.plan import (ExecutionPlan, KeySpace, ReduceSpec,
                                     WindowSpec)
from repro_torch.kernels.fused_fold import ops
from repro_torch.pipeline import Pipeline, Windowing
from repro_torch.streaming import StreamSource

W = 8


def _wire(rng, n, per, n_keys):
    rows = np.zeros((W * per, 5), np.float32)
    rows[:n] = np.stack([rng.integers(2, 40, n), rng.integers(1, 5, n),
                         rng.integers(0, n_keys, n), rng.integers(0, 90, n),
                         np.ones(n)], 1)
    return rows.reshape(W, per, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("hashed", [False, True])
def test_vmap_fold_on_the_card_equals_plain(cuda_device, hashed):
    """The vmap plan's step on card tensors (one ``fused_fold`` launch over
    the ``(W, per, 5)`` wire's and the ``(W, per, 2)`` carry's flat views,
    into the same carry storage) against the same plan built for the
    CPU (the plain fold), bit for bit on integer-valued data, stats
    included."""
    rng = np.random.default_rng(5)
    ks = KeySpace.hashed(4096) if hashed else KeySpace.dense(4096)
    plan = ExecutionPlan(ks, ReduceSpec(), W, WindowSpec(300.0, 60.0, 8))
    card = plan.compile(backend="vmap", device=cuda_device)
    plain = plan.compile(backend="vmap", device="cpu")
    carry, want = card.init_carry(), plain.init_carry()
    ptr = carry.data_ptr()
    ops.fold.launches = 0
    for n in (30000, 4096, 0):
        rows = _wire(rng, n, 4096, 1 << 20 if hashed else 4096)
        carry, stats = card.step(torch.from_numpy(rows).to(cuda_device),
                                 carry, 9)
        want, wstats = plain.step(rows, want, 9)
        assert torch.equal(stats.cpu(), wstats)
    assert ops.fold.launches == 3
    assert carry.data_ptr() == ptr and carry.shape == (W, 4096, 2)
    assert torch.equal(carry.cpu(), want)
    for slot in (0, 5):
        assert np.array_equal(card.read_slot(carry, slot),
                              plain.read_slot(want, slot))


@pytest.mark.cuda
def test_shard_map_world_of_one_on_the_card_equals_fused(cuda_device):
    """A stream and a word count under ``shard_map`` in a world of one
    NCCL rank: the sinks and counts equal the fused build's."""
    import torch.distributed as dist
    rng = np.random.default_rng(9)
    ts = np.sort(rng.uniform(0, 400.0, 6000))
    evs = [(float(t), f"k{k}", float(v)) for t, k, v in
           zip(ts, rng.integers(0, 40, 6000), rng.integers(0, 9, 6000))]

    def stream(**kw):
        built = (Pipeline.from_source(batch_records=500).key_by()
                 .window(Windowing.sliding(60.0, 20.0)).reduce("mean")
                 .sink("sm/").build(num_buckets=64, batch_records=500,
                                    job_id="sm", device=cuda_device, **kw))
        store = MemoryStore()
        built.run(StreamSource.from_records(evs, batch_records=500),
                  store=store, meta=MetadataStore())
        return built.collect_outputs(store)

    tokens = rng.integers(0, 100, (1 << 16, 1)).astype(np.int32)
    data = np.concatenate([tokens, np.ones_like(tokens)], axis=1)

    def count(shards, **kw):
        from repro_torch.core.mapreduce import wordcount_map_factory
        return (Pipeline.from_source(shards=shards)
                .map(wordcount_map_factory(100)).reduce("sum")
                .build(num_buckets=100, n_workers=1, device=cuda_device,
                       **kw).run(shards)[0].cpu())

    fused_sinks = stream(n_workers=1)
    fused_counts = count(data[None])            # one worker's shard
    root = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        root, "pg"), rank=0, world_size=1)
    try:
        assert stream(n_workers=1, backend="shard_map") == fused_sinks
        # the rank is handed the flat data and takes its share of axis 0
        assert torch.equal(count(data, backend="shard_map"), fused_counts)
    finally:
        dist.destroy_process_group()
