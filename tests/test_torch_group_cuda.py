"""Group mode on the card against the same program with ``device="cpu"``.

No JAX here: these tests run on the card machine
(``python -m pytest -m cuda tests/test_torch_group_cuda.py``) and skip
elsewhere.  ``test_torch_group.py`` holds the CPU build against the
reference.
"""

import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.core import MemoryStore, MetadataStore
from repro_torch.engine.stages import SEGMENT_REDUCE_KINDS
from repro_torch.pipeline import Pipeline, Windowing
from repro_torch.streaming import StreamSource
from repro_torch.workloads.linear_road import median_reduce

W = 4


def _events(n, n_keys, span, seed, vmax):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, span, n))
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, vmax, n).astype(float)
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


def _stream(device, evs, spec, *, size, slide=None, capacity=1024,
            key_space="dense"):
    w = Windowing.sliding(size, slide) if slide else Windowing.tumbling(size)
    built = (Pipeline.from_source(batch_records=256).key_by().window(w)
             .reduce(spec, mode="group", capacity=capacity).sink("out/")
             .build(num_buckets=16, n_workers=W, key_space=key_space,
                    batch_records=256, job_id="g", device=device))
    store = MemoryStore()
    report = built.run(StreamSource.from_records(evs, batch_records=256),
                       store=store, meta=MetadataStore())
    assert report.error is None
    return built.collect_outputs(store), report


@pytest.mark.cuda
def test_group_stream_on_the_card_equals_cpu(cuda_device):
    """A median stream that overflows its buffers and a hashed sliding
    max, built for the card: the sinks and the drop counts equal the
    ``device="cpu"`` build's."""
    evs = _events(3000, 9, 300.0, 43, 60)
    for spec, kw in ((median_reduce, dict(size=50.0, capacity=120)),
                     ("max", dict(size=40.0, slide=20.0,
                                  key_space="hashed"))):
        out = {dev: _stream(dev, evs, spec, **kw) for dev in ("cuda", "cpu")}
        assert out["cuda"][0] == out["cpu"][0] and out["cpu"][0]
        assert out["cuda"][1].capacity_dropped \
            == out["cpu"][1].capacity_dropped


def _pmap(shard):
    return shard[:, 0].to(torch.int32), shard[:, 1], shard[:, 2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SEGMENT_REDUCE_KINDS)
def test_batch_group_on_the_card_equals_cpu(cuda_device, kind):
    """Batch group mode on the card against ``device="cpu"``, drops
    included: integer values equal bit for bit; real-valued ``sum`` /
    ``mean`` within rtol 1e-6, since the card's segment reduction adds a
    key's values in its own fixed order, not the CPU's left fold (about
    100 terms a key here); ``max``, ``min``, ``count`` exact."""
    rng = np.random.default_rng(47)
    keys = rng.integers(0, 32, 4000)
    for vals, exact in ((rng.integers(0, 9, 4000), True),
                        (rng.random(4000), False)):
        rows = np.zeros((4000, 3), np.float32)
        rows[:, 0], rows[:, 1], rows[:, 2] = keys, vals, 1.0
        shards = rows.reshape(W, -1, 3)
        res = {}
        for dev in ("cuda", "cpu"):
            (gk, gv, gvalid), stats = (
                Pipeline.from_source(shards=shards).map(_pmap)
                .reduce(kind, mode="group", capacity=300)
                .build(num_buckets=32, n_workers=W, device=dev)).run()
            res[dev] = (gk.cpu(), gv.cpu(), gvalid.cpu(), int(stats.sent),
                        int(stats.dropped))
        (ck, cv, cok, cs, cd), (pk, pv, pok, ps, pd) = res["cuda"], res["cpu"]
        assert torch.equal(ck, pk) and torch.equal(cok, pok)
        assert (cs, cd) == (ps, pd) and cd > 0
        if exact or kind in ("max", "min", "count"):
            assert torch.equal(cv, pv)
        else:
            torch.testing.assert_close(cv, pv, rtol=1e-6, atol=0)
