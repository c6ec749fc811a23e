"""The ``shard_map`` backend over real ranks: gloo on the CPU, 2-4
processes, against the reference's ``vmap`` drive of the same program.

Each test spawns its world with ``torch.multiprocessing`` (``spawn``),
joined through a ``FileStore`` under ``tmp_path`` (no TCP port), under a
timeout of its own; the rank programs live in ``_torch_ranks.py`` and
import ``repro_torch`` only.  The reference's four ``shard_map`` cases —
the batch aggregate and group word count of
``tests/test_sharding_multidevice.py``, the single-stage stream and the
two-stage chain with its device handoff of ``tests/test_pipeline_api.py``,
and the tee with a mid-stream restore of ``tests/test_dag_fanout.py`` —
must give the bytes of the reference's ``backend="vmap"`` (JAX on the
CPU): results and stats, sink objects, fold counters on every rank.  Then
a crash and restore under ``shard_map`` (each window written once, by
rank 0), and a ``shard_map`` checkpoint restored under the port's
``"fused"`` backend.
"""

import os

import numpy as np
import pytest

from repro.core import MemoryStore as JMemoryStore
from repro.core import MetadataStore as JMetadataStore
from repro.core.mapreduce import wordcount_map_factory as jwordcount
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import Windowing as JWindowing
from repro.streaming import StreamSource as JStreamSource
from repro.streaming import write_event_log as jwrite_event_log

from repro_torch.core import FileStore, MetadataStore
from repro_torch.pipeline import Pipeline, RunOptions, Windowing
from repro_torch.streaming import StreamSource

import _torch_ranks as ranks

#: seconds a world may take, spawn and imports included
TIMEOUT = 110.0


def _objects(store, prefixes):
    return {m.key: store.get(m.key) for p in prefixes
            for m in store.list_objects(p)}


def _jax_stream(case, world):
    """The reference's vmap drive: its sinks and fold counters (the tee
    restarts mid-stream like the ranks do)."""
    built = ranks.stream_program(JPipeline, JWindowing, case,
                                 n_workers=world, backend="vmap")
    store, meta = JMemoryStore(), JMetadataStore()
    reports = []
    if case == "tee":
        jwrite_event_log(store, "streams/ev", ranks.TEE_EVENTS)
        reports.append(built.run(JStreamSource.from_records(
            ranks.TEE_EVENTS[:400], batch_records=100), store=store,
            meta=meta, mode="streaming", flush=False))
    reports.append(built.run(store=store, meta=meta, mode="streaming"))
    return (built.collect_outputs(store), [ranks._report(r) for r in reports],
            built.output_prefixes())


@pytest.mark.parametrize("world", [2, 4])
def test_shard_map_batch_word_count_matches_vmap(world, tmp_path):
    """The aggregate and the group word count (and a hashed key space,
    whose collisions route distinct keys to owners with ``all_to_all``):
    every rank holds the reference's finalized result and stats."""
    outs = ranks.spawn(ranks.batch_body, world, tmp_path, timeout=TIMEOUT)
    shard = ranks.word_shards(world)
    data = shard.reshape(world, -1, 2)          # vmap: a leading worker axis
    want = {}
    for name, kw in (("sum", {}), ("hashed", {"key_space": "hashed"})):
        res, st = (JPipeline.from_source(shards=data)
                   .map(jwordcount(1 << 20)).reduce("sum")
                   .build(num_buckets=64 if not kw else 16, n_workers=world,
                          backend="vmap", **kw).run_batch(data=data))
        want[name] = (np.asarray(res), int(st.sent), int(st.dropped),
                      None if st.bucket_collisions is None
                      else np.asarray(st.bucket_collisions))
    (gk, gv, gvalid), gst = (JPipeline.from_source(shards=data)
                             .map(jwordcount(64))
                             .reduce("sum", mode="group", capacity=2048)
                             .build(num_buckets=64, n_workers=world,
                                    backend="vmap").run_batch(data=data))
    want["group"] = ((np.asarray(gk), np.asarray(gv), np.asarray(gvalid)),
                     int(gst.sent), int(gst.dropped), None)
    assert np.asarray(want["hashed"][3]).sum() > 0
    for out in outs:
        for name, (res, sent, dropped, coll) in want.items():
            got = out[name]
            for a, b in zip(res if name == "group" else (res,),
                            got[0] if name == "group" else (got[0],)):
                assert a.shape == b.shape and a.tobytes() == b.tobytes()
            assert (got[1], got[2]) == (sent, dropped), name
            if coll is not None:
                assert np.array_equal(coll, got[3])


@pytest.mark.parametrize("case,world", [("single", 4), ("chain", 4),
                                        ("group", 2), ("tee", 4)])
def test_shard_map_stream_matches_vmap(case, world, tmp_path):
    """A single stage, a two-stage chain over a device edge, a windowed
    group stage (``all_to_all`` exchange, ``all_gather`` finalization) and
    a tee'd DAG restarted mid-stream from its checkpoint: rank 0's sink
    objects equal the reference's vmap drive byte for byte, and every
    rank's fold counters equal its."""
    outs = ranks.spawn(ranks.stream_body, world, tmp_path, case,
                       timeout=TIMEOUT)
    want, reports, prefixes = _jax_stream(case, world)
    assert want
    store = FileStore(os.path.join(tmp_path, "store"))
    assert _objects(store, prefixes) == want
    for out in outs:
        assert out == reports


def test_shard_map_crash_restore_exactly_once(tmp_path):
    """Every rank crashes before micro-batch 5 (checkpointed at batch 4)
    and resumes from the checkpoint: the sinks equal the reference's
    uncrashed vmap drive, and rank 0 wrote each window once."""
    outs = ranks.spawn(ranks.crash_body, 2, tmp_path, 5, False,
                       timeout=TIMEOUT)
    built = ranks.crash_program(JPipeline, JWindowing, n_workers=2,
                                backend="vmap")
    jstore = JMemoryStore()
    built.run(JStreamSource.from_records(ranks.crash_events(),
                                         batch_records=100),
              store=jstore, meta=JMetadataStore(), mode="streaming")
    want = built.collect_outputs(jstore)
    assert want
    store = FileStore(os.path.join(tmp_path, "store"))
    assert _objects(store, built.output_prefixes()) == want
    assert [o["offset"] for o in outs] == [400, 400]
    assert all(outs[0]["puts"][key] == 1 for key in want)
    assert all(not o["puts"] for o in outs[1:])   # only rank 0 writes


def test_shard_map_checkpoint_restores_under_fused(tmp_path):
    """A checkpoint written under ``shard_map`` (the ranks' shares
    gathered into the flat carry) resumes under the port's ``"fused"``
    backend in one process: the sinks equal an uncrashed fused run."""
    outs = ranks.spawn(ranks.crash_body, 2, tmp_path, 5, True,
                       timeout=TIMEOUT)
    assert [o["offset"] for o in outs] == [400, 400]
    events = ranks.crash_events()

    def fused():
        return ranks.crash_program(Pipeline, Windowing, n_workers=2,
                                   device="cpu")

    ref_store = FileStore(os.path.join(tmp_path, "ref"))
    fused().run(StreamSource.from_records(events, batch_records=100),
                store=ref_store, meta=MetadataStore(), mode="streaming")
    want = fused().collect_outputs(ref_store)
    store = FileStore(os.path.join(tmp_path, "store"))
    meta = MetadataStore(persist_path=os.path.join(tmp_path, "meta.json"))
    report = fused().run(StreamSource.from_records(events, batch_records=100),
                         store=store, meta=meta, mode="streaming",
                         options=RunOptions(overlap=False))
    assert report.error is None
    assert want and fused().collect_outputs(store) == want
