"""Windowed joins under the ``shard_map`` backend over real ranks: gloo on
the CPU, 2 and 4 processes, against the reference's ``vmap`` drive of the
same join.

A join's two sides fold into one ``(n_slots * carry_buckets, 4)`` carry
at channel bases 0 and 2.  Under ``shard_map`` every rank reads both logs
(one merged, side-tagged stream), folds its share of each micro-batch and
reduce-scatters its side's channel pair into its share of the carry;
rank 0 alone writes the sinks.  Each world runs under its own timeout
(``_torch_ranks.spawn``); values are integers, so every float32 fold is
exact in any order and the sinks compare byte for byte.
"""

import os

import pytest

from repro.core import MemoryStore as JMemoryStore
from repro.core import MetadataStore as JMetadataStore
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import Windowing as JWindowing

from repro_torch.core import FileStore, MetadataStore
from repro_torch.pipeline import Pipeline, RunOptions, Windowing

import _torch_ranks as ranks

#: seconds a world may take, spawn and imports included
TIMEOUT = 110.0


def _objects(store, prefixes):
    return {m.key: store.get(m.key) for p in prefixes
            for m in store.list_objects(p)}


def _reference(make, world):
    """The reference's ``vmap`` drive of a join: its sinks and counters."""
    built = make(JPipeline, JWindowing, n_workers=world, backend="vmap")
    store = JMemoryStore()
    rep = built.run(store=store, meta=JMetadataStore(), mode="streaming")
    assert rep.error is None
    return built.collect_outputs(store), ranks._report(rep)


@pytest.mark.parametrize("case,world", [
    ("sum-count", 2), ("sum-count", 4), ("mean-hashed", 2),
    ("mean-hashed", 4), ("asymmetric", 2), ("asymmetric", 4)])
def test_shard_map_join_matches_vmap(case, world, tmp_path):
    """Sum ⋈ count, mean ⋈ mean over hashed keys, and asymmetric
    ``num_buckets=(8, 16)``: rank 0's sinks equal the reference's ``vmap``
    join byte for byte, every rank's counters equal its, and every rank
    made the fold steps of the port's fused run over its share of the
    carry."""
    outs = ranks.spawn(ranks.join_body, world, tmp_path, case,
                       timeout=TIMEOUT)
    want, report = _reference(
        lambda P, Wn, **kw: ranks.join_program(P, Wn, case, **kw), world)
    assert want
    store = FileStore(os.path.join(tmp_path, "store"))
    assert _objects(store, ["joined/"]) == want
    fused = ranks.join_program(Pipeline, Windowing, case, device="cpu")
    frep = fused.run(store=FileStore(os.path.join(tmp_path, "fused")),
                     meta=MetadataStore(), mode="streaming")
    nb = ranks.JOIN_CASES[case][2]["num_buckets"]
    wide = max(nb) if isinstance(nb, tuple) else nb
    for out in outs:
        assert out["report"] == report
        assert out["folds"] == frep.folds
        assert out["carry"] == (8 * wide // world, 4)


def _join_reference_sinks():
    built = ranks.join_crash_program(JPipeline, JWindowing, n_workers=2,
                                     backend="vmap")
    store = JMemoryStore()
    built.run(store=store, meta=JMetadataStore(), mode="streaming")
    return built, built.collect_outputs(store)


def test_shard_map_join_crash_restore_exactly_once(tmp_path):
    """Both ranks crash before micro-batch 5 of the merged stream
    (checkpointed after batch 4) and resume from the checkpoint: the sinks
    equal the reference's uncrashed ``vmap`` join, and rank 0 wrote each
    window once."""
    outs = ranks.spawn(ranks.crash_body, 2, tmp_path, 5, False, "join",
                       timeout=TIMEOUT)
    built, want = _join_reference_sinks()
    assert want
    store = FileStore(os.path.join(tmp_path, "store"))
    assert _objects(store, built.output_prefixes()) == want
    assert [o["offset"] for o in outs] == [400, 400]
    assert all(outs[0]["puts"][key] == 1 for key in want)
    assert all(not o["puts"] for o in outs[1:])   # only rank 0 writes


def test_shard_map_join_checkpoint_restores_under_fused(tmp_path):
    """A join checkpoint written under ``shard_map`` (the ranks' shares
    of the shared carry gathered into the flat ``(160, 4)`` image) resumes
    under the port's ``"fused"`` backend in one process: the sinks equal
    the reference's uncrashed join."""
    outs = ranks.spawn(ranks.crash_body, 2, tmp_path, 5, True, "join",
                       timeout=TIMEOUT)
    assert [o["offset"] for o in outs] == [400, 400]
    _, want = _join_reference_sinks()
    fused = ranks.join_crash_program(Pipeline, Windowing, device="cpu")
    store = FileStore(os.path.join(tmp_path, "store"))
    meta = MetadataStore(persist_path=os.path.join(tmp_path, "meta.json"))
    assert meta.get("stream/jcrash/state")["carry_shapes"] == [[160, 4]]
    report = fused.run(store=store, meta=meta, mode="streaming",
                       options=RunOptions(overlap=False))
    assert report.error is None
    assert want and fused.collect_outputs(store) == want
