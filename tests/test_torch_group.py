"""Group mode in the port against the reference.

The grouping shuffle's stages (``repro_torch.engine.stages``) run on the
same seeded numpy inputs as the reference's, the reference's under
``jax.vmap`` over its worker axis (its collectives need one): send
buffers, exchange, merge, every segment-reducer kind, the window fan-out
and the windowed record buffers must be equal, dtype and shape included.
Then the plans and pipelines end to end — batch group mode (the
reference's ``backend="vmap"``), windowed group streams (the median
reducer, sliding max, counted overflow, hashed min/max with ring reuse),
PL003, a group stage inside a stage DAG, and a group-mode checkpoint
crossing between the packages both ways.  Real-valued float32 sums are
held bit for bit too: both packages sum a segment as a left fold on the
CPU.  ``test_torch_group_cuda.py`` holds card builds against
``device="cpu"``.
"""

import json
import warnings
from collections import defaultdict
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pkgs import (JAX, PORT, W, Boom, CountingStore, crashing,
                         events, json_meta, streamed)
from repro.engine import stages as jstages
from repro.engine.plan import ExecutionPlan as JPlan
from repro.engine.plan import KeySpace as JKeys
from repro.engine.plan import ReduceSpec as JReduce
from repro.engine.plan import WindowSpec as JWindow
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import Windowing as JWindowing

from repro_torch.analysis import PlanLintWarning
from repro_torch.engine import stages
from repro_torch.engine.plan import (ExecutionPlan, KeySpace, ReduceSpec,
                                     WindowSpec)
from repro_torch.kernels.fused_fold.ref import fused_streaming_fold_ref
from repro_torch.pipeline import Pipeline, Windowing
from repro_torch.workloads.linear_road import median_reduce

KINDS = stages.SEGMENT_REDUCE_KINDS


def _same(a, b: torch.Tensor) -> None:
    """Equal values, dtype and shape."""
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The grouping shuffle's stages
# ---------------------------------------------------------------------------

def test_hash_partition_and_sort_and_group():
    rng = np.random.default_rng(1)
    keys = rng.integers(-(2 ** 31), 2 ** 31 - 1, 4000).astype(np.int32)
    for r in (1, 3, 8, 1000):
        _same(jstages.hash_partition(jnp.asarray(keys), r),
              stages.hash_partition(_t(keys), r))
    k = rng.integers(0, 20, 300).astype(np.int32)
    valid = rng.random(300) > 0.3
    for vals in (rng.random(300).astype(np.float32),
                 rng.integers(0, 9, (300, 3)).astype(np.float32)):
        for ok in (None, valid):
            want = jstages.sort_and_group(
                jnp.asarray(k), jnp.asarray(vals),
                None if ok is None else jnp.asarray(ok))
            got = stages.sort_and_group(_t(k), _t(vals),
                                        None if ok is None else _t(ok))
            for a, b in zip(want, got):
                _same(a, b)


@pytest.mark.parametrize("capacity", [4, 40, 400])
def test_build_send_buffers_with_overflow(capacity):
    """Send buffers and their accounting, overflow included: equal
    buffers and equal ``sent`` / ``dropped``, 1-D and 2-D values."""
    rng = np.random.default_rng(capacity)
    keys = rng.integers(0, 50, 300).astype(np.int32)
    valid = rng.random(300) > 0.2
    for vals in (rng.random(300).astype(np.float32),
                 rng.integers(0, 9, (300, 2)).astype(np.int32)):
        want = jstages.build_send_buffers(jnp.asarray(keys),
                                          jnp.asarray(vals), 4, capacity,
                                          jnp.asarray(valid))
        got = stages.build_send_buffers(_t(keys), _t(vals), 4, capacity,
                                        _t(valid))
        for a, b in zip(want[:3], got[:3]):
            _same(a, b)
        _same(want[3].sent, got[3].sent)
        _same(want[3].dropped, got[3].dropped)
    assert (int(got[3].dropped) > 0) == (capacity < 100)


def test_exchange_and_shuffle_group_over_the_worker_axis():
    """The explicit worker axis: ``exchange`` is the reference's tiled
    ``all_to_all`` and ``shuffle_group`` its whole grouping shuffle,
    per-worker stats included, with drops at a small capacity."""
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 30, (W, 80)).astype(np.int32)
    vals = rng.random((W, 80)).astype(np.float32)
    valid = rng.random((W, 80)) > 0.1
    sk, sv, sok, _ = jax.vmap(
        lambda k, v, ok: jstages.build_send_buffers(k, v, W, 24, ok))(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
    want = jax.vmap(partial(jstages.exchange, axis_name="w"),
                    axis_name="w")(sk, sv, sok)
    got = stages.exchange(_t(np.asarray(sk)), _t(np.asarray(sv)),
                          _t(np.asarray(sok)))
    for a, b in zip(want, got):
        _same(a, b)
    for cap in (12, 60):
        want = jax.vmap(lambda k, v, ok: jstages.shuffle_group(
            k, v, "w", W, cap, ok), axis_name="w")(
            jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
        got = stages.shuffle_group(_t(keys), _t(vals), W, cap, _t(valid))
        for a, b in zip(want[:3], got[:3]):
            _same(a, b)
        _same(want[3].sent, got[3].sent)
        _same(want[3].dropped, got[3].dropped)
    assert int(got[3].dropped.sum()) == 0 < int(want[3].sent.sum())
    with pytest.raises(ValueError, match="one partition"):
        stages.shuffle_group(_t(keys), _t(vals), W + 1, 8, _t(valid))


def _sorted_stream(rng, n, n_keys, values):
    keys = rng.integers(0, n_keys, n).astype(np.int32)
    valid = rng.random(n) > 0.2
    return jstages.sort_and_group(jnp.asarray(keys), jnp.asarray(values),
                                  jnp.asarray(valid))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("values", ["real", "int", "wide"])
def test_segment_reduce_every_kind(kind, values):
    """Every built-in kind over a sorted stream with an invalid tail:
    real-valued float32 (sums bit for bit: a left fold in both), int32,
    and ``(n, 3)`` float32 values (``count`` comes out ``(n, 1)``)."""
    rng = np.random.default_rng(11)
    n = 500
    vals = {"real": rng.standard_normal(n).astype(np.float32),
            "int": rng.integers(-50, 50, n).astype(np.int32),
            "wide": rng.random((n, 3)).astype(np.float32)}[values]
    sk, sv, starts = _sorted_stream(rng, n, 40, vals)
    want = jstages.segment_reduce(kind, sk, sv, starts)
    got = stages.apply_reduce_fn(kind, _t(np.asarray(sk)),
                                 _t(np.asarray(sv)),
                                 _t(np.asarray(starts)))
    for a, b in zip(want, got):
        _same(a, b)
    with pytest.raises(ValueError, match="unknown segment reducer"):
        stages.segment_reduce("median", _t(np.asarray(sk)),
                              _t(np.asarray(sv)), _t(np.asarray(starts)))


def _jax_median_reduce(keys, values, starts):
    """The reference's median reducer (``tests/test_engine_plan.py``)."""
    n = keys.shape[0]
    valid = keys != jstages.INT32_MAX
    seg = jnp.cumsum(starts) - 1
    seg = jnp.where(valid, seg, n)
    order = jnp.lexsort((values, seg))
    v = values[order]
    s = seg[order]
    counts = jnp.zeros((n + 1,), jnp.int32).at[s].add(1)[:n]
    offsets = jnp.cumsum(counts) - counts
    lo = jnp.clip(offsets + (counts - 1) // 2, 0, n - 1)
    hi = jnp.clip(offsets + counts // 2, 0, n - 1)
    med = (v[lo] + v[hi]) / 2.0
    group_keys = jnp.full((n + 1,), -1, jnp.int32).at[s].max(
        jnp.where(valid, keys, -1))[:n]
    group_valid = (group_keys >= 0) & (counts > 0)
    return group_keys, jnp.where(group_valid, med, 0.0), group_valid


def test_median_reduce_twin():
    """``median_reduce`` (the torch twin) gives the reference reducer's
    triple on real and integer-valued streams, odd and even groups."""
    rng = np.random.default_rng(13)
    for vals in (rng.standard_normal(600).astype(np.float32),
                 rng.integers(0, 101, 600).astype(np.float32)):
        sk, sv, starts = _sorted_stream(rng, 600, 25, vals)
        want = _jax_median_reduce(sk, sv, starts)
        got = median_reduce(_t(np.asarray(sk)), _t(np.asarray(sv)),
                            _t(np.asarray(starts)))
        for a, b in zip(want, got):
            _same(a, b)


def _wire(rng, n, fanout, keymax):
    last = rng.integers(-10, 20, n)
    nw = rng.integers(1, fanout + 1, n)
    return np.stack([last, nw, rng.integers(0, keymax, n),
                     rng.integers(0, 100, n), rng.random(n) > 0.15],
                    axis=1).astype(np.float32)


@pytest.mark.parametrize("min_window", [-(2 ** 31), 0, 7])
def test_window_fanout_matches_reference_and_fused_fold(min_window):
    """The fan-out rule: the reference's outputs exactly, and the fused
    fold's (plain version's) late and expanded counts on the same rows."""
    rng = np.random.default_rng(17)
    rows = _wire(rng, 400, 4, 16)
    dec = (rows[:, 0].astype(np.int32), rows[:, 1].astype(np.int32),
           rows[:, 2].astype(np.int32), rows[:, 3], rows[:, 4] > 0)
    want = jstages.window_fanout(*map(jnp.asarray, dec), 4, 6,
                                 jnp.int32(min_window))
    got = stages.window_fanout(*map(_t, dec), 4, 6, min_window)
    for a, b in zip(want, got):
        _same(a, b)
    carry = torch.zeros((6 * 16, 2))
    _, fstats = fused_streaming_fold_ref(
        _t(rows), carry, min_window, fanout=4, n_slots=6, num_buckets=16,
        carry_buckets=16, hashed=False, host_wire=False, kind="sum")
    assert fstats[0] == got[4] and fstats[1] == got[5]


def test_append_gather_clear_window_records():
    """Per-slot record buffers over three appends (the last overflowing
    ``capacity``), then every slot's finalization under every kind and a
    user reducer, then a clear — the reference's per-worker functions
    under ``vmap`` against the port's on the stacked buffers."""
    rng = np.random.default_rng(19)
    n_slots, cap, nb = 4, 24, 8
    shape = (W, n_slots, cap)
    jk = jnp.full(shape, -1, jnp.int32)
    jv = jnp.zeros(shape, jnp.float32)
    jc = jnp.zeros((W, n_slots), jnp.int32)
    pk, pv = torch.full(shape, -1, dtype=torch.int32), torch.zeros(shape)
    pc = torch.zeros((W, n_slots), dtype=torch.int32)
    append = jax.vmap(lambda *a: jstages.append_window_records(
        *a, n_slots, cap, nb))
    for m in (30, 20, 60):
        flat = rng.integers(0, n_slots * nb, (W, m)).astype(np.int32)
        vals = rng.integers(0, 50, (W, m)).astype(np.float32)
        ok = rng.random((W, m)) > 0.2
        jk, jv, jc, jd = append(jk, jv, jc, jnp.asarray(flat),
                                jnp.asarray(vals), jnp.asarray(ok))
        outs = [stages.append_window_records(pk[w], pv[w], pc[w],
                                             _t(flat[w]), _t(vals[w]),
                                             _t(ok[w]), n_slots, cap, nb)
                for w in range(W)]
        pk, pv, pc = (torch.stack([o[i] for o in outs]) for i in range(3))
        for a, b in ((jk, pk), (jv, pv), (jc, pc),
                     (jd, torch.stack([o[3] for o in outs]))):
            _same(a, b)
    assert int(np.asarray(jd).sum()) > 0                # the last overflowed
    for slot in range(n_slots):
        for fn in KINDS + (_jax_median_reduce,):
            mine = median_reduce if callable(fn) else fn
            want = jax.vmap(lambda k, v: jstages.gather_window_group(
                k, v, slot, "w", fn), axis_name="w",
                out_axes=None)(jk, jv)
            got = stages.gather_window_group(pk, pv, slot, mine)
            for a, b in zip(want, got):
                _same(a, b)
    jk, jv, jc = jax.vmap(lambda *a: jstages.clear_window_group(*a, 2))(
        jk, jv, jc)
    stages.clear_window_group(pk, pv, pc, 2)
    for a, b in ((jk, pk), (jv, pv), (jc, pc)):
        _same(a, b)


# ---------------------------------------------------------------------------
# Compiled plans
# ---------------------------------------------------------------------------

def _group_plans(kind, *, hashed, capacity):
    def make(P, K, R, Wn):
        ks = K.hashed(16) if hashed else K.dense(16)
        return P(ks, R("group", reduce_fn=kind, capacity=capacity), W,
                 Wn(100.0, 25.0, 8))
    return (make(JPlan, JKeys, JReduce, JWindow).compile(),
            make(ExecutionPlan, KeySpace, ReduceSpec,
                 WindowSpec).compile(device="cpu"))


@pytest.mark.parametrize("hashed", [False, True], ids=["dense", "hashed"])
def test_stream_group_step_finalize_clear_parity(hashed):
    """``CompiledStreamGroup`` step by step against the reference's
    ``vmap`` plan: the carry dict and the ``[late, expanded, dropped]``
    stats after every fold (the port's flat wire, the reference's dealt
    to its workers in contiguous slices), every slot's finalization and
    a slot clear — equal, overflow included."""
    rng = np.random.default_rng(23)
    jp, pp = _group_plans("sum", hashed=hashed, capacity=16)
    jc, pc = jp.init_carry(), pp.init_carry()
    assert sorted(pc) == ["counts", "keys", "vals"]
    dropped = 0
    for _ in range(3):
        rows = _wire(rng, 200, 4, (1 << 20) if hashed else 16)
        jc, js = jp.step(rows.reshape(W, -1, 5), jc, 2)
        pc, ps = pp.step(rows, pc, 2)
        _same(js, ps)
        dropped += int(ps[2])
        for name in pc:
            _same(jc[name], pc[name])
    assert dropped > 0
    for slot in range(8):
        for a, b in zip(jp.finalize_slot(jc, slot),
                        pp.finalize_slot(pc, slot)):
            _same(a, b)
    jc, pc = jp.clear_slot(jc, 5), pp.clear_slot(pc, 5)
    for name in pc:
        _same(jc[name], pc[name])


def test_group_plan_validation():
    """The reference's refusals, word for word."""
    ks, ws = KeySpace.dense(16), WindowSpec(100.0, 25.0, 8)
    with pytest.raises(ValueError, match="positive capacity"):
        ExecutionPlan(ks, ReduceSpec("group"), W, ws).compile(device="cpu")
    host = WindowSpec(100.0, 25.0, 8, fanout_on_device=False)
    with pytest.raises(ValueError, match="on-device fan-out only"):
        ExecutionPlan(ks, ReduceSpec("group", capacity=8), W,
                      host).compile(device="cpu")
    with pytest.raises(ValueError, match="session windows"):
        ExecutionPlan(ks, ReduceSpec("group", capacity=8), W,
                      WindowSpec.session(5.0)).compile(device="cpu")


# ---------------------------------------------------------------------------
# Batch (array) group mode
# ---------------------------------------------------------------------------

def _shards(keys, vals, n_workers=W):
    n = -(-len(keys) // n_workers) * n_workers
    rows = np.zeros((n, 3), np.float32)
    rows[:len(keys), 0] = keys
    rows[:len(keys), 1] = vals
    rows[:len(keys), 2] = 1.0
    return rows.reshape(n_workers, n // n_workers, 3)


def _jmap(shard):
    return shard[:, 0].astype(jnp.int32), shard[:, 1], shard[:, 2] > 0


def _pmap(shard):
    return shard[:, 0].to(torch.int32), shard[:, 1], shard[:, 2] > 0


def _array(pk_pipeline, shards, map_fn, *, kind, capacity, finalize,
           key_space="dense", **build):
    return (pk_pipeline.from_source(shards=shards).map(map_fn)
            .reduce(kind, mode="group", capacity=capacity)
            .build(num_buckets=32, n_workers=W, key_space=key_space,
                   finalize=finalize, **build)).run_batch(data=shards)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("finalize", [True, False])
def test_batch_group_matches_reference(kind, finalize):
    """Array pipelines in group mode, dense and hashed, at a capacity that
    drops and one that does not: the ``(gk, gv, gvalid)`` triple (real
    values: sums bit for bit) and ``ShuffleStats`` equal the reference's
    ``vmap`` backend, per-bucket collisions included."""
    rng = np.random.default_rng(29)
    for key_space, keymax in (("dense", 32), ("hashed", 1 << 20)):
        keys = rng.integers(0, keymax, 230)
        shards = _shards(keys, rng.random(230) * 10)
        for cap in (8, 256):
            (ja, js) = _array(JPipeline, shards, _jmap, kind=kind,
                              capacity=cap, finalize=finalize,
                              key_space=key_space, backend="vmap")
            (pa, ps) = _array(Pipeline, shards, _pmap, kind=kind,
                              capacity=cap, finalize=finalize,
                              key_space=key_space, device="cpu")
            for a, b in zip(ja, pa):
                _same(a, b)
            _same(js.sent, ps.sent)
            _same(js.dropped, ps.dropped)
            assert (int(ps.dropped) > 0) == (cap == 8)
            if key_space == "hashed":
                _same(js.bucket_collisions, ps.bucket_collisions)


def test_batch_group_equals_aggregate_and_counts_drops():
    """Group ``sum`` equals the aggregate count of the same shards when
    nothing drops; a small capacity reports its drops, and what is kept
    plus what is dropped is every record."""
    rng = np.random.default_rng(31)
    keys = rng.integers(0, 32, 2000)
    shards = _shards(keys, np.ones(2000))
    agg, _ = (Pipeline.from_source(shards=shards).map(_pmap).reduce("sum")
              .build(num_buckets=32, n_workers=W, device="cpu")).run()
    (gk, gv, gvalid), stats = _array(Pipeline, shards, _pmap, kind="sum",
                                     capacity=4096, finalize=True,
                                     device="cpu")
    assert int(stats.dropped) == 0 and int(stats.sent) == 2000
    got = {int(k): float(v) for k, v, ok in zip(gk, gv, gvalid) if ok}
    assert got == {k: float(agg[k]) for k in range(32) if agg[k]}
    (_, gv, gvalid), stats = _array(Pipeline, shards, _pmap, kind="count",
                                    capacity=16, finalize=True,
                                    device="cpu")
    assert int(stats.dropped) > 0
    assert int(gv[gvalid].sum()) + int(stats.dropped) == 2000


def test_hashed_batch_group_end_to_end():
    """The reference's hashed group case: 200 raw keys over 32 buckets,
    per-bucket sums equal a host oracle, collisions counted."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 20, 200)
    vals = rng.integers(1, 5, 200)
    (gk, gv, gvalid), stats = _array(Pipeline, _shards(keys, vals), _pmap,
                                     kind="sum", capacity=512,
                                     finalize=True, key_space="hashed",
                                     device="cpu")
    want = defaultdict(float)
    for k, v in zip(keys, vals):
        want[stages.host_bucket(int(k), 32)] += float(v)
    got = {int(k): float(v) for k, v, ok in zip(gk, gv, gvalid) if ok}
    assert got == dict(want)
    assert int(stats.dropped) == 0 and int(stats.collisions) > 0


# ---------------------------------------------------------------------------
# Windowed group streams
# ---------------------------------------------------------------------------

def _stream(pk, evs, spec, *, size, slide=None, capacity=1024, n_slots=8,
            num_buckets=16, key_space="dense", mode="group", job="g",
            sync=False):
    w = (pk.Windowing.sliding(size, slide) if slide
         else pk.Windowing.tumbling(size))
    built = (pk.Pipeline.from_source(records=evs, batch_records=256)
             .key_by().window(w)
             .reduce(spec, mode=mode, capacity=capacity).sink("out/")
             .build(num_buckets=num_buckets, n_workers=W, n_slots=n_slots,
                    key_space=key_space, batch_records=256, job_id=job,
                    **pk.build))
    store = pk.Store()
    opts = pk.RunOptions(**pk.sync) if sync else None
    report = built.run(None, store=store, meta=pk.Meta(), mode="streaming",
                       options=opts)
    assert report.error is None
    return built.collect_outputs(store), report


def _report(r):
    return (r.records_in, r.records_expanded, r.late_dropped,
            r.capacity_dropped, r.windows_emitted)


@pytest.mark.parametrize("sync", [False, True], ids=["overlap", "sync"])
def test_streaming_median_matches_reference_and_oracle(sync):
    """A non-algebraic reducer over each key's full value list: the sinks
    equal the reference's (its ``_median_reduce``) byte for byte and a
    numpy median oracle, with the scheduler's lanes on and off."""
    evs = events(n=2000, n_keys=6, span=200.0, seed=5, vmax=50)
    ref, rr = _stream(JAX, evs, _jax_median_reduce, size=50.0,
                      n_slots=4, sync=sync)
    got, pr = _stream(PORT, evs, median_reduce, size=50.0, n_slots=4,
                      sync=sync)
    assert got == ref and len(got) == 4
    assert _report(pr) == _report(rr)
    assert pr.capacity_dropped == 0
    oracle = defaultdict(lambda: defaultdict(list))
    for ts, k, v in evs:
        oracle[int(ts // 50.0)][k].append(v)
    for widx, per_key in oracle.items():
        blob = got[f"out/g/window-{widx * 50.0:.3f}-{(widx + 1) * 50.0:.3f}"]
        assert dict(json.loads(ln) for ln in blob.splitlines()) == {
            k: float(np.median(vs)) for k, vs in per_key.items()}


def test_streaming_sliding_max_and_count_equal_aggregate():
    """Sliding ``max`` over overlapping windows equals the reference and
    a host oracle; a group ``count`` stream emits what the aggregate
    ``count`` stream of the same program does."""
    evs = events(n=1500, n_keys=5, span=150.0, seed=7, vmax=50)
    ref, rr = _stream(JAX, evs, "max", size=40.0, slide=20.0, n_slots=6)
    got, pr = _stream(PORT, evs, "max", size=40.0, slide=20.0, n_slots=6)
    assert got == ref and pr.records_expanded == 2 * len(evs)
    oracle = defaultdict(lambda: defaultdict(float))
    for ts, k, v in evs:
        for widx in (int(ts // 20.0) - 1, int(ts // 20.0)):
            oracle[widx][k] = max(oracle[widx][k], v)
    for widx, per_key in oracle.items():
        blob = got[f"out/g/window-{widx * 20.0:.3f}-"
                   f"{widx * 20.0 + 40.0:.3f}"]
        assert dict(json.loads(ln) for ln in blob.splitlines()) \
            == dict(per_key)
    grouped, _ = _stream(PORT, evs, "count", size=40.0, slide=20.0,
                         n_slots=6)
    aggregate, _ = _stream(PORT, evs, "count", size=40.0, slide=20.0,
                           n_slots=6, mode="aggregate", capacity=0)

    def counts(out):
        return {k: {lab: int(v) for lab, v in
                    (json.loads(ln) for ln in blob.splitlines())}
                for k, blob in out.items()}
    assert counts(grouped) == counts(aggregate)


def test_streaming_group_capacity_overflow_is_counted():
    evs = [(float(i) % 10.0, f"k{i % 3}", 1.0) for i in range(600)]
    ref, rr = _stream(JAX, evs, "count", size=100.0, capacity=8,
                      n_slots=2)
    with pytest.warns(PlanLintWarning, match="PL003"):
        got, pr = _stream(PORT, evs, "count", size=100.0, capacity=8,
                          n_slots=2)
    assert got == ref and pr.capacity_dropped == rr.capacity_dropped > 0
    total = sum(json.loads(ln)[1] for blob in got.values()
                for ln in blob.splitlines())
    assert total + pr.capacity_dropped == len(evs)


@pytest.mark.parametrize("seed,kind", [(3, "min"), (4, "max"),
                                       (2 ** 31 - 2, "min"), (99, "max")])
def test_segment_minmax_hashed_collisions_ring_reuse(seed, kind):
    """The reference's property over fixed seeds: min/max under hashed
    collisions (40 keys into 8 buckets) and ring reuse (4 slots over ~20
    sliding windows) — equal to the reference byte for byte and to a
    host oracle by bucket."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 300.0, 1200))
    keys = rng.integers(0, 40, 1200)
    vals = rng.integers(-50, 50, 1200).astype(float)
    evs = [(float(t), f"key-{k}", float(v))
           for t, k, v in zip(ts, keys, vals)]
    kw = dict(size=30.0, slide=15.0, n_slots=4, capacity=4096,
              num_buckets=8, key_space="hashed")
    ref, rr = _stream(JAX, evs, kind, **kw)
    got, pr = _stream(PORT, evs, kind, **kw)
    assert got == ref and pr.hash_collisions == rr.hash_collisions > 0
    per = defaultdict(lambda: defaultdict(list))
    for t, key, v in evs:
        b = stages.host_bucket(stages.fold_key24(key), 8)
        for widx in (int(t // 15.0) - 1, int(t // 15.0)):
            per[widx][b].append(v)
    red = min if kind == "min" else max
    for blob_key, blob in got.items():
        widx = round((float(blob_key.rsplit("-", 1)[1]) - 30.0) / 15.0)

        def bucket_of(label):
            if label.startswith("bucket-"):
                return int(label[len("bucket-"):].split("[", 1)[0])
            return stages.host_bucket(stages.fold_key24(label), 8)
        assert {bucket_of(lab): v for lab, v in
                (json.loads(ln) for ln in blob.splitlines())} \
            == {b: float(red(vs)) for b, vs in per[widx].items()}
    assert len(got) == len(per)


def test_group_pipeline_validation_matches_reference():
    """Grammar errors of group pipelines, word for word."""
    one = [(0.0, "a", 1.0)]

    def cases(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        src = P.from_source(records=one).key_by()
        return [
            lambda: src.window(10.0).reduce("median", mode="group",
                                            capacity=8).build(**pk.build),
            lambda: src.window(10.0).reduce("max", mode="group").build(
                **pk.build),
            lambda: src.window(10.0).reduce("max", mode="group",
                                            capacity=8).build(
                fanout="host", **pk.build),
            lambda: src.window(Wn.session(5.0)).reduce(
                "max", mode="group", capacity=8).build(**pk.build),
            lambda: src.window(10.0).reduce("max", mode="group", capacity=8)
            .join(P.from_source(records=one).window(10.0).reduce("sum"))
            .build(**pk.build),
        ]
    for want, got in zip(cases(JAX), cases(PORT)):
        with pytest.raises(JAX.Error) as jerr:
            want()
        with pytest.raises(PORT.Error) as perr:
            got()
        assert str(perr.value) == str(jerr.value)


def test_pl003_matches_reference():
    """PL003 finds a group capacity below one micro-batch's worst-case
    load in both packages, with the same message, and ``build`` warns of
    it; a capacity above it is clean."""
    def build(P, Wn, capacity, **extra):
        return (P.from_source(batch_records=256).key_by()
                .window(Wn.tumbling(10.0))
                .reduce("max", mode="group", capacity=capacity)
                .sink("out/")
                .build(num_buckets=8, n_workers=W, batch_records=256,
                       job_id="pl3", **extra))

    with pytest.warns(PlanLintWarning, match="PL003"):
        low = build(Pipeline, Windowing, 8, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", PlanLintWarning)
        high = build(Pipeline, Windowing, 64, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = {cap: build(JPipeline, JWindowing, cap) for cap in (8, 64)}
    for cap, built in ((8, low), (64, high)):
        want = [(d.rule_id, d.level, d.message, d.loc)
                for d in ref[cap].check()]
        got = [(d.rule_id, d.level, d.message, d.loc) for d in built.check()]
        assert got == want
        assert [r for r, *_ in got] == (["PL003"] if cap == 8 else [])
    report = low.explain()
    assert "PL003" in report and "mode=group" in report


# ---------------------------------------------------------------------------
# A group stage inside a stage DAG
# ---------------------------------------------------------------------------

def _dag(pk, evs, *, first="group", **build):
    """Stage 1 counts per key per 10 s (aggregate) or takes each key's
    max value (group); stage 2 is the other mode over 50 s windows, fed
    over the carry edge."""
    src = (pk.Pipeline.from_source(records=evs, batch_records=100)
           .key_by().window(pk.Windowing.tumbling(10.0)))
    if first == "group":
        chain = (src.reduce("max", mode="group", capacity=256)
                 .window(pk.Windowing.sliding(50.0, 25.0)).reduce("mean"))
    else:
        chain = (src.reduce("count")
                 .window(pk.Windowing.sliding(50.0, 25.0))
                 .reduce("max", mode="group", capacity=256))
    return chain.sink("dag/").build(num_buckets=12, n_workers=W,
                                    job_id="gdag", **build, **pk.build)


@pytest.mark.parametrize("first", ["group", "aggregate"])
def test_group_stage_inside_a_dag(first):
    """A group stage feeding an aggregate stage (a host edge: a group
    window emits records) and an aggregate stage feeding a group stage
    (an identity boundary: a device edge): both packages emit the same
    bytes, streamed and in one batch."""
    evs = events(n=1200, n_keys=5, span=300.0, seed=37, vmax=20)
    ref = streamed(JAX, _dag(JAX, evs, first=first))
    built = _dag(PORT, evs, first=first)
    assert [e.device for e in built.edges] == [first == "aggregate"]
    assert [st.mode for st in built.stages] == (
        ["group", "aggregate"] if first == "group" else
        ["aggregate", "group"])
    assert streamed(PORT, built) == ref and ref
    outputs, report = _dag(PORT, evs, first=first).run(store=PORT.Store())
    assert outputs == ref and report.handoffs > 0


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_group_checkpoint_restores_across_packages(first, then):
    """A windowed group job crashes mid-stream under one package and
    resumes under the other from its checkpoint (the dict carry's
    ``counts``, ``keys``, ``vals`` leaves in the reference's ``vmap``
    shapes): the sinks equal an uncrashed run, every window written
    once."""
    evs = events(n=1400, n_keys=6, span=280.0, seed=41, vmax=30)
    pkgs = {"jax": JAX, "port": PORT}

    def build(pk):
        reducer = _jax_median_reduce if pk is JAX else median_reduce
        return (pk.Pipeline.from_source(batch_records=100).key_by()
                .window(pk.Windowing.sliding(40.0, 20.0))
                .reduce(reducer, mode="group", capacity=200).sink("gx/")
                .build(num_buckets=8, n_workers=W, n_slots=4,
                       checkpoint_interval=2, job_id="gx", **pk.build))

    ref = streamed(PORT, build(PORT),
                   source=PORT.Source.from_records(evs, batch_records=100))
    a, b = pkgs[first], pkgs[then]
    store, meta = CountingStore(), a.Meta()
    dead = crashing(a.Coordinator)(store, meta, program=build(a),
                                   crash_batch=7)
    with pytest.raises(Boom):
        dead.run_stream(a.Source.from_records(evs, batch_records=100),
                        announce=False, flush=False)
    state = meta.get("stream/gx/state")
    assert state["offset"] == 600
    assert state["carry_shapes"] == [[W, 4], [W, 4, 200], [W, 4, 200]]
    meta = json_meta(meta, b.Meta)
    report = build(b).run(b.Source.from_records(evs, batch_records=100),
                          store=store, meta=meta, mode="streaming")
    assert report.error is None
    assert build(PORT).collect_outputs(store) == ref
    for key in ref:
        assert store.put_counts[key] == 1, key
