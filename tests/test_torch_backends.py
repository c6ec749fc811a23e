"""The ``vmap`` backend (simulated workers) against the reference's.

The same numpy inputs, drawn from a seed with integer values (so every
float32 sum is exact in any order), go through ``repro`` with
``backend="vmap"`` (JAX on the CPU) and ``repro_torch`` with
``backend="vmap"`` and ``device="cpu"`` (the kernels' plain versions), and
must give the same bytes: carries in the reference's per-worker layouts,
fold stats, sink objects, ``handoff_rows`` wires, batch results and
``ShuffleStats``, the façade's helpers, checkpoints moved between the
packages in both directions, and the divisibility errors.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapreduce as jmr
from repro.engine import plan as jplan
from repro.engine import stages as jstages
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineError as JPipelineError
from repro.pipeline import Windowing as JWindowing

from repro_torch.core import mapreduce as pmr
from repro_torch.engine import plan as pplan
from repro_torch.engine import stages as pstages
from repro_torch.pipeline import Pipeline, PipelineError, Windowing

from _torch_pkgs import JAX, PORT, crashing, Boom

W = 4


def _events(n=900, n_keys=7, span=180.0, seed=0, vmax=9, jitter=0.0):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, span, n))
    if jitter:
        ts = np.clip(ts + rng.normal(0, jitter, n), 0, None)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, vmax, n).astype(float)
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


def _opts(pk):
    return pk.RunOptions(**pk.sync)


def _build(pk, pipeline, **kw):
    extra = {"device": "cpu"} if pk is PORT else {}
    return pipeline.build(backend="vmap", **kw, **extra)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(carry):
    if isinstance(carry, dict):
        return [_host(carry[k]) for k in sorted(carry)]
    return [_host(carry)]


def _drive(pk, built, events, batch_records=100):
    """Stream ``events`` unflushed, snapshot every stage's carry, then
    flush: ``(carries, sinks, report)``."""
    store, meta = pk.Store(), pk.Meta()
    coord = pk.Coordinator(store, meta, program=built, options=_opts(pk))
    report = coord.run_stream(
        pk.Source.from_records(events, batch_records=batch_records),
        announce=False, flush=False)
    carries = [leaf.copy() for st in coord.stages
               for leaf in _leaves(st.carry)]
    coord.flush_end_of_stream(report)
    return carries, built.collect_outputs(store), report


def _same_drive(a, b):
    (ca, sa, ra), (cb, sb, rb) = a, b
    assert sa, "no window emitted"
    assert sa == sb
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()
    for field in ("records_in", "records_expanded", "late_dropped",
                  "windows_emitted", "handoffs", "hash_collisions",
                  "capacity_dropped", "batches"):
        assert getattr(ra, field) == getattr(rb, field), field


# ---------------------------------------------------------------------------
# Single-stage streams: windows × key spaces × wires
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanout", ["device", "host"])
@pytest.mark.parametrize("key_space", ["dense", "hashed"])
@pytest.mark.parametrize("window", ["tumbling", "sliding"])
def test_vmap_stream_matches_reference(window, key_space, fanout):
    """Carries ``(W, per, 2)``, fold stats and sinks equal the reference's
    ``vmap`` drive; the wire pads every worker to ``per`` rows, and the
    padding is neither folded nor counted (``records_expanded``,
    ``late_dropped``)."""
    events = _events(seed=3, jitter=4.0)

    def make(pk):
        win = (pk.Windowing.tumbling(20.0) if window == "tumbling"
               else pk.Windowing.sliding(30.0, 10.0))
        return _build(pk, pk.Pipeline.from_source(records=[]).key_by()
                      .window(win).reduce("mean"), num_buckets=16,
                      n_workers=W, key_space=key_space, fanout=fanout,
                      allowed_lateness=0.5, job_id="vm", batch_records=100)

    got = _drive(PORT, make(PORT), events)
    want = _drive(JAX, make(JAX), events)
    assert got[0][0].shape == (W, 8 * 16 // W, 2)
    _same_drive(got, want)
    assert got[2].late_dropped > 0


def test_vmap_top_k_matches_reference():
    events = _events(seed=5)

    def make(pk):
        return _build(pk, pk.Pipeline.from_source(records=[]).key_by()
                      .window(pk.Windowing.sliding(40.0, 20.0))
                      .reduce("sum").top_k(3, by="count"), num_buckets=12,
                      n_workers=W, job_id="tk", batch_records=100)

    _same_drive(_drive(PORT, make(PORT), events),
                _drive(JAX, make(JAX), events))


def test_vmap_join_channel_pair_matches_reference():
    """A windowed join under ``vmap``: both sides fold into their channel
    pairs of one ``(W, per, 4)`` carry."""
    left, right = _events(seed=7), _events(seed=8, n_keys=5)

    def run(pk):
        built = _build(pk, pk.Pipeline.from_source(records=[]).key_by()
                       .window(pk.Windowing.tumbling(30.0)).reduce("sum")
                       .join(pk.Pipeline.from_source(records=[]).key_by()
                             .window(pk.Windowing.tumbling(30.0))
                             .reduce("count")),
                       num_buckets=(8, 12), n_workers=W, job_id="jn",
                       batch_records=100)
        store, meta = pk.Store(), pk.Meta()
        coord = pk.Coordinator(store, meta, program=built, options=_opts(pk))
        src = pk.JoinSource(pk.Source.from_records(left, batch_records=100),
                            pk.Source.from_records(right, batch_records=100),
                            100)
        report = coord.run_stream(src, announce=False, flush=False)
        carries = [leaf.copy() for st in coord.stages
                   for leaf in _leaves(st.carry)]
        coord.flush_end_of_stream(report)
        return carries, built.collect_outputs(store), report

    got, want = run(PORT), run(JAX)
    assert got[0][0].shape == (W, 8 * 12 // W, 4)
    _same_drive(got, want)


def test_vmap_sessions_match_reference():
    """Session windows under ``vmap``: the host wire dealt to the workers,
    the cell reads, merges and clears on the ``(W, per, 2)`` carry."""
    events = _events(n=700, n_keys=9, span=400.0, seed=41)

    def make(pk):
        return _build(pk, pk.Pipeline.from_source(records=[]).key_by()
                      .window(pk.Windowing.session(6.0)).reduce("sum"),
                      num_buckets=12, n_workers=W, job_id="ss",
                      batch_records=100)

    _same_drive(_drive(PORT, make(PORT), events),
                _drive(JAX, make(JAX), events))


# ---------------------------------------------------------------------------
# Stage DAGs: chains and tee under vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("handoff", ["device", "host"])
def test_vmap_chain_matches_reference(handoff):
    events = _events(n=1200, seed=11)

    def make(pk):
        return _build(pk, pk.Pipeline.from_source(records=[]).key_by()
                      .window(pk.Windowing.tumbling(10.0)).reduce("count")
                      .window(pk.Windowing.sliding(40.0, 20.0))
                      .reduce("mean"), num_buckets=8, n_workers=W,
                      job_id="ch", handoff=handoff, batch_records=100)

    got = _drive(PORT, make(PORT), events)
    _same_drive(got, _drive(JAX, make(JAX), events))
    assert got[2].handoffs > 0


def test_vmap_tee_matches_reference():
    """A tee'd stage feeding a top-k branch over a device edge and a
    relabelled branch over a host edge."""
    events = _events(n=1200, seed=13)

    def make(pk):
        base = (pk.Pipeline.from_source(records=[]).key_by()
                .window(pk.Windowing.tumbling(20.0)).reduce("count"))
        return _build(pk, base.tee(
            pk.Pipeline.branch().window(pk.Windowing.tumbling(100.0))
            .reduce("sum").top_k(3).sink("tee-top/"),
            pk.Pipeline.branch().map(lambda r: (r[0], r[1].upper(), r[2]))
            .key_by().window(pk.Windowing.tumbling(100.0)).reduce("sum")
            .sink("tee-roll/")), num_buckets=28, n_workers=W, job_id="te",
            batch_records=100)

    _same_drive(_drive(PORT, make(PORT), events),
                _drive(JAX, make(JAX), events))


# ---------------------------------------------------------------------------
# The compiled plan's operations, call by call
# ---------------------------------------------------------------------------

def _wire(rng, n, per, *, host, n_keys, padded_garbage=True):
    """``(W, per, 4|5)`` wire rows: ``n`` valid records dealt in order,
    the rest padding (invalid, with nonzero fields the fold must ignore)."""
    width = 4 if host else 5
    rows = np.zeros((W * per, width), np.float32)
    if host:
        rows[:n] = np.stack([rng.integers(0, 8, n), rng.integers(0, n_keys, n),
                             rng.integers(0, 50, n), np.ones(n)], 1)
    else:
        rows[:n] = np.stack([rng.integers(2, 20, n), rng.integers(1, 4, n),
                             rng.integers(0, n_keys, n),
                             rng.integers(0, 50, n), np.ones(n)], 1)
    if padded_garbage:
        rows[n:, :-1] = rng.integers(0, 3, (W * per - n, width - 1))
    return rows.reshape(W, per, width)


def _plans(reduce=None, *, host=False, hashed=False, slide=25.0,
           key_space=16):
    ks = (jplan.KeySpace.hashed(key_space) if hashed
          else jplan.KeySpace.dense(key_space))
    pks = (pplan.KeySpace.hashed(key_space) if hashed
           else pplan.KeySpace.dense(key_space))
    if host:
        jws, pws = (jplan.WindowSpec(0.0, None, 8, fanout_on_device=False),
                    pplan.WindowSpec(0.0, None, 8, fanout_on_device=False))
    else:
        jws, pws = (jplan.WindowSpec(100.0, slide, 8),
                    pplan.WindowSpec(100.0, slide, 8))
    jr = jplan.ReduceSpec(**(reduce or {}))
    pr = pplan.ReduceSpec(**(reduce or {}))
    return (jplan.ExecutionPlan(ks, jr, W, jws).compile(backend="vmap"),
            pplan.ExecutionPlan(pks, pr, W, pws).compile(backend="vmap",
                                                         device="cpu"))


@pytest.mark.parametrize("wire", ["device", "host", "hashed"])
def test_vmap_plan_step_and_reads_match_reference(wire):
    """Three folds of padded wires (stats include the padding's absence),
    then every read and write op on the ``(W, per, C)`` carry."""
    rng = np.random.default_rng(17)
    host = wire == "host"
    jc, pc = _plans({"mode": "top_k", "k": 4}, host=host,
                    hashed=wire == "hashed")
    jcarry, pcarry = jc.init_carry(), pc.init_carry()
    assert tuple(jcarry.shape) == tuple(pcarry.shape) == (W, 32, 2)
    for n in (150, 37, 0):
        rows = _wire(rng, n, 40, host=host, n_keys=16 if not wire ==
                     "hashed" else 1000)
        if host:
            jcarry, js = jc.step(rows, jcarry)
            pcarry, ps = pc.step(rows, pcarry)
        else:
            jcarry, js = jc.step(rows, jcarry, 9)
            pcarry, ps = pc.step(torch.from_numpy(rows), pcarry, 9)
        assert np.array_equal(np.asarray(js), ps.numpy()), n
        assert _host(jcarry).tobytes() == pcarry.numpy().tobytes()
    for slot in range(8):
        assert np.array_equal(jc.read_slot(jcarry, slot),
                              pc.read_slot(pcarry, slot))
        for a, b in zip(jc.top_k_slot(jcarry, slot),
                        pc.top_k_slot(pcarry, slot)):
            assert np.array_equal(a, b)
    jcarry = jc.merge_cell(jcarry, 3, 5, 2)
    pcarry = pc.merge_cell(pcarry, 3, 5, 2)
    assert np.array_equal(jc.read_cell(jcarry, 5, 2),
                          pc.read_cell(pcarry, 5, 2))
    jcarry, pcarry = jc.clear_cell(jcarry, 5, 2), pc.clear_cell(pcarry, 5, 2)
    jcarry, pcarry = jc.clear_slot(jcarry, 4), pc.clear_slot(pcarry, 4)
    assert _host(jcarry).tobytes() == pcarry.numpy().tobytes()


@pytest.mark.parametrize("kind", ["count", "sum", "mean"])
def test_vmap_handoff_rows_match_reference(kind):
    """``handoff_rows`` emits the ``(workers, per, 5)`` wire."""
    rng = np.random.default_rng(19)
    jc, pc = _plans()
    rows = _wire(rng, 120, 40, host=False, n_keys=16)
    jcarry, _ = jc.step(rows, jc.init_carry(), 0)
    pcarry, _ = pc.step(rows, pc.init_carry(), 0)
    relabel = rng.integers(-1, 30, 16).astype(np.int32)
    for slot in (2, 7):
        want = jc.handoff_rows(jcarry, slot, jnp.asarray(relabel), 3, 2,
                               kind, 48)
        got = pc.handoff_rows(pcarry, slot, torch.from_numpy(relabel), 3, 2,
                              kind, 48)
        assert tuple(got.shape) == (W, 12, 5)
        assert np.asarray(want).tobytes() == got.numpy().tobytes()


def test_vmap_group_plan_matches_reference():
    """Windowed group mode under ``vmap``: the per-worker send buffers,
    the exchange (a transpose) and the ``(W, n_slots, capacity)``
    buffers, with a capacity small enough to drop."""
    rng = np.random.default_rng(23)
    jc, pc = _plans({"mode": "group", "reduce_fn": "max", "capacity": 6})
    jcarry, pcarry = jc.init_carry(), pc.init_carry()
    for n in (120, 60):
        rows = _wire(rng, n, 40, host=False, n_keys=16)
        jcarry, js = jc.step(rows, jcarry, 9)
        pcarry, ps = pc.step(rows, pcarry, 9)
        assert np.array_equal(np.asarray(js), ps.numpy())
        for k in ("keys", "vals", "counts"):
            assert _host(jcarry[k]).tobytes() == pcarry[k].numpy().tobytes()
    assert ps.numpy()[2] > 0                    # the buffers dropped
    for slot in range(8):
        for a, b in zip(jc.finalize_slot(jcarry, slot),
                        pc.finalize_slot(pcarry, slot)):
            assert np.array_equal(a, b)
    jcarry, pcarry = jc.clear_slot(jcarry, 3), pc.clear_slot(pcarry, 3)
    for k in ("keys", "vals", "counts"):
        assert _host(jcarry[k]).tobytes() == pcarry[k].numpy().tobytes()


def test_vmap_group_stream_matches_reference():
    events = _events(n=900, seed=29)

    def make(pk):
        return _build(pk, pk.Pipeline.from_source(records=[]).key_by()
                      .window(pk.Windowing.sliding(30.0, 10.0))
                      .reduce("max", mode="group", capacity=64),
                      num_buckets=10, n_workers=W, job_id="gs",
                      batch_records=100)

    _same_drive(_drive(PORT, make(PORT), events),
                _drive(JAX, make(JAX), events))


# ---------------------------------------------------------------------------
# Batch plans under vmap
# ---------------------------------------------------------------------------

def _pairs_jax(shard):
    return (shard[:, 0].astype(jnp.int32), shard[:, 1],
            shard[:, 2] > 0)


def _pairs_torch(shard):
    return shard[:, 0].to(torch.int32), shard[:, 1], shard[:, 2] > 0


def _shards(seed, n=48, keymax=40):
    rng = np.random.default_rng(seed)
    rows = np.zeros((W, n, 3), np.float32)
    rows[:, :, 0] = rng.integers(0, keymax, (W, n))
    rows[:, :, 1] = rng.integers(0, 9, (W, n))
    rows[:, :, 2] = rng.random((W, n)) > 0.2
    return rows


@pytest.mark.parametrize("case", ["sum", "unfinalized", "hashed", "top_k",
                                  "group", "group_unfinalized"])
def test_vmap_batch_matches_reference(case):
    """Results and ``ShuffleStats`` (collisions included) of array
    pipelines under ``vmap``, in the reference's shapes."""
    data = _shards(31)
    kw = dict(num_buckets=30, n_workers=W)
    if case == "hashed":
        kw["key_space"] = "hashed"
    if case in ("unfinalized", "group_unfinalized"):
        kw["finalize"] = False

    def make(P, fn):
        src = P.from_source(shards=data).map(fn)
        if case.startswith("group"):
            return src.reduce("sum", mode="group", capacity=16)
        if case == "top_k":
            return src.reduce("sum").top_k(5)
        return src.reduce("sum")

    want, wstats = make(JPipeline, _pairs_jax).build(
        backend="vmap", **kw).run_batch(data=data)
    got, gstats = make(Pipeline, _pairs_torch).build(
        backend="vmap", device="cpu", **kw).run_batch(data=data)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, b in zip(want, got):
        assert tuple(np.asarray(a).shape) == tuple(b.shape)
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert int(wstats.sent) == int(gstats.sent)
    assert int(wstats.dropped) == int(gstats.dropped)
    if case == "hashed":
        assert np.array_equal(np.asarray(wstats.bucket_collisions),
                              gstats.bucket_collisions.numpy())
        assert int(gstats.collisions) > 0


def test_bucket_owner_matches_reference():
    for nb, parts in ((10, 4), (16, 4), (7, 3), (1, 2)):
        assert np.array_equal(jstages.bucket_owner(nb, parts),
                              pstages.bucket_owner(nb, parts))


# ---------------------------------------------------------------------------
# The façade's streaming helpers
# ---------------------------------------------------------------------------

def test_facade_incremental_step_matches_reference():
    """``make_incremental_step`` / ``init_window_carry`` /
    ``read_window_slot`` / ``clear_window_slot`` with the reference's
    signatures and ``backend="vmap"`` default (the reference's
    ``tests/test_streaming.py`` case, and its invalid-row case)."""
    rng = np.random.default_rng(1)
    jcfg = jmr.DeviceJobConfig(num_buckets=8, n_workers=4)
    pcfg = pmr.DeviceJobConfig(num_buckets=8, n_workers=4)
    n_slots = 4
    jstep = jmr.make_incremental_step(jcfg, n_slots)
    pstep = pmr.make_incremental_step(pcfg, n_slots, device="cpu")
    jcarry = jmr.init_window_carry(jcfg, n_slots)
    pcarry = pmr.init_window_carry(pcfg, n_slots, device="cpu")
    assert tuple(pcarry.shape) == tuple(jcarry.shape) == (4, 8, 2)
    for _ in range(3):
        rows = np.zeros((4, 16, 4), np.float32)
        rows[..., 0] = rng.integers(0, n_slots, (4, 16))
        rows[..., 1] = rng.integers(0, 8, (4, 16))
        rows[..., 2] = rng.integers(0, 10, (4, 16))
        rows[..., 3] = rng.random((4, 16)) > 0.1
        jcarry, pcarry = jstep(rows, jcarry), pstep(rows, pcarry)
        assert _host(jcarry).tobytes() == pcarry.numpy().tobytes()
    for slot in range(n_slots):
        assert np.array_equal(jmr.read_window_slot(jcarry, slot, 8),
                              pmr.read_window_slot(pcarry, slot, 8))
    jcarry = jmr.clear_window_slot(jcarry, 1, 8)
    pcarry = pmr.clear_window_slot(pcarry, 1, 8)
    assert _host(jcarry).tobytes() == pcarry.numpy().tobytes()
    assert not pmr.read_window_slot(pcarry, 1, 8).any()
    assert pmr.INT32_MAX == int(jmr.INT32_MAX)
    with pytest.raises(ValueError, match="map_fn"):
        pmr.make_incremental_step(pcfg, n_slots, map_fn=lambda s: s,
                                  device="cpu")
    with pytest.raises(ValueError, match="run_combiner"):
        pmr.make_incremental_step(
            pmr.DeviceJobConfig(num_buckets=8, n_workers=4,
                                run_combiner=False), n_slots, device="cpu")


@pytest.mark.parametrize("backend", ["fused", "vmap"])
def test_facade_carry_layouts(backend):
    """The façade's carries in each single-process backend's layout, and
    the host-wire decode ``streaming_record_map`` equal to the
    reference's."""
    cfg = pmr.DeviceJobConfig(num_buckets=6, n_workers=3)
    carry = pmr.init_window_carry(cfg, 4, backend=backend, device="cpu")
    assert tuple(carry.shape) == ((24, 2) if backend == "fused"
                                  else (3, 8, 2))
    step = pmr.make_incremental_step(cfg, 4, backend=backend, device="cpu")
    rows = np.array([[1, 2, 5, 1], [1, 2, 7, 1], [3, 0, 4, 0]], np.float32)
    if backend == "vmap":
        rows = np.concatenate([rows, np.zeros((3, 4), np.float32)])
        rows = rows.reshape(3, 2, 4)
    carry = step(rows, carry)
    assert pmr.read_window_slot(carry, 1, 6)[2].tolist() == [12.0, 2.0]
    assert not pmr.read_window_slot(carry, 3, 6).any()
    shard = np.array([[1, 2, 5, 1], [3, 0, 4, 0]], np.float32)
    want = jmr.streaming_record_map(jnp.asarray(shard))
    got = pmr.streaming_record_map(torch.from_numpy(shard))
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# Checkpoints across the packages under vmap
# ---------------------------------------------------------------------------

def _json_meta(meta, Meta):
    fresh = Meta()
    for key in meta.keys():
        fresh.set(key, json.loads(json.dumps(meta.get(key))))
    return fresh


@pytest.mark.parametrize("program", ["aggregate", "group"])
@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_vmap_checkpoint_crosses_packages(first, then, program):
    """Crash under one package's ``vmap`` backend, resume under the
    other's from the checkpoint (the same ``(W, per, C)`` carry, or the
    group buffers): the sinks equal an uncrashed run."""
    events = _events(n=1000, seed=37, jitter=0.4)
    pks = {"jax": JAX, "port": PORT}

    def make(pk):
        src = (pk.Pipeline.from_source(records=[]).key_by()
               .window(pk.Windowing.sliding(20.0, 5.0)))
        red = (src.reduce("sum") if program == "aggregate"
               else src.reduce("min", mode="group", capacity=64))
        return _build(pk, red.sink("xc/"), num_buckets=8, n_workers=W,
                      checkpoint_interval=2, job_id="xc",
                      allowed_lateness=1.0, batch_records=100)

    ref_store = PORT.Store()
    make(PORT).run(PORT.Source.from_records(events, batch_records=100),
                   store=ref_store, options=_opts(PORT), mode="streaming")
    ref = make(PORT).collect_outputs(ref_store)
    assert ref
    a, b = pks[first], pks[then]
    store, meta = a.Store(), a.Meta()
    dead = crashing(a.Coordinator)(store, meta, program=make(a),
                                   options=_opts(a), crash_batch=3)
    with pytest.raises(Boom):
        dead.run_stream(a.Source.from_records(events, batch_records=100),
                        announce=False, flush=False)
    moved = b.Store()
    for obj in store.list_objects(""):
        moved.put(obj.key, store.get(obj.key))
    report = make(b).run(b.Source.from_records(events, batch_records=100),
                         store=moved, meta=_json_meta(meta, b.Meta),
                         options=_opts(b), mode="streaming")
    assert report.error is None
    assert make(b).collect_outputs(moved) == ref


# ---------------------------------------------------------------------------
# Divisibility errors
# ---------------------------------------------------------------------------

def _message(fn, errors):
    with pytest.raises(errors) as info:
        fn()
    return str(info.value)


def _indivisible(P, Wn, shape):
    """A pipeline whose aggregate stage (or join) has a ``num_buckets``
    that 4 workers do not divide, and its build options."""
    chain = (P.from_source(records=[(0.0, "a", 1.0)]).key_by()
             .window(Wn.tumbling(10.0)).reduce("sum"))
    if shape == "join":
        return chain.join(chain), dict(num_buckets=(8, 10), n_workers=4)
    return (chain.window(Wn.tumbling(50.0)).reduce("sum", num_buckets=10),
            dict(num_buckets=8, n_workers=4))


@pytest.mark.parametrize("shape", ["stage", "join", "plan"])
def test_vmap_divisibility_errors_match_reference(shape):
    """The reference's divisibility rules, in its words: ``num_buckets %
    n_workers`` per aggregate stage and on a join's larger side, and
    ``(n_slots * carry_buckets) % n_workers`` on a plan.  The fused fold
    has no worker axis and builds the same pipelines."""
    errors = (ValueError, JPipelineError, PipelineError)
    if shape == "plan":
        def compile_with(mod, **kw):
            return lambda: mod.ExecutionPlan(
                mod.KeySpace.dense(5), mod.ReduceSpec(), 4,
                mod.WindowSpec(10.0, None, 3)).compile(backend="vmap", **kw)
        want = _message(compile_with(jplan), errors)
        got = _message(compile_with(pplan, device="cpu"), errors)
    else:
        jp, kw = _indivisible(JPipeline, JWindowing, shape)
        pp, _ = _indivisible(Pipeline, Windowing, shape)
        want = _message(lambda: jp.build(backend="vmap", **kw), errors)
        got = _message(lambda: pp.build(backend="vmap", device="cpu", **kw),
                       errors)
        assert pp.build(device="cpu", **kw).backend == "fused"
    assert got == want
    assert "divide by n_workers" in got
