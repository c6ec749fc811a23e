"""The port's stage DAG against the reference: multi-stage chains, tee
fan-out (nested too) and both handoff transports.

The same seeded events go through ``repro`` (JAX on the CPU: its default
``backend="vmap"``, or ``"pallas"`` in interpret mode where the reference
test uses it or a checkpoint crosses the packages) and ``repro_torch``
(``device="cpu"``: the fused fold's plain PyTorch version), and every
terminal sink's objects must be equal byte for byte.  Every value folded
is an integer, so float32 sums are exact in any order and no tolerance is
needed: the stages hand over counts and integer sums, and a mean is only
ever formed at emission, from one float32 sum and count, the same in both
packages.

Ported from ``tests/test_dag_fanout.py`` (every case but the shard_map
one), the multi-stage cases of ``tests/test_pipeline_api.py``, the tee'd
cases of ``tests/test_async_runtime.py`` and ``tests/test_pallas_backend.py``
and the PL004 / tee PL005 cases of ``tests/test_analysis_planlint.py``;
plus the handoff's rows against the reference's, a device edge that
reads nothing back to the host, and multi-stage checkpoints that restore
across the packages.
"""

import dataclasses
import json
import warnings
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                 # hermetic container
    from _hypothesis_compat import given, settings, strategies as st

import jax.numpy as jnp

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from _torch_pkgs import (JAX, PALLAS, PORT, W, Boom, CountingStore,
                         crashing, decoded, error_message, events, json_meta,
                         region, streamed)
from repro.analysis.diagnostics import PlanLintWarning as JPlanLintWarning
from repro.engine.plan import ExecutionPlan as JExecutionPlan
from repro.engine.plan import KeySpace as JKeySpace
from repro.engine.plan import ReduceSpec as JReduceSpec
from repro.engine.plan import WindowSpec as JWindowSpec
from repro_torch.analysis import PlanLintWarning
from repro_torch.engine import stages
from repro_torch.engine.plan import ExecutionPlan, KeySpace, ReduceSpec, \
    WindowSpec
from repro_torch.kernels.fused_fold import ops
from repro_torch.pipeline import PipelineError
from repro_torch.streaming import StreamingCoordinator

_PROPERTY_SETTINGS = settings(max_examples=5, deadline=None)


def _tee_pipeline(pk, evs, *, batch_records=150, top="fan-top/",
                  roll="fan-region/"):
    """The acceptance graph: per-key counts per 10 s, teed into a top-k
    branch (identity boundary → device edge) and a per-region rollup
    branch (host transform → host edge)."""
    P, Wn = pk.Pipeline, pk.Windowing
    base = (P.from_source(records=evs, batch_records=batch_records)
            .key_by().window(Wn.tumbling(10.0)).reduce("count"))
    return base.tee(
        P.branch().window(Wn.tumbling(50.0)).reduce("sum").top_k(3)
        .sink(top),
        P.branch().map(region).key_by().window(Wn.tumbling(50.0))
        .reduce("sum").sink(roll))


def _both(make, build, *, jax=JAX, batch=True):
    """``make(pk)`` built in both packages and streamed; the port's
    streaming and batch sinks must equal the reference's streamed sinks
    byte for byte.  Returns ``(reference sinks, port program)``."""
    ref = streamed(jax, make(jax).build(**build, **jax.build))
    assert ref
    built = make(PORT).build(**build, **PORT.build)
    assert streamed(PORT, built) == ref
    if batch:
        batched, report = built.run_batch(PORT.Store())
        assert batched == ref and report.error is None
    return ref, built


# ---------------------------------------------------------------------------
# Tee: parity, per-edge transports, oracles
# ---------------------------------------------------------------------------

def test_tee_two_branch_parity_and_oracle():
    """A tee'd two-branch pipeline (shared upstream reduce → top-k branch +
    rollup branch): the port's batch and streaming sinks equal the
    reference's on both sinks, and each branch matches a host oracle."""
    evs = events(n=2000, seed=31)
    ref, built = _both(lambda pk: _tee_pipeline(pk, evs),
                       dict(num_buckets=12, n_workers=W, job_id="fan"))
    assert len(built.stages) == 3 and built.final_stages == (1, 2)
    _, report = built.run_batch(PORT.Store())
    assert report.handoffs > 0
    assert {k.split("/", 1)[0] for k in ref} == {"fan-top", "fan-region"}
    counts = defaultdict(Counter)
    for ts, k, _v in evs:
        counts[int(ts // 50.0)][k] += 1
    got = decoded(ref)
    for widx, per_key in counts.items():
        name = f"window-{widx * 50.0:.3f}-{(widx + 1) * 50.0:.3f}"
        top = got[name + "@fan-top"]
        assert [v for _k, v in top] == sorted(per_key.values(),
                                              reverse=True)[:3]
        for key, v in top:
            assert per_key[key] == v
        want = Counter()
        for k, c in per_key.items():
            want["even" if int(k[1:]) % 2 == 0 else "odd"] += c
        assert dict(got[name + "@fan-region"]) == dict(want)


def test_tee_edges_pick_their_own_transport():
    """Sibling edges choose transports independently, as the reference's
    do; forcing every edge onto the host gives the same bytes."""
    evs = events(n=1200, seed=32)
    kw = dict(num_buckets=12, n_workers=W, job_id="fan-t")
    dev = _tee_pipeline(PORT, evs).build(**kw, **PORT.build)
    jdev = _tee_pipeline(JAX, evs).build(**kw)
    assert [dataclasses.astuple(e) for e in dev.edges] == \
        [dataclasses.astuple(e) for e in jdev.edges]
    transports = {(e.dst_side, e.dst): (e.device, e.eager) for e in dev.edges}
    assert transports[(0, 1)] == (True, True)       # identity → device, eager
    assert transports[(0, 2)] == (False, False)     # mapped → host
    assert not dev.stages[0].handoff_device         # mixed edges: stage view
    host = _tee_pipeline(PORT, evs).build(handoff="host", **kw, **PORT.build)
    assert not any(e.device for e in host.edges)
    out_dev, _ = dev.run_batch(PORT.Store())
    out_host, _ = host.run_batch(PORT.Store())
    ref, _ = jdev.run_batch(JAX.Store())
    assert out_dev and out_dev == out_host == ref


def test_tee_hashed_key_space_falls_back_to_host_edges():
    """Hashed key domains take the host record path on every edge, with
    the reference's collision-merged labels, in both modes."""
    evs = events(n=800, seed=35)

    def make(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        base = (P.from_source(records=evs, batch_records=150)
                .key_by().window(Wn.tumbling(10.0)).reduce("count"))
        return base.tee(
            P.branch().window(Wn.tumbling(50.0)).reduce("sum").top_k(3)
            .sink("fanh-top/"),
            P.branch().window(Wn.tumbling(100.0)).reduce("sum")
            .sink("fanh-roll/"))

    _, built = _both(make, dict(num_buckets=16, n_workers=W,
                                key_space="hashed", job_id="fan-h"))
    assert not any(e.device for e in built.edges)


def test_nested_tee_three_sinks():
    """A branch may tee again: three distinct sinks, equal to the
    reference's in both modes."""
    evs = events(n=1000, seed=33)

    def make(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        base = (P.from_source(records=evs, batch_records=200)
                .key_by().window(Wn.tumbling(10.0)).reduce("count"))
        inner = (P.branch().window(Wn.tumbling(40.0)).reduce("sum")
                 .tee(P.branch().window(Wn.tumbling(200.0)).reduce("sum")
                      .sink("nest-a/"),
                      P.branch().window(Wn.tumbling(200.0)).reduce("mean")
                      .sink("nest-b/")))
        return base.tee(inner, P.branch().window(Wn.tumbling(40.0))
                        .reduce("sum").top_k(2).sink("nest-c/"))

    ref, built = _both(make, dict(num_buckets=8, n_workers=W,
                                  job_id="nest"))
    assert len(built.stages) == 5 and len(built.final_stages) == 3
    assert {k.split("/", 1)[0] for k in ref} == {"nest-a", "nest-b",
                                                 "nest-c"}


@pytest.mark.parametrize("jax", [JAX, PALLAS], ids=["vmap", "pallas"])
def test_top_k_and_tee_branches_overlapped(jax):
    """The reference's tee'd DAG (``tests/test_pallas_backend.py``) under
    the overlapped scheduler: the port equals both of the reference's
    backends on every branch."""
    evs = events(n=1200, seed=17)
    kw = dict(num_buckets=12, n_workers=W, job_id="pal-tee")
    ref = streamed(jax, _tee_pipeline(jax, evs, top="pal-top/",
                                      roll="pal-region/")
                   .build(**kw, **jax.build), options=JAX.RunOptions())
    got = streamed(PORT, _tee_pipeline(PORT, evs, top="pal-top/",
                                       roll="pal-region/")
                   .build(**kw, **PORT.build),
                   options=PORT.RunOptions(overlap=True))
    assert ref and got == ref
    assert {k.split("/", 1)[0] for k in ref} == {"pal-top", "pal-region"}


# ---------------------------------------------------------------------------
# Multi-stage chains (tests/test_pipeline_api.py)
# ---------------------------------------------------------------------------

def test_multistage_graph_bit_identical_both_modes():
    """map → key_by → window → reduce → map → key_by → window → reduce:
    the inter-stage map forces the host edge; both modes equal the
    reference and a two-phase host oracle."""
    evs = events(n=2500, n_keys=6, span=200.0, seed=20, vmax=20)

    def make(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        return (P.from_source(records=evs, batch_records=200)
                .map(lambda r: (r[0], r[1], 1.0)).key_by()
                .window(Wn.tumbling(10.0)).reduce("count")
                .map(lambda r: (r[0], r[1].upper(), r[2])).key_by()
                .window(Wn.tumbling(50.0)).reduce("sum")
                .sink("two-phase/"))

    ref, built = _both(make, dict(num_buckets=12, n_workers=W,
                                  job_id="ms-accept"))
    assert built.is_multistage and len(built.stages) == 2
    assert not built.stages[0].handoff_device
    c1 = defaultdict(Counter)
    for ts, k, _v in evs:
        c1[int(ts // 10.0)][k] += 1
    c2 = defaultdict(Counter)
    for idx, counts in c1.items():
        for k, c in counts.items():
            c2[int((idx * 10.0) // 50.0)][k] += c
    got = {k.split("@")[0]: v for k, v in decoded(ref).items()}
    assert len(got) == len(c2)
    for widx, counts in c2.items():
        win = got[f"window-{widx * 50.0:.3f}-{(widx + 1) * 50.0:.3f}"]
        assert dict(win) == {k.upper(): v for k, v in counts.items()}


def test_multistage_handoff_transport_agrees_on_topk_ties():
    """Both transports assign the same downstream ids (eager registration
    in first-seen order), so a final top_k breaks ties the same way: 'z'
    arrives before 'a' with equal mass and wins, as in the reference."""
    evs = [(float(i), k, 1.0) for i in range(8) for k in ("z", "a")]

    def make(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        return (P.from_source(records=evs, batch_records=4)
                .key_by().window(Wn.tumbling(2.0)).reduce("count")
                .window(Wn.tumbling(8.0)).reduce("sum").top_k(1))

    outs = {}
    for handoff in ("device", "host"):
        kw = dict(num_buckets=8, n_workers=W, job_id="tie", handoff=handoff)
        outs[handoff], _ = make(PORT).build(**kw, **PORT.build).run_batch(
            PORT.Store())
        ref, _ = make(JAX).build(**kw).run_batch(JAX.Store())
        assert outs[handoff] == ref
    assert outs["device"] == outs["host"]
    for rows in decoded(outs["device"]).values():
        assert rows == [["z", 8.0]]


def test_multistage_device_handoff_equals_host_handoff():
    """An identity boundary lowers to the device edge; ``handoff='host'``
    gives the same bytes, in both modes, equal to the reference."""
    evs = events(n=2000, n_keys=8, span=160.0, seed=21, vmax=20)

    def make(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        return (P.from_source(records=evs, batch_records=250)
                .key_by().window(Wn.tumbling(8.0)).reduce("count")
                .window(Wn.tumbling(40.0)).reduce("sum").top_k(3))

    kw = dict(num_buckets=16, n_workers=W, job_id="msh")
    ref, dev = _both(make, kw)
    host = make(PORT).build(handoff="host", **kw, **PORT.build)
    assert dev.stages[0].handoff_device and not host.stages[0].handoff_device
    out_host, _ = host.run_batch(PORT.Store())
    assert out_host == ref


def test_multistage_streaming_parity_with_sliding_second_stage():
    """A sliding second stage: each finalized first-stage window fans into
    three second-stage windows on the device; equal to the reference and
    conserving 3 × the record count."""
    evs = events(n=3000, n_keys=5, span=300.0, seed=22, vmax=20)

    def make(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        return (P.from_source(records=evs, batch_records=150)
                .key_by().window(Wn.tumbling(10.0)).reduce("count")
                .window(Wn.sliding(60.0, 20.0)).reduce("sum"))

    ref, built = _both(make, dict(num_buckets=20, n_workers=W,
                                  job_id="ms-slide"))
    assert built.stages[0].handoff_device
    total = sum(v for rows in decoded(ref).values() for _k, v in rows)
    assert total == 3 * len(evs)


@pytest.mark.parametrize("handoff", ["device", "host"])
def test_multistage_crash_restore_no_duplicate_or_lost_windows(handoff):
    """A mid-stream crash + restore of a two-stage graph in the port: the
    resumed run equals the reference's uninterrupted run byte for byte,
    every window object written exactly once."""
    evs = events(n=2000, n_keys=5, span=400.0, seed=23, vmax=20)

    def build(pk):
        return (pk.Pipeline.from_source(records=evs, batch_records=100)
                .key_by().window(pk.Windowing.tumbling(10.0))
                .reduce("count").window(pk.Windowing.tumbling(50.0))
                .reduce("sum")
                .build(num_buckets=12, n_workers=W, checkpoint_interval=4,
                       job_id="ms-res", handoff=handoff, **pk.build))

    ref = streamed(JAX, build(JAX))
    store, meta = CountingStore(), PORT.Meta()
    build(PORT).run(PORT.Source.from_records(evs[:1100], batch_records=100),
                    store=store, meta=meta, flush=False, mode="streaming")
    assert set(store.put_counts) & set(ref)         # windows landed pre-crash
    report = build(PORT).run(store=store, meta=meta, mode="streaming")
    assert report.error is None
    assert build(PORT).collect_outputs(store) == ref
    for key in ref:
        assert store.put_counts[key] == 1, (handoff, key)


def test_multistage_validation():
    """The reference's multi-stage grammar errors, word for word: an
    intermediate session stage, a chain continuing past a join, an
    unfinished trailing stage; a join over a multi-stage left side
    lowers."""
    one = [(0.0, "a", 1.0)]

    def cases(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        base = (P.from_source(records=one).key_by().window(10.0)
                .reduce("count"))
        right = P.from_source(records=one).window(10.0).reduce("sum")
        return [
            lambda: (P.from_source(records=one).key_by()
                     .window(Wn.session(5.0)).reduce("sum").window(10.0)
                     .reduce("sum")).build(num_buckets=8, n_workers=W,
                                           **pk.build),
            lambda: (base.window(10.0).reduce("sum").join(right)
                     .window(10.0).reduce("sum")).build(
                num_buckets=8, n_workers=W, **pk.build),
            lambda: base.key_by().build(num_buckets=8, n_workers=W,
                                        **pk.build),
        ]

    for want, got, match in zip(map(error_message, cases(JAX)),
                                map(error_message, cases(PORT)),
                                ("session", "past a join", "stage 2")):
        assert want is not None and got == want and match in got
    built = (PORT.Pipeline.from_source(records=one).key_by().window(10.0)
             .reduce("count").window(10.0).reduce("sum")
             .join(PORT.Pipeline.from_source(records=one).window(10.0)
                   .reduce("sum"))).build(num_buckets=8, n_workers=W,
                                          **PORT.build)
    assert len(built.stages) == 2 and built.stages[1].is_join
    assert built.edges and built.edges[0].dst_side == 0


# ---------------------------------------------------------------------------
# Crash / restore across the fan-out (tests/test_dag_fanout.py)
# ---------------------------------------------------------------------------

def test_tee_crash_restore_no_lost_or_duplicate_windows():
    """A mid-stream crash + restore of the tee'd graph in the port equals
    the reference's uninterrupted run on both branches, each window
    object written exactly once."""
    evs = events(n=1600, n_keys=5, span=320.0, seed=34)

    def build(pk):
        return _tee_pipeline(pk, evs, batch_records=100).build(
            num_buckets=12, n_workers=W, checkpoint_interval=4,
            job_id="fan-res", **pk.build)

    ref = streamed(JAX, build(JAX))
    store, meta = CountingStore(), PORT.Meta()
    build(PORT).run(PORT.Source.from_records(evs[:900], batch_records=100),
                    store=store, meta=meta, flush=False, mode="streaming")
    assert set(store.put_counts) & set(ref)
    report = build(PORT).run(store=store, meta=meta, mode="streaming")
    assert report.error is None
    assert build(PORT).collect_outputs(store) == ref
    for key in ref:
        assert store.put_counts[key] == 1, key


def _drive(pk, built, evs, crash_at=None):
    """Run ``built`` over ``evs``; with ``crash_at``, crash after that many
    records and resume a fresh coordinator over the same store + meta."""
    store, meta = pk.Store(), pk.Meta()
    if crash_at is not None:
        dead = pk.Coordinator(store, meta, program=built)
        dead.run_stream(pk.Source.from_records(evs[:crash_at],
                                               batch_records=64),
                        announce=False, flush=False)
    coord = pk.Coordinator(store, meta, program=built)
    coord.run_stream(pk.Source.from_records(evs, batch_records=64),
                     announce=False, flush=True)
    return coord, built.collect_outputs(store)


_PROGRAMS = {}


def _property_program(pk):
    """One tee'd program per package, reused across property examples."""
    if pk.name not in _PROGRAMS:
        _PROGRAMS[pk.name] = _tee_pipeline(pk, [], batch_records=64).build(
            num_buckets=16, n_workers=W, checkpoint_interval=3,
            job_id="fan-pt", **pk.build)
    return _PROGRAMS[pk.name]


@_PROPERTY_SETTINGS
@given(st.integers(0, 2 ** 31 - 1), st.floats(0.05, 0.95),
       st.integers(2, 12))
def test_edge_key_tables_rebuild_bit_identically_after_restore(
        seed, crash_frac, n_keys):
    """Property: for any stream and crash point, a port restore rebuilds
    every key dictionary and every edge's relabel table bit-identically
    to an uninterrupted port run and to the reference's, and the windows
    match the reference's byte for byte."""
    evs = events(n=700, n_keys=n_keys, span=280.0, seed=seed % 10_000)
    crash_at = max(64, int(len(evs) * crash_frac))
    ref, out_ref = _drive(JAX, _property_program(JAX), evs)
    plain, out_plain = _drive(PORT, _property_program(PORT), evs)
    crashed, out_crashed = _drive(PORT, _property_program(PORT), evs,
                                  crash_at=crash_at)
    assert out_ref and out_plain == out_ref and out_crashed == out_ref
    for st_r, st_a, st_b in zip(ref.stages, plain.stages, crashed.stages):
        dicts = [[t.state_dict() for t in s.tables]
                 for s in (st_r, st_a, st_b)]
        assert dicts[0] == dicts[1] == dicts[2]
    assert len(plain.edges) == len(crashed.edges) == 2
    for e_r, e_a, e_b in zip(ref.edges, plain.edges, crashed.edges):
        assert (e_r.relabel is None) == (e_a.relabel is None) \
            == (e_b.relabel is None)
        if e_a.relabel is not None:
            assert np.array_equal(e_a.relabel, e_r.relabel)
            assert np.array_equal(e_b.relabel, e_r.relabel)


# ---------------------------------------------------------------------------
# Stage-local build options
# ---------------------------------------------------------------------------

def test_per_stage_build_options_resolved_per_stageplan():
    """``reduce(..., num_buckets=, n_slots=)`` sizes that stage only; the
    bytes equal the reference's and the all-default build's."""
    evs = events(n=1000, seed=51)

    def make(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        return (P.from_source(records=evs, batch_records=200)
                .key_by().window(Wn.tumbling(10.0))
                .reduce("count", num_buckets=32, n_slots=12)
                .window(Wn.tumbling(40.0))
                .reduce("sum", num_buckets=8, n_slots=4))

    kw = dict(num_buckets=16, n_workers=W, n_slots=8, job_id="opts")
    ref, built = _both(make, kw)
    assert [s.num_buckets for s in built.stages] == [32, 8]
    assert [s.n_slots for s in built.stages] == [12, 4]
    assert built.stages[0].handoff_device
    default = (PORT.Pipeline.from_source(records=evs, batch_records=200)
               .key_by().window(PORT.Windowing.tumbling(10.0))
               .reduce("count").window(PORT.Windowing.tumbling(40.0))
               .reduce("sum")).build(**kw, **PORT.build)
    base_out, _ = default.run_batch(PORT.Store())
    assert sorted(base_out.values()) == sorted(ref.values())


def test_per_stage_options_validated_at_lower_time():
    """Stage-local options are validated per stage with the reference's
    words.  (The reference's ``num_buckets`` divisibility by
    ``n_workers`` has no counterpart: the port's flat fold has no worker
    axis.)"""
    one = [(0.0, "a", 1.0)]

    def cases(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        base = P.from_source(records=one).key_by()
        right = P.from_source(records=one).window(10.0).reduce("sum")
        return [
            lambda: (base.window(Wn.sliding(40.0, 10.0))
                     .reduce("sum", n_slots=3)).build(
                num_buckets=16, n_workers=W, **pk.build),
            lambda: (base.window(10.0).reduce("sum", n_slots=1)).build(
                num_buckets=16, n_workers=W, **pk.build),
            lambda: (base.window(10.0).reduce("sum", num_buckets=8)
                     .join(right)).build(num_buckets=16, n_workers=W,
                                         **pk.build),
        ]

    for want, got, match in zip(map(error_message, cases(JAX)),
                                map(error_message, cases(PORT)),
                                ("cannot hold the window span",
                                 "window slots", "join's final stage")):
        assert want is not None and got == want and match in got
    with pytest.raises(PipelineError, match="build-wide options"):
        (PORT.Pipeline.from_source(shards=np.zeros((W, 4, 3), np.float32))
         .map(lambda s: (s[:, 0], s[:, 1], s[:, 2] > 0))
         .reduce("sum", num_buckets=4)).build(num_buckets=16, n_workers=W,
                                              **PORT.build)


# ---------------------------------------------------------------------------
# Graph validation
# ---------------------------------------------------------------------------

def test_tee_validation():
    """Every tee grammar error of the reference, word for word."""
    one = [(0.0, "a", 1.0)]

    def cases(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        base = (P.from_source(records=one).key_by().window(10.0)
                .reduce("count"))
        kw = dict(num_buckets=8, n_workers=W, **pk.build)

        def leaf(sink):
            return P.branch().window(100.0).reduce("sum").sink(sink)
        right = P.from_source(records=one).window(10.0).reduce("sum")
        return [
            (lambda: base.tee(leaf("a/")), "at least two branches"),
            (lambda: base.tee(leaf("a/"), P.from_source(records=one)
                              .window(100.0).reduce("sum")),
             "rooted at Pipeline.branch"),
            (lambda: base.tee(leaf("a/"), leaf("b/")).sink("c/")
             .build(**kw), "terminal node"),
            (lambda: base.tee(leaf("a/"), P.branch().window(100.0)
                              .reduce("sum")).build(**kw), "its own .sink"),
            (lambda: base.tee(leaf("a/"), leaf("a/")).build(**kw),
             "distinct prefixes"),
            (lambda: base.tee(leaf("a"), leaf("a/")).build(**kw),
             "distinct prefixes"),
            (lambda: (P.from_source(records=one).key_by().window(10.0)
                      .tee(leaf("a/"), leaf("b/"))).build(**kw),
             "fans out a *reduced"),
            (lambda: base.tee(leaf("a/"), P.branch()
                              .window(Wn.session(5.0)).reduce("sum")
                              .sink("s/")).build(**kw), "session"),
            (lambda: (P.from_source(records=one).key_by().window(10.0)
                      .reduce("sum").join(right)
                      .tee(leaf("a/"), leaf("b/"))).build(**kw),
             "tee and join"),
        ]

    for (want, _), (got, match) in zip(cases(JAX), cases(PORT)):
        assert error_message(want) is not None
        assert error_message(got) == error_message(want)
        assert match in error_message(got)


# ---------------------------------------------------------------------------
# The pipelined runtime over a tee (tests/test_async_runtime.py)
# ---------------------------------------------------------------------------

def _chain(pk, evs, *, batch_records=100, job_id="async-chain"):
    return (pk.Pipeline.from_source(records=evs, batch_records=batch_records)
            .key_by().window(10.0).reduce("sum").sink("async-out/")
            .build(num_buckets=8, n_workers=W, job_id=job_id, **pk.build))


def _stream(pk, built, store, options, *, evs=None, batch_records=100,
            meta=None, flush=True):
    src = (pk.Source.from_records(evs, batch_records=batch_records)
           if evs is not None else None)
    return built.run(src, store=store, meta=meta, options=options,
                     mode="streaming", flush=flush)


def test_overlap_matches_sync_byte_identical_on_all_branches():
    """The overlapped scheduler equals the synchronous drive on both tee
    branches, and both equal the reference's; the drain lane records a
    close-to-emit latency for every window."""
    evs = events(n=2000, seed=41)

    def make(pk):
        return _tee_pipeline(pk, evs, top="async-top/",
                             roll="async-region/").build(
            num_buckets=12, n_workers=W, job_id="async-tee", **pk.build)

    ref = streamed(JAX, make(JAX), options=JAX.RunOptions(**JAX.sync))
    built = make(PORT)
    sync_store, async_store = PORT.Store(), PORT.Store()
    _stream(PORT, built, sync_store, PORT.RunOptions(**PORT.sync))
    report = _stream(PORT, built, async_store, PORT.RunOptions(overlap=True))
    assert built.collect_outputs(sync_store) == ref
    assert built.collect_outputs(async_store) == ref
    assert len(report.emit_latencies) == report.windows_emitted > 0
    assert report.p99_emit_latency >= report.p50_emit_latency >= 0.0


@pytest.mark.parametrize("knob", ["overlap", "sink_batching"])
def test_each_lane_alone_is_byte_identical(knob):
    """Each of the port's scheduler knobs alone changes no byte (the
    reference's third knob, carry donation, has no counterpart: the port
    folds in place)."""
    evs = events(n=800, seed=43)
    ref_store = JAX.Store()
    jbuilt = _chain(JAX, evs, job_id=f"async-{knob}")
    _stream(JAX, jbuilt, ref_store, JAX.RunOptions(**JAX.sync))
    ref = jbuilt.collect_outputs(ref_store)
    built = _chain(PORT, evs, job_id=f"async-{knob}")
    got_store = PORT.Store()
    _stream(PORT, built, got_store,
            PORT.RunOptions(**{**PORT.sync, knob: True}))
    assert ref and built.collect_outputs(got_store) == ref


def _check_crash_restore(overlap: bool, seed: int, crash_batch: int):
    """Crash while batch N folds (batch N+1 prepared in the prefetch
    queue); a fresh port coordinator restores and converges to the
    reference's uninterrupted run on every tee branch, each window object
    written exactly once."""
    evs = events(n=1000, n_keys=5, span=200.0, seed=seed)

    def build(pk):
        return _tee_pipeline(pk, evs, batch_records=100, top="async-top/",
                             roll="async-region/").build(
            num_buckets=12, n_workers=W, checkpoint_interval=2,
            job_id="async-crash", **pk.build)

    ref = streamed(JAX, build(JAX), options=JAX.RunOptions(**JAX.sync))
    opts = (PORT.RunOptions(prefetch_batches=2) if overlap
            else PORT.RunOptions(**PORT.sync))
    store, meta = CountingStore(), PORT.Meta()
    dead = crashing(StreamingCoordinator)(store, meta, program=build(PORT),
                                          options=opts,
                                          crash_batch=crash_batch)
    with pytest.raises(Boom):
        dead.run_stream(PORT.Source.from_records(evs, batch_records=100),
                        announce=False, flush=False)
    report = _stream(PORT, build(PORT), store, opts, evs=evs, meta=meta)
    assert report.error is None
    assert build(PORT).collect_outputs(store) == ref
    for key in ref:
        assert store.put_counts[key] == 1, key


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 8))
def test_mid_prefetch_crash_restores_exactly_once(seed, crash_batch):
    _check_crash_restore(True, seed, crash_batch)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 8))
def test_mid_stream_crash_restores_exactly_once_sync(seed, crash_batch):
    _check_crash_restore(False, seed, crash_batch)


def test_sink_batching_one_round_trip_per_sweep_same_bytes():
    """With sink batching on, every window of one finalization sweep lands
    through one ``put_many``; the bytes equal the reference's."""
    evs = events(n=1200, n_keys=8, span=300.0, seed=47)
    jbuilt = _chain(JAX, evs, batch_records=600, job_id="async-sink")
    plain = JAX.Store()
    _stream(JAX, jbuilt, plain, JAX.RunOptions(**JAX.sync),
            batch_records=600)
    ref = jbuilt.collect_outputs(plain)
    built = _chain(PORT, evs, batch_records=600, job_id="async-sink")
    counting = CountingStore()
    _stream(PORT, built, counting, PORT.RunOptions(overlap=False),
            batch_records=600)
    assert ref and built.collect_outputs(counting) == ref
    window_keys = [k for k in counting.put_counts if k in ref]
    assert sum(counting.put_many_calls) == len(window_keys)
    assert max(counting.put_many_calls) >= 2
    for key in ref:
        assert counting.put_counts[key] == 1


def test_checkpoint_never_passes_staged_writes():
    """A checkpoint with staged-but-unwritten sink bytes (or undrained
    stats) is refused, on a tee'd program too."""
    evs = events(n=300, seed=49)
    for built in (_chain(PORT, evs, job_id="async-barrier"),
                  _tee_pipeline(PORT, evs).build(num_buckets=12,
                                                 n_workers=W,
                                                 **PORT.build)):
        coord = StreamingCoordinator(PORT.Store(), PORT.Meta(),
                                     program=built,
                                     options=PORT.RunOptions())
        coord._pending_puts.append(("k", b"x", 0.0, 1.0, 1, 0.0))
        with pytest.raises(RuntimeError, match="undrained lane"):
            coord.save_state()


def test_checkpoint_interval_override_reaches_coordinator():
    """``RunOptions.checkpoint_interval`` overrides the program's spacing
    for one run; ``checkpointed_offset`` reads it back, as the reference's
    does."""
    evs = events(n=500, seed=59)
    offsets = {}
    for pk in (JAX, PORT):
        built = _chain(pk, evs, job_id="async-ckpt")
        store, meta = pk.Store(), pk.Meta()
        _stream(pk, built, store, pk.RunOptions(checkpoint_interval=0),
                evs=evs, meta=meta, flush=False)
        first = pk.Coordinator(store, meta,
                               program=built).checkpointed_offset()
        _stream(pk, built, store, pk.RunOptions(checkpoint_interval=2),
                evs=evs, meta=meta, flush=False)
        coord = pk.Coordinator(store, meta, program=built)
        offsets[pk.name] = (first, coord.checkpointed_offset())
    assert offsets["port"] == offsets["jax"] == (0, 400)


def test_pool_stats_count_every_stage_fold():
    """``pool_stats`` reports the fold pool: one invocation per fold step
    of every stage of the tee'd DAG (handoffs included), as many as the
    reference's pool makes, and ``report.folds`` agrees."""
    evs = events(n=1200, seed=32)
    invocations = {}
    for pk in (JAX, PORT):
        coord = pk.Coordinator(pk.Store(), pk.Meta(),
                               program=_tee_pipeline(pk, evs).build(
                                   num_buckets=12, n_workers=W,
                                   job_id="pool", **pk.build))
        report = coord.run_stream(pk.Source.from_records(
            evs, batch_records=150), announce=False)
        invocations[pk.name] = coord.pool_stats()["invocations"]
        if pk is PORT:
            assert report.folds == invocations["port"] > report.batches
    assert invocations["port"] == invocations["jax"]


# ---------------------------------------------------------------------------
# The carry handoff itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["count", "sum", "mean"])
def test_handoff_rows_match_reference(kind):
    """``handoff_rows`` (the port's flat ``(dst_rows, 5)`` layout, the
    reference's pallas/shard_map one) against the reference's on the same
    carry: relabelled keys (unassigned ``-1``), re-windowed span, the
    ``kind`` value and invalid padding — bit for bit; then the rows fold
    into a successor carry equally."""
    rng = np.random.default_rng(61)
    nb, n_slots, dst_rows = 16, 6, 40
    carry = np.zeros((n_slots * nb, 2), np.float32)
    hit = rng.random(n_slots * nb) > 0.4
    carry[hit, 0] = rng.integers(0, 50, hit.sum())
    carry[hit, 1] = rng.integers(1, 7, hit.sum())
    relabel = rng.integers(-1, 12, nb).astype(np.int32)
    jplan = JExecutionPlan(JKeySpace.dense(nb), JReduceSpec(), W,
                           JWindowSpec(10.0, None, n_slots)).compile(
        backend="pallas")
    plan = ExecutionPlan(KeySpace.dense(nb), ReduceSpec(), W,
                         WindowSpec(10.0, None, n_slots)).compile(
        device="cpu")
    want = np.asarray(jplan.handoff_rows(jnp.asarray(carry), 3,
                                         jnp.asarray(relabel), 7, 2, kind,
                                         dst_rows))
    got = plan.handoff_rows(torch.from_numpy(carry), 3,
                            torch.from_numpy(relabel), 7, 2, kind, dst_rows)
    assert got.shape == (dst_rows, 5) and np.array_equal(got.numpy(), want)
    assert not got[nb:].any()                       # invalid padding
    dst = JExecutionPlan(JKeySpace.dense(12), JReduceSpec(), W,
                         JWindowSpec(30.0, 10.0, n_slots)).compile(
        backend="pallas")
    pdst = ExecutionPlan(KeySpace.dense(12), ReduceSpec(), W,
                         WindowSpec(30.0, 10.0, n_slots)).compile(
        device="cpu")
    jc, js = dst.step(want, dst.init_carry(), 6)
    pc, ps = pdst.step(got, pdst.init_carry(), 6)
    assert np.array_equal(pc.numpy(), np.asarray(jc))
    assert ps.tolist() == np.asarray(js).tolist()
    with pytest.raises(ValueError, match="n_rows"):
        plan.handoff_rows(torch.from_numpy(carry), 3,
                          torch.from_numpy(relabel), 7, 2, kind, nb - 1)


def test_device_edge_reads_nothing_back():
    """A device edge's handoffs (rows built from the finalized slot, then
    the successor's fold) never bring a tensor back to the host: no
    ``.cpu()``, ``.tolist()``, ``.item()`` or ``.numpy()`` on the edge,
    while the host edge beside it does read its window."""
    evs = events(n=1200, seed=32)
    built = _tee_pipeline(PORT, evs).build(num_buckets=12, n_workers=W,
                                           job_id="edge-sync", **PORT.build)
    reads = Counter()
    edges = Counter()
    orig_dev = StreamingCoordinator._handoff_device
    orig_feed = StreamingCoordinator._feed
    names = ("cpu", "tolist", "item", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def spy(where, orig):
        def wrapped(self, *args, **kwargs):
            edges[where] += 1

            def counting(name):
                def call(t, *a, **k):
                    reads[where, name] += 1
                    return saved[name](t, *a, **k)
                return call
            for n in names:
                setattr(torch.Tensor, n, counting(n))
            try:
                return orig(self, *args, **kwargs)
            finally:
                for n in names:
                    setattr(torch.Tensor, n, saved[n])
        return wrapped

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(StreamingCoordinator, "_handoff_device",
                   spy("device", orig_dev))
        mp.setattr(StreamingCoordinator, "_feed", spy("host", orig_feed))
        out, report = built.run_batch(PORT.Store())
    finally:
        mp.undo()
    assert out and report.handoffs == edges["device"] + edges["host"]
    assert edges["device"] > 0 and edges["host"] > 0
    assert not any(n for (where, _), n in reads.items() if where == "device")
    ref, _ = _tee_pipeline(JAX, evs).build(
        num_buckets=12, n_workers=W, job_id="edge-sync").run_batch(
        JAX.Store())
    assert out == ref


@pytest.mark.cuda
def test_tee_on_the_card_equals_plain_build(cuda_device):
    """On the card: the tee'd DAG (a device edge and a host edge) folds
    every stage through the kernel — one launch a fold step — and its
    sinks equal the ``device="cpu"`` build's byte for byte."""
    evs = events(n=2000, seed=31)
    kw = dict(num_buckets=12, n_workers=W, job_id="fan")
    want, _ = _tee_pipeline(PORT, evs).build(**kw, **PORT.build).run_batch(
        PORT.Store())
    card = _tee_pipeline(PORT, evs).build(**kw, device="cuda")
    assert any(e.device for e in card.edges)
    before = ops.fold.launches
    got, report = card.run_batch(PORT.Store())
    assert report.error is None and report.handoffs > 0
    assert ops.fold.launches - before == report.folds
    assert got == want and want


# ---------------------------------------------------------------------------
# planlint over stage DAGs (tests/test_analysis_planlint.py)
# ---------------------------------------------------------------------------

def _two_stage(pk):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (pk.Pipeline.from_source(batch_records=64).key_by()
                .window(pk.Windowing.tumbling(10.0)).reduce("count")
                .window(pk.Windowing.tumbling(60.0)).reduce("sum")
                .sink("out/")
                .build(num_buckets=8, n_workers=4, batch_records=64,
                       job_id="plt4", **pk.build))


def _findings(diags):
    return [(d.rule_id, d.level, d.message, d.loc) for d in diags]


def _replace_stage(built, si, **changes):
    stages_ = list(built.stages)
    stages_[si] = dataclasses.replace(stages_[si], **changes)
    return dataclasses.replace(built, stages=tuple(stages_))


@pytest.mark.parametrize("case", ["clean", "unfed", "dead_lateness",
                                  "lagging_join"])
def test_pl004_watermark_wiring(case):
    """PL004's findings on the port's DAGs equal the reference's: an
    unfed side (error), lateness on a carry-fed stage (warning), a join
    over upstream windows of different sizes (info), and a clean chain."""
    def program(pk):
        if case == "lagging_join":
            P, Wn = pk.Pipeline, pk.Windowing
            one = [(0.0, "a", 1.0)]
            left = (P.from_source(records=one).key_by().window(5.0)
                    .reduce("count").window(20.0).reduce("sum"))
            right = (P.from_source(records=one).key_by().window(10.0)
                     .reduce("count").window(20.0).reduce("sum"))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                return left.join(right).build(num_buckets=8, n_workers=4,
                                              job_id="plt4j", **pk.build)
        built = _two_stage(pk)
        if case == "unfed":
            return dataclasses.replace(built, inputs=())
        if case == "dead_lateness":
            return _replace_stage(built, 1, allowed_lateness=3.0)
        return built

    want = [f for f in _findings(program(JAX).check()) if f[0] == "PL004"]
    got = [f for f in _findings(program(PORT).check()) if f[0] == "PL004"]
    assert got == want
    assert bool(got) == (case != "clean")
    if case == "clean":
        assert program(PORT).check() == []
    explain = program(PORT).explain()
    assert "edge 0→1 side=0 [device eager]" in explain \
        or case == "lagging_join"
    for f in got:
        assert f[2] in explain


def test_pl005_nested_sinks_across_branches():
    """One branch's sink nested under the other's job prefix: the same
    PL005 finding as the reference's, raised as a build warning."""
    def fan(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        return (P.from_source(batch_records=64).key_by()
                .window(Wn.tumbling(10.0)).reduce("count")
                .tee(P.branch().window(Wn.tumbling(60.0)).reduce("sum")
                     .sink("acc/"),
                     P.branch().window(Wn.tumbling(60.0)).reduce("sum")
                     .sink("acc/plt5/deep/")))

    with pytest.warns(JPlanLintWarning, match="PL005"):
        jbuilt = fan(JAX).build(num_buckets=8, n_workers=4, batch_records=64,
                                job_id="plt5")
    with pytest.warns(PlanLintWarning, match="PL005"):
        built = fan(PORT).build(num_buckets=8, n_workers=4, batch_records=64,
                                job_id="plt5", **PORT.build)
    want = [f for f in _findings(jbuilt.check()) if f[0] == "PL005"]
    got = [f for f in _findings(built.check()) if f[0] == "PL005"]
    assert got == want and got


# ---------------------------------------------------------------------------
# Multi-stage checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,then", [("pallas", "port"),
                                        ("port", "pallas")])
def test_multistage_checkpoint_restores_across_packages(first, then):
    """A tee'd multi-stage job crashes under one package and resumes under
    the other from the checkpoint (the reference's ``backend="pallas"``
    flat carries, every edge's feed watermark, every key table): the sinks
    equal an uncrashed run on both branches, every window written once."""
    evs = events(n=1000, n_keys=5, span=200.0, seed=29)
    pkgs = {"pallas": PALLAS, "port": PORT}

    def build(pk):
        return _tee_pipeline(pk, [], batch_records=100, top="xtop/",
                             roll="xroll/").build(
            num_buckets=12, n_workers=W, checkpoint_interval=2,
            job_id="xms", **pk.build)

    ref = streamed(PORT, build(PORT),
                   source=PORT.Source.from_records(evs, batch_records=100))
    a, b = pkgs[first], pkgs[then]
    store, meta = CountingStore(), a.Meta()
    dead = crashing(a.Coordinator)(store, meta, program=build(a),
                                   crash_batch=5)
    with pytest.raises(Boom):
        dead.run_stream(a.Source.from_records(evs, batch_records=100),
                        announce=False, flush=False)
    state = meta.get("stream/xms/state")
    assert state["offset"] == 400 and len(state["edge_fed"]) == 2
    assert max(state["edge_fed"]) > float("-inf")   # handoffs before the crash
    meta = json_meta(meta, b.Meta)
    report = build(b).run(b.Source.from_records(evs, batch_records=100),
                          store=store, meta=meta, mode="streaming")
    assert report.error is None
    assert build(PORT).collect_outputs(store) == ref
    for key in ref:
        assert store.put_counts[key] == 1, key
