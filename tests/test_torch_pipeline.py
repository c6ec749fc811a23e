"""The port's streaming slice end to end against the reference.

The same programs run through ``repro`` (JAX, ``backend="pallas"``, its
kernel in interpret mode on the CPU) and ``repro_torch`` (``device="cpu"``,
the fold's plain PyTorch version) and must emit byte-identical sink
objects (``collect_outputs``), with the scheduler's overlap on and off:
the program of ``docs/architecture.md``, the fleet and trip pipelines of
``examples/stream_gps.py``, a small ``linear-road-lav``, top-k, hashed
keys and the host fan-out wire.  Then exactly-once crash/restore inside
the port, and across the two packages in both directions through the
shared checkpoint format.
"""

import json
from collections import Counter

import numpy as np
import pytest

from repro.core import MemoryStore as JMemoryStore
from repro.core import MetadataStore as JMetadataStore
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import RunOptions as JRunOptions
from repro.pipeline import Windowing as JWindowing
from repro.streaming import StreamingCoordinator as JCoordinator
from repro.streaming import StreamSource as JStreamSource
from repro.streaming import write_event_log as jwrite_event_log

from repro_torch.core import MemoryStore, MetadataStore
from repro_torch.pipeline import Pipeline, PipelineError, RunOptions, Windowing
from repro_torch.streaming import (StreamingCoordinator, StreamSource,
                                   carries_from_reference, write_event_log)
from repro_torch.workloads import linear_road as lr

#: every scheduler lane off (the reference also stops donating the carry;
#: the port always folds in place)
SYNC = dict(overlap=False, sink_batching=False)

#: (package, pipeline, windowing, run options, store, meta, event-log writer)
JAX = (JPipeline, JWindowing, JRunOptions, JMemoryStore, JMetadataStore,
       jwrite_event_log)
PORT = (Pipeline, Windowing, RunOptions, MemoryStore, MetadataStore,
        write_event_log)


def _events(n=1200, n_keys=6, span=200.0, seed=0, vmax=9, jitter=0.0):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, span, n))
    if jitter:
        ts = np.clip(ts + rng.normal(0, jitter, n), 0, None)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, vmax, n).astype(float)   # ints exact in fp32
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


def _drive(pkg, make, events, *, overlap, build, batch_records=128):
    """Write ``events`` to a log, build ``make(P, Wn)`` with the package's
    backend, stream it, and return the sink objects."""
    P, Wn, RO, Store, Meta, write = pkg
    store = Store()
    write(store, "streams/in", events, segment_records=batch_records)
    extra = {"backend": "pallas"} if pkg is JAX else {"device": "cpu"}
    built = make(P, Wn).build(**build, **extra)
    if overlap:
        opts = RO(overlap=True)
    else:
        opts = RO(**SYNC, **({"donate_carry": False} if pkg is JAX else {}))
    report = built.run(store=store, meta=Meta(), options=opts,
                       mode="streaming")
    assert report.error is None
    return built.collect_outputs(store)


def _parity(make, events, build, **kw):
    ref = _drive(JAX, make, events, overlap=False, build=build, **kw)
    assert ref
    for overlap in (False, True):
        assert _drive(PORT, make, events, overlap=overlap, build=build,
                      **kw) == ref
    return ref


def test_docs_gps_mean_program():
    """docs/architecture.md's minimal program: per-vehicle mean over
    30 s tumbling windows from an event log."""
    events = [(float(t) * 0.5, f"v{t % 3}", float(t % 7)) for t in range(400)]
    _parity(lambda P, Wn: (P.from_source(prefix="streams/in",
                                         batch_records=128)
                           .key_by(lambda r: r[1])
                           .window(Wn.tumbling(30.0)).reduce("mean")
                           .sink("stream-output/")),
            events, dict(num_buckets=8, n_workers=4, job_id="gps-mean"))


def _gps_pings(duration=180.0, rate=40.0, seed=0):
    """examples/stream_gps.py's fleet: (ts, region, speed) with upload
    jitter, so the log is mildly out of event-time order."""
    regions = ["north", "south", "east", "west", "centre", "port", "depot",
               "hub"]
    rng = np.random.default_rng(seed)
    n = int(rate * duration)
    ts = np.clip(np.sort(rng.uniform(0, duration, n))
                 + rng.normal(0, 0.5, n), 0, None)
    return [(float(t), regions[r], float(s)) for t, r, s in
            zip(ts, rng.integers(0, len(regions), n),
                rng.integers(5, 110, n))]


def test_stream_gps_fleet_and_batch_flip():
    """The example's fleet pipeline (mean speed per region per minute,
    lateness 5 s): streaming bytes equal the reference's, and the port's
    own batch flip over the same log equals its streaming run."""
    events = _gps_pings()

    def make(P, Wn):
        return (P.from_source(prefix="streams/in", batch_records=2048)
                .key_by(lambda r: r[1]).window(Wn.tumbling(60.0))
                .reduce("mean").sink("stream-output/"))

    build = dict(num_buckets=8, n_workers=4, allowed_lateness=5.0,
                 job_id="gps-fleet")
    ref = _parity(make, events, build, batch_records=2048)
    store = MemoryStore()
    write_event_log(store, "streams/in", events, segment_records=4096)
    built = make(Pipeline, Windowing).build(device="cpu", **build)
    batch_out, _ = built.run(store=store, mode="batch")
    assert batch_out == ref


def test_stream_gps_trips_sessions():
    """The example's sessionized trips: per-vehicle session windows (30 s
    gap) on the host wire, with cell merges, in batch mode."""
    rng = np.random.default_rng(1)
    trips = []
    for v in range(6):
        t = float(rng.uniform(0, 30.0))
        while t < 900.0:
            for _ in range(int(rng.integers(5, 20))):
                trips.append((t, f"vehicle-{v}", float(rng.integers(5, 110))))
                t += float(rng.uniform(0.5, 8.0))
            t += float(rng.uniform(60.0, 180.0))
    trips.sort()

    def run(P, Wn, **kw):
        p = (P.from_source(records=trips, batch_records=512).key_by()
             .window(Wn.session(gap=30.0)).reduce("mean"))
        out, report = p.build(num_buckets=8, n_workers=4, n_slots=4,
                              job_id="gps-trips", **kw).run(
            store=(JMemoryStore if P is JPipeline else MemoryStore)())
        return out

    ref = run(JPipeline, JWindowing, backend="pallas")
    assert ref and run(Pipeline, Windowing, device="cpu") == ref


def test_linear_road_lav_small():
    """linear-road-lav cut to one expressway (200 segments) and 20 minutes:
    byte-identical to the reference, and equal to the numpy oracle."""
    ts, seg, speed = lr.position_reports(3, n_xways=1, n_vehicles=300,
                                         minutes=20)
    events = lr.records(ts, seg, speed)

    def make(P, Wn):
        return (P.from_source(prefix="streams/in", batch_records=4096)
                .key_by().window(Wn.sliding(lr.WINDOW_SIZE, lr.WINDOW_SLIDE))
                .reduce("mean").sink("lav/"))

    ref = _parity(make, events, dict(job_id="lav", **lr.build_options(1)),
                  batch_records=4096)
    oracle = lr.lav_oracle(ts, seg, speed)
    assert len(ref) == len(oracle)
    for start, means in oracle.items():
        key = f"lav/lav/window-{start:.3f}-{start + lr.WINDOW_SIZE:.3f}"
        assert dict(json.loads(x) for x in ref[key].splitlines()) == means


@pytest.mark.parametrize("variant", ["top_k", "hashed", "host_fanout",
                                     "sliding_count"])
def test_pipeline_variants(variant):
    """Top-k emission, a hashed key space, the host fan-out wire, and a
    sliding count with out-of-order input and lateness."""
    events = _events(n=900, n_keys=12, span=240.0, seed=5, jitter=1.0)
    build = dict(num_buckets=16, n_workers=4, job_id=f"v-{variant}",
                 allowed_lateness=2.0)
    windowing = ("sliding", 20.0, 5.0)
    kind = "sum"
    if variant == "hashed":
        build["key_space"] = "hashed"
    elif variant == "host_fanout":
        build["fanout"] = "host"
    elif variant == "sliding_count":
        kind = "count"

    def make(P, Wn):
        p = (P.from_source(prefix="streams/in", batch_records=128).key_by()
             .window(Wn.sliding(*windowing[1:])).reduce(kind))
        if variant == "top_k":
            p = p.top_k(3, by="mean")
        return p.sink("variants/")

    _parity(make, events, build)


@pytest.mark.parametrize("fanout", ["device", "host"])
@pytest.mark.parametrize("n_workers", [1, 3, 7])
def test_n_workers_does_not_shape_the_fold(fanout, n_workers):
    """The flat fold has no worker axis: any ``n_workers`` (even one that
    does not divide ``num_buckets``, which the reference rejects) gives
    the reference's bytes at a dividing worker count."""
    events = _events(n=700, n_keys=10, span=150.0, seed=9, jitter=0.5)
    build = dict(num_buckets=10, fanout=fanout, allowed_lateness=1.0,
                 job_id="workers")

    def make(P, Wn):
        return (P.from_source(prefix="streams/in", batch_records=96)
                .key_by().window(Wn.sliding(30.0, 10.0)).reduce("sum")
                .sink("workers/"))

    ref = _drive(JAX, make, events, overlap=False,
                 build=dict(build, n_workers=2), batch_records=96)
    assert ref
    assert _drive(PORT, make, events, overlap=True,
                  build=dict(build, n_workers=n_workers),
                  batch_records=96) == ref


def test_unported_pipeline_shapes_raise():
    """Every pipeline shape lowers — joins, tee and chains past a reduce
    to stage DAGs (``test_torch_dag.py``, ``test_torch_join.py``), group
    mode to its plans (``test_torch_group.py``); what is left unported is
    a windowed join under the multi-process backend, and a reduce the
    reference refuses raises its ``PipelineError``."""
    src = Pipeline.from_source(records=_events(n=10))
    chain = src.key_by().window(10.0).reduce("sum")
    assert chain.join(chain).build(device="cpu").is_join
    teed = chain.tee(Pipeline.branch().window(50.0).reduce("sum").sink("a/"),
                     Pipeline.branch().window(50.0).reduce("sum").sink("b/")
                     ).build(device="cpu")
    assert len(teed.stages) == 3 and len(teed.edges) == 2
    assert chain.key_by().window(50.0).reduce("sum").build(
        device="cpu").is_multistage
    with pytest.raises(PipelineError, match="group reduce kind"):
        src.key_by().window(10.0).reduce("median", mode="group",
                                         capacity=8).build(device="cpu")
    assert Pipeline.from_source(shards=[1]).map(lambda s: s).reduce(
        "max", mode="group", capacity=8).build(
            device="cpu", backend="vmap").batch_plan.axis.size == 8
    with pytest.raises(NotImplementedError, match="Queue A #11"):
        chain.join(chain).build(device="cpu", backend="shard_map",
                                n_workers=2)
    with pytest.raises(PipelineError, match="n_slots"):
        src.key_by().window(Windowing.sliding(20.0, 5.0)).reduce(
            "sum").build(device="cpu", n_slots=3)


# ---------------------------------------------------------------------------
# Exactly-once crash/restore: inside the port, and across the packages
# ---------------------------------------------------------------------------

class _Boom(RuntimeError):
    pass


def _crashing(base):
    class Crashing(base):
        """Crashes before micro-batch ``crash_batch`` — with the
        prefetcher on, later batches sit prepared and unconsumed."""

        def __init__(self, *args, crash_batch, **kwargs):
            super().__init__(*args, **kwargs)
            self._crash_batch = crash_batch
            self._processed = 0

        def _process_prepared(self, prep, report):
            if self._processed >= self._crash_batch:
                raise _Boom(f"injected crash before batch {prep.index}")
            super()._process_prepared(prep, report)
            self._processed += 1
    return Crashing


class CountingStore(MemoryStore):
    """Counts every object write (``put_many`` loops ``put``)."""

    def __init__(self):
        super().__init__()
        self.put_counts = Counter()

    def put(self, key, data):
        self.put_counts[key] += 1
        return super().put(key, data)


def _json_meta(meta, Meta):
    """The checkpoint metadata as it would come back from a persistent
    store: a JSON round trip into a fresh metadata store."""
    fresh = Meta()
    for key in meta.keys():
        fresh.set(key, json.loads(json.dumps(meta.get(key))))
    return fresh


def _crash_program(P, Wn, **kw):
    return (P.from_source(records=[], batch_records=100).key_by()
            .window(Wn.sliding(20.0, 5.0)).reduce("sum").sink("crash/")
            .build(num_buckets=8, n_workers=4, checkpoint_interval=2,
                   job_id="crash", allowed_lateness=1.0, **kw))


@pytest.mark.parametrize("first,then", [("port", "port"), ("jax", "port"),
                                        ("port", "jax")])
@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_crash_restore_exactly_once(first, then, overlap):
    """Crash mid-stream under one package, resume under the other (or the
    same) from the checkpoint: the sinks equal an uncrashed run byte for
    byte and every window object is written exactly once."""
    events = _events(n=1000, n_keys=5, span=200.0, seed=29, jitter=0.5)
    pkgs = {"jax": (JPipeline, JWindowing, JCoordinator, JRunOptions,
                    JStreamSource, JMetadataStore, {"backend": "pallas"}),
            "port": (Pipeline, Windowing, StreamingCoordinator, RunOptions,
                     StreamSource, MetadataStore, {"device": "cpu"})}

    def opts(pkg):
        RO = pkgs[pkg][3]
        if overlap:
            return RO(prefetch_batches=2)
        return RO(**SYNC, **({"donate_carry": False} if pkg == "jax" else {}))

    def program(pkg):
        P, Wn, *_rest, kw = pkgs[pkg]
        return _crash_program(P, Wn, **kw)

    ref_store = MemoryStore()
    program("port").run(StreamSource.from_records(events, batch_records=100),
                        store=ref_store, options=opts("port"),
                        mode="streaming")
    ref = program("port").collect_outputs(ref_store)
    assert ref

    store, meta = CountingStore(), pkgs[first][5]()
    Coord, Src = pkgs[first][2], pkgs[first][4]
    dead = _crashing(Coord)(store, meta, program=program(first),
                            options=opts(first), crash_batch=3)
    with pytest.raises(_Boom):
        dead.run_stream(Src.from_records(events, batch_records=100),
                        announce=False, flush=False)
    assert meta.get("stream/crash/state")["offset"] == 200
    meta = _json_meta(meta, pkgs[then][5])
    report = program(then).run(
        pkgs[then][4].from_records(events, batch_records=100), store=store,
        meta=meta, options=opts(then), mode="streaming")
    assert report.error is None
    assert program("port").collect_outputs(store) == ref   # no lost windows
    for key in ref:
        assert store.put_counts[key] == 1, key              # no duplicates


def test_carries_from_reference():
    """The reference's carries (pallas flat slab, and the vmap backend's
    worker-batched layout) as port tensors: same bytes, flat layout."""
    from repro.engine.plan import ExecutionPlan, KeySpace, ReduceSpec, \
        WindowSpec
    rng = np.random.default_rng(43)
    plan = ExecutionPlan(KeySpace.dense(16), ReduceSpec(), 4,
                         WindowSpec(100.0, 25.0, 8))
    rows = np.stack([rng.integers(0, 24, 400), rng.integers(1, 5, 400),
                     rng.integers(0, 16, 400), rng.integers(0, 100, 400),
                     np.ones(400)], axis=1).astype(np.float32)
    pal = plan.compile(backend="pallas")
    vm = plan.compile(backend="vmap")
    pc, _ = pal.step(rows, pal.init_carry(), 0)
    vc, _ = vm.step(rows.reshape(4, 100, 5), vm.init_carry(), 0)
    (a, b) = carries_from_reference([np.asarray(pc), np.asarray(vc)], "cpu")
    assert a.shape == b.shape == (8 * 16, 2)
    assert np.array_equal(a.numpy(), np.asarray(pc))
    assert np.array_equal(b.numpy(), np.asarray(pc))
    with pytest.raises(TypeError):
        carries_from_reference([np.zeros((4, 2), np.float64)], "cpu")
