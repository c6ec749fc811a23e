"""Rank programs for ``test_torch_shard_map.py``: worlds of 2-4 gloo ranks
on the CPU, one process a worker.

``spawn(body, world, root, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (the ``spawn`` method), joins them into one gloo
group through a ``FileStore`` under ``root`` (no TCP port), runs
``body(rank, world, root, *args)`` in each and waits at most ``timeout``
seconds, killing every rank past it.  The bodies import ``repro_torch``
only, build their programs with ``backend="shard_map"`` and
``device="cpu"``, and leave what they saw as ``root/out<rank>.pkl``; the
object store they share is a ``FileStore`` under ``root/store``, which
only rank 0 writes.
"""

import faulthandler
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the single-stage program of the reference's
#: ``test_pipeline_streaming_shard_map_matches_vmap``
SINGLE_EVENTS = [(float(t), f"k{t % 5}", float(t % 7)) for t in range(400)]
#: the two-stage chain of ``test_multistage_shard_map_matches_vmap``
CHAIN_EVENTS = [(float(t), f"k{t % 5}", float(t % 7)) for t in range(600)]
#: the tee of ``test_tee_shard_map_matches_vmap``
TEE_EVENTS = [(float(t), f"k{t % 7}", float(t % 5)) for t in range(800)]


def _entry(rank, body, world, root, args):
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=world)
    try:
        body(rank, world, root, *args)
    finally:
        dist.destroy_process_group()


def spawn(body, world, root, *args, timeout=100.0):
    """Run ``body`` on ``world`` gloo ranks; raise if a rank fails or the
    world outlives ``timeout`` seconds."""
    ctx = mp.start_processes(_entry, args=(body, world, str(root), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [load(root, r) for r in range(world)]


def save(root, rank, obj):
    with open(os.path.join(root, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(root, rank):
    with open(os.path.join(root, f"out{rank}.pkl"), "rb") as f:
        return pickle.load(f)


def _report(rep):
    return {k: getattr(rep, k) for k in (
        "records_in", "records_expanded", "late_dropped", "windows_emitted",
        "handoffs", "hash_collisions", "capacity_dropped", "batches")}


def word_shards(world, n_keys=64, n_per=512, seed=0):
    """The reference multi-device test's token shards: ``(world * n_per,
    2)`` int32 ``(token, 1)`` rows, shard ``w`` in rows ``[w * n_per, (w +
    1) * n_per)``."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, (world, n_per)).astype(np.int32)
    return np.stack([keys, np.ones_like(keys)], -1).reshape(world * n_per, 2)


def batch_body(rank, world, root):
    """The aggregate and the group word count, plus a hashed key space
    with collision tracking, each rank handed the whole data."""
    from repro_torch.core.mapreduce import wordcount_map_factory
    from repro_torch.pipeline import Pipeline
    n_keys = 64
    shard = word_shards(world, n_keys)
    out = {}
    for name, kw in (("sum", {}), ("hashed", {"key_space": "hashed"})):
        built = (Pipeline.from_source(shards=shard)
                 .map(wordcount_map_factory(1 << 20)).reduce("sum")
                 .build(num_buckets=n_keys if not kw else 16,
                        n_workers=world, backend="shard_map", device="cpu",
                        **kw))
        res, st = built.run_batch(data=shard)
        out[name] = (res.numpy(), int(st.sent), int(st.dropped),
                     None if st.bucket_collisions is None
                     else st.bucket_collisions.numpy())
    grp = (Pipeline.from_source(shards=shard).map(wordcount_map_factory(n_keys))
           .reduce("sum", mode="group", capacity=2048)
           .build(num_buckets=n_keys, n_workers=world, backend="shard_map",
                  device="cpu"))
    (gk, gv, gvalid), gst = grp.run_batch(data=shard)
    out["group"] = ((gk.numpy(), gv.numpy(), gvalid.numpy()), int(gst.sent),
                    int(gst.dropped), None)
    save(root, rank, out)


def stream_program(P, Wn, case, **build):
    """The reference's shard_map streaming programs, by name."""
    if case == "single":
        return (P.from_source(records=SINGLE_EVENTS, batch_records=100)
                .key_by().window(Wn.tumbling(50.0)).reduce("sum")
                .build(num_buckets=20, job_id="sm", **build))
    if case == "chain":
        return (P.from_source(records=CHAIN_EVENTS, batch_records=100)
                .key_by().window(Wn.tumbling(20.0)).reduce("count")
                .window(Wn.tumbling(100.0)).reduce("sum")
                .build(num_buckets=20, job_id="sm2", **build))
    if case == "group":
        return (P.from_source(records=CHAIN_EVENTS, batch_records=100)
                .key_by().window(Wn.sliding(40.0, 20.0))
                .reduce("max", mode="group", capacity=32)
                .build(num_buckets=20, job_id="smg", **build))
    base = (P.from_source(prefix="streams/ev", batch_records=100)
            .key_by().window(Wn.tumbling(20.0)).reduce("count"))
    return base.tee(
        P.branch().window(Wn.tumbling(100.0)).reduce("sum").top_k(3)
        .sink("smt-top/"),
        P.branch().map(_upper).key_by().window(Wn.tumbling(100.0))
        .reduce("sum").sink("smt-roll/"),
    ).build(num_buckets=28, job_id="smt", checkpoint_interval=3, **build)


def _upper(r):
    return (r[0], r[1].upper(), r[2])


def stream_body(rank, world, root, case):
    """One streaming program, every rank over the same source; the tee
    restarts mid-stream from its checkpoint, as the reference's case."""
    from repro_torch.core import FileStore, MetadataStore
    from repro_torch.pipeline import Pipeline, Windowing
    from repro_torch.streaming import StreamSource, write_event_log
    built = stream_program(Pipeline, Windowing, case, n_workers=world,
                           backend="shard_map", device="cpu")
    store, meta = FileStore(os.path.join(root, "store")), MetadataStore()
    reports = []
    if case == "tee":
        if rank == 0:
            write_event_log(store, "streams/ev", TEE_EVENTS)
        dist.barrier()
        reports.append(built.run(StreamSource.from_records(
            TEE_EVENTS[:400], batch_records=100), store=store, meta=meta,
            mode="streaming", flush=False))
    reports.append(built.run(store=store, meta=meta, mode="streaming"))
    save(root, rank, [_report(r) for r in reports])


class _Crash(RuntimeError):
    pass


def crash_body(rank, world, root, crash_batch, snapshot, case="crash"):
    """Crash every rank before micro-batch ``crash_batch`` (after a
    checkpoint), then resume from it under the same backend — or, with
    ``snapshot``, stop there and leave rank 0's metadata as
    ``root/meta.json`` for a restore under another backend.  Rank 0
    reports its store writes per key.  ``case`` is ``"crash"`` (a sliding
    sum) or ``"join"`` (``join_crash_program`` over both logs)."""
    from collections import Counter
    from repro_torch.core import FileStore, MetadataStore
    from repro_torch.pipeline import Pipeline, RunOptions, Windowing
    from repro_torch.pipeline.runtime import resolve_source
    from repro_torch.streaming import StreamingCoordinator, StreamSource

    class Counting(FileStore):
        def __init__(self, path):
            super().__init__(path)
            self.puts = Counter()

        def put(self, key, data):
            self.puts[key] += 1
            return super().put(key, data)

    class Crashing(StreamingCoordinator):
        def _process_prepared(self, prep, report):
            if prep.index >= crash_batch:
                raise _Crash(f"injected crash before batch {prep.index}")
            super()._process_prepared(prep, report)

    make = join_crash_program if case == "join" else crash_program
    built = make(Pipeline, Windowing, n_workers=world, backend="shard_map",
                 device="cpu")
    store, meta = Counting(os.path.join(root, "store")), MetadataStore()
    source = (resolve_source(built, store) if case == "join" else
              StreamSource.from_records(crash_events(), batch_records=100))
    dead = Crashing(store, meta, program=built, options=RunOptions())
    try:
        dead.run_stream(source, announce=False, flush=False)
    except _Crash:
        pass
    offset = meta.get(f"stream/{built.job_id}/state")["offset"]
    if snapshot:
        if rank == 0:
            meta.snapshot(os.path.join(root, "meta.json"))
        save(root, rank, {"offset": offset})
        return
    rep = built.run(source, store=store, meta=meta, mode="streaming")
    save(root, rank, {"offset": offset, "report": _report(rep),
                      "puts": dict(store.puts)})


def crash_events():
    rng = np.random.default_rng(29)
    ts = np.sort(rng.uniform(0, 200.0, 1000))
    ts = np.clip(ts + rng.normal(0, 0.5, 1000), 0, None)
    keys = rng.integers(0, 5, 1000)
    vals = rng.integers(0, 9, 1000).astype(float)
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


def crash_program(P, Wn, **build):
    return (P.from_source(records=[], batch_records=100).key_by()
            .window(Wn.sliding(20.0, 5.0)).reduce("sum").sink("crash/")
            .build(num_buckets=8, checkpoint_interval=2, job_id="crash",
                   allowed_lateness=1.0, **build))


def _join_events(n, n_keys, seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 300.0, n))
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 9, n).astype(float)
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


#: the two logs of the join cases: integer values, so every float32 fold
#: is exact in any order and the ranks' sums equal the reference's
JOIN_LEFT = _join_events(700, 7, 41)
JOIN_RIGHT = _join_events(500, 7, 42)
#: the join cases: (left reduce, right reduce, build options)
JOIN_CASES = {
    "sum-count": ("sum", "count", {"num_buckets": 20}),
    "mean-hashed": ("mean", "mean", {"num_buckets": 16,
                                     "key_space": "hashed"}),
    "asymmetric": ("sum", "count", {"num_buckets": (8, 16)}),
}


def join_program(P, Wn, case, **build):
    """Two logs joined per key per 50 s window (the reference's
    ``tumbling(50)`` join), by case."""
    lagg, ragg, opts = JOIN_CASES[case]
    left = (P.from_source(records=JOIN_LEFT, batch_records=100).key_by()
            .window(Wn.tumbling(50.0)).reduce(lagg))
    right = (P.from_source(records=JOIN_RIGHT, batch_records=100).key_by()
             .window(Wn.tumbling(50.0)).reduce(ragg))
    return left.join(right).sink("joined/").build(
        job_id=f"join-{case}", **opts, **build)


def join_crash_program(P, Wn, **build):
    """The sum ⋈ count join checkpointed every two micro-batches."""
    left = (P.from_source(records=JOIN_LEFT, batch_records=100).key_by()
            .window(Wn.tumbling(50.0)).reduce("sum"))
    right = (P.from_source(records=JOIN_RIGHT, batch_records=100).key_by()
             .window(Wn.tumbling(50.0)).reduce("count"))
    return left.join(right).sink("jcrash/").build(
        num_buckets=20, checkpoint_interval=2, job_id="jcrash", **build)


def join_body(rank, world, root, case):
    """One join case under ``shard_map``: every rank reads both logs and
    folds its share of each micro-batch."""
    from repro_torch.core import FileStore, MetadataStore
    from repro_torch.pipeline import Pipeline, Windowing
    built = join_program(Pipeline, Windowing, case, n_workers=world,
                         backend="shard_map", device="cpu")
    store = FileStore(os.path.join(root, "store"))
    rep = built.run(store=store, meta=MetadataStore(), mode="streaming")
    save(root, rank, {"report": _report(rep), "folds": rep.folds,
                      "carry": tuple(built.stages[0].sides[0].compiled
                                     .init_carry().shape)})


def compressed_psum_body(rank, world, root, grads):
    """``optim.compressed_psum`` over the ranks of this rank's gradient
    tree: ``grads`` maps a leaf name to every rank's values stacked on a
    leading axis (numpy)."""
    from repro_torch.engine.compile import DistributedAxis
    from repro_torch.optim import compressed_psum
    mine = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    out = compressed_psum(mine, DistributedAxis(None))
    save(root, rank, {k: (v.dtype, v.float().numpy())
                      for k, v in out.items()})


def shardmap_train_body(rank, world, root, arch, batch, compress):
    """Two steps of ``make_shardmap_train_step`` on the reduced ``arch``
    (parameters from seed 0), every rank handed the global ``batch``;
    saves the parameters (numpy leaves) and the metrics after each."""
    from repro_torch import configs
    from repro_torch.engine.compile import DistributedAxis
    from repro_torch.optim import AdamW
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime import init_train_state
    from repro_torch.runtime.train_step import make_shardmap_train_step
    cfg = configs.get_reduced(arch)
    opt = AdamW(lr=1e-3)
    state = init_train_state(0, cfg, opt, device="cpu")
    step = make_shardmap_train_step(cfg, opt, DistributedAxis(None),
                                    compress_grads=compress)
    params, metrics = [], []
    for _ in range(2):
        state, m = step(state, batch)
        params.append([p.numpy() for p in tree_leaves(state.params)])
        metrics.append({k: float(v) for k, v in m.items()})
    save(root, rank, {"params": params, "metrics": metrics})


# -- the job service under shard_map (test_torch_shard_map_service.py) -------

#: the shared log's events: sorted, integer values
SERVICE_EVENTS = _join_events(600, 5, 43)
#: three tenants on one shared ingest: a mean, a count and a max (group
#: mode: windowed aggregates are count / sum / mean in both packages)
SERVICE_TENANTS = (("alice", "mean"), ("bob", "count"), ("carol", "max"))
#: registry fields measured on the host clock
SERVICE_TIMES = {"pool_seconds", "submitted", "cold_start_seconds"}


def service_program(P, Wn, job_id, agg, **build):
    """A tenant's program over the shared GPS-like log (no bound source:
    the job server feeds it)."""
    pipe = (P.from_source(batch_records=100).key_by()
            .window(Wn.tumbling(50.0)))
    pipe = (pipe.reduce("max", mode="group", capacity=256) if agg == "max"
            else pipe.reduce(agg))
    return pipe.sink("stream-output/").build(
        num_buckets=16, batch_records=100, job_id=job_id, **build)


def _sink(store, tenant, job_id):
    ns = f"tenants/{tenant}/"
    return {m.key[len(ns):]: store.get(m.key)
            for m in store.list_objects(f"{ns}stream-output/{job_id}/")}


def service_scenario(ns, store, meta, world, write, **build):
    """Three tenants on one shared ingest, parked once the first part of
    the log drains (``idle_seconds=0``), then two more parts appended and
    the jobs cold-restored to the end.  ``ns`` holds a package's
    ``JobServer``, ``ParkPolicy``, ``Pipeline`` and ``Windowing``;
    ``write(store, events)`` appends to the log (rank 0 alone, then a
    barrier, under ``shard_map``).  Returns what the ranks and the
    reference must agree on."""
    write(store, SERVICE_EVENTS[:350])
    server = ns.JobServer(store, meta,
                          park_policy=ns.ParkPolicy(idle_seconds=0.0))
    for name, agg in SERVICE_TENANTS:
        server.add_tenant(name)
        server.submit(name, service_program(
            ns.Pipeline, ns.Windowing, f"svc-{name}", agg, n_workers=world,
            **build), source_prefix="gps/")
    while server.step():
        pass
    parked = {jid: j.state for jid, j in server.jobs.items()}
    write(store, SERVICE_EVENTS[350:500])
    server.step()
    write(store, SERVICE_EVENTS[500:])
    states = server.run_until_complete()
    full = {jid: server.registry.record(jid) for jid in server.jobs}
    records = {jid: {k: v for k, v in rec.items() if k not in SERVICE_TIMES}
               for jid, rec in full.items()}
    return {"parked": parked, "states": states, "records": records,
            "records_with_times": full,
            "index": server.registry.jobs(),
            "ingest": server.stats()["ingests"],
            "sinks": {f"svc-{name}": _sink(store, name, f"svc-{name}")
                      for name, _agg in SERVICE_TENANTS}}


def quota_scenario(ns, store, meta, world, write, **build):
    """A tenant within its quotas beside one over its pool-time quota and
    one over its byte quota: each failing job fails at one batch, its
    neighbour finishes."""
    write(store, SERVICE_EVENTS)
    server = ns.JobServer(store, meta)
    server.add_tenant("rich")
    server.add_tenant("broke", quota_pool_seconds=1e-9)
    server.add_tenant("cheap", quota_bytes=64)
    for tenant, agg in (("rich", "mean"), ("broke", "count"),
                        ("cheap", "mean")):
        server.submit(tenant, service_program(
            ns.Pipeline, ns.Windowing, f"q-{tenant}", agg, n_workers=world,
            **build), source_prefix="gps/")
    states = server.run_until_complete()
    return {"states": states,
            "failed": {jid: (j.error.split(":")[0], j.cursor,
                             j.report.batches)
                       for jid, j in server.jobs.items() if j.error},
            "sink": _sink(store, "rich", "q-rich")}


#: seconds each rank's meter bills a fold in ``meter_scenario`` (rank 1
#: bills more, so its own meter alone would cross the quota earlier than
#: rank 0's and later than the two summed), and the metered tenant's quota
METER_BILLS = (1.0, 2.0)
METER_QUOTA = 7.0


def billed_submit(seconds):
    """A ``MeteredPool.submit`` that bills ``seconds`` a fold in place of
    the fold's wall time, so that a test sets what each meter counts."""
    def submit(self, fn, *args, **kwargs):
        try:
            return self._inner.submit(fn, *args, **kwargs)
        finally:
            self.meter.pool_seconds += seconds
            self.meter.invocations += 1
    return submit


def meter_scenario(ns, store, meta, world, write, **build):
    """A tenant over its pool-time quota (``METER_QUOTA``) beside one
    without a quota, on one shared ingest: the metered job fails at the
    batch at which its bill crosses the quota, its neighbour finishes."""
    write(store, SERVICE_EVENTS)
    server = ns.JobServer(store, meta)
    server.add_tenant("free")
    server.add_tenant("metered", quota_pool_seconds=METER_QUOTA)
    for tenant, agg in (("free", "mean"), ("metered", "count")):
        server.submit(tenant, service_program(
            ns.Pipeline, ns.Windowing, f"m-{tenant}", agg, n_workers=world,
            **build), source_prefix="gps/")
    states = server.run_until_complete()
    return {"states": states,
            "failed": {jid: (j.error.split(":")[0], j.cursor,
                             j.report.batches)
                       for jid, j in server.jobs.items() if j.error},
            "sink": _sink(store, "free", "m-free")}


def _port_service():
    from types import SimpleNamespace

    from repro_torch.pipeline import Pipeline, Windowing
    from repro_torch.service import JobServer, ParkPolicy
    return SimpleNamespace(JobServer=JobServer, ParkPolicy=ParkPolicy,
                           Pipeline=Pipeline, Windowing=Windowing)


def _rank_writer(rank):
    """Appends to the shared log on rank 0, then a barrier."""
    from repro_torch.streaming import write_event_log

    def write(store, events):
        if rank == 0:
            write_event_log(store, "gps/", events, segment_records=64)
        dist.barrier()
    return write


def service_body(rank, world, root, scenario):
    """``service_scenario``, ``quota_scenario`` or ``meter_scenario`` on
    this rank, over the shared ``FileStore`` and the rank's own
    ``MetadataStore``.  Under ``meter_scenario`` the rank's meters bill
    ``METER_BILLS[rank]`` a fold."""
    from repro_torch.core import FileStore, MetadataStore
    from repro_torch.core.autoscaler import MeteredPool
    run = {"service": service_scenario, "quota": quota_scenario,
           "meter": meter_scenario}[scenario]
    if scenario == "meter":
        MeteredPool.submit = billed_submit(METER_BILLS[rank])
    out = run(_port_service(), FileStore(os.path.join(root, "store")),
              MetadataStore(), world, _rank_writer(rank),
              backend="shard_map", device="cpu")
    save(root, rank, out)


def service_crash_body(rank, world, root, crash_job, crash_after):
    """Every rank's server crashes while the overlapped drive is in flight
    (``crash_job``'s coordinator raises before its batch ``crash_after``),
    then a fresh server on each rank re-attaches every job with
    ``resume=True`` over the same store and the rank's same metadata and
    finishes.  Reports each rank's store writes per key."""
    from collections import Counter

    import repro_torch.service.server as server_mod
    from repro_torch.core import FileStore, MetadataStore
    from repro_torch.streaming import StreamingCoordinator

    class Counting(FileStore):
        def __init__(self, path):
            super().__init__(path)
            self.puts = Counter()

        def put(self, key, data):
            self.puts[key] += 1
            return super().put(key, data)

    class Crashing(StreamingCoordinator):
        survived = 0

        def _process_prepared(self, prep, report):
            if self.prog.job_id == crash_job:
                if Crashing.survived >= crash_after:
                    raise _Crash(f"injected crash before batch {prep.index}")
                Crashing.survived += 1
            return super()._process_prepared(prep, report)

    ns = _port_service()
    store, meta = Counting(os.path.join(root, "store")), MetadataStore()
    _rank_writer(rank)(store, SERVICE_EVENTS)

    def serve(resume):
        server = ns.JobServer(store, meta)
        for name, agg in SERVICE_TENANTS:
            server.add_tenant(name)
            server.submit(name, service_program(
                ns.Pipeline, ns.Windowing, f"svc-{name}", agg,
                n_workers=world, backend="shard_map", device="cpu"),
                source_prefix="gps/", resume=resume)
        return server

    server_mod.StreamingCoordinator = Crashing
    try:
        serve(False).run_until_complete()
        crashed = False
    except _Crash:
        crashed = True
    finally:
        server_mod.StreamingCoordinator = StreamingCoordinator
    server = serve(True)
    states = server.run_until_complete()
    save(root, rank, {"crashed": crashed, "states": states,
                      "index": server.registry.jobs(),
                      "puts": dict(store.puts)})
