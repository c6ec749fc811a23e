"""The port's multi-tenant job service against the reference's.

Every scenario of the reference's ``tests/test_job_service.py``,
``tests/test_job_service_overlap.py`` and ``tests/test_ingest_partitions.py``
runs through ``repro`` (JAX on the CPU) and ``repro_torch``
(``device="cpu"``, the fold's plain PyTorch version) over the same event
log, made from a numpy seed.  Each tenant's sink objects, the job states,
the shared ingest's accounting, and the status records' fields that are
not times must be identical across the two packages; each sink must also
equal the same program run alone.  Then a job checkpointed by one
package's ``JobServer`` re-attaches in the other's and finishes with the
reference's bytes, both ways.  The card's runs (tenants built with
``device="cuda"`` against the same jobs on the CPU, park and restore of
a carry on the card) carry the ``cuda`` marker and skip here.
"""

import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.launch.serve as jserve
import repro.pipeline as jpipeline
import repro.service as jservice
import repro.service.server as jserver_mod
import repro.streaming as jstreaming

import repro_torch.core as core
import repro_torch.launch.serve as serve
import repro_torch.pipeline as pipeline
import repro_torch.service as service
import repro_torch.service.server as server_mod
import repro_torch.streaming as streaming
from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.kernels.fused_fold import ops as fold_ops

W = 4


def _pkg(core_, pipeline_, service_, streaming_, serve_, server_mod_,
         build):
    return SimpleNamespace(
        MemoryStore=core_.MemoryStore, MetadataStore=core_.MetadataStore,
        EventBus=core_.EventBus, JobServiceClient=core_.JobServiceClient,
        QuotaExceeded=core_.QuotaExceeded, Pipeline=pipeline_.Pipeline,
        PipelineError=pipeline_.PipelineError, Windowing=pipeline_.Windowing,
        JobServer=service_.JobServer, JobStatus=service_.JobStatus,
        ParkPolicy=service_.ParkPolicy, SharedIngest=service_.SharedIngest,
        ComputeQuotaExceeded=service_.ComputeQuotaExceeded,
        StreamSource=streaming_.StreamSource,
        StreamingCoordinator=streaming_.StreamingCoordinator,
        write_event_log=streaming_.write_event_log, JobRPC=serve_.JobRPC,
        server_mod=server_mod_, build=build)


JAX = _pkg(jcore, jpipeline, jservice, jstreaming, jserve, jserver_mod, {})
PORT = _pkg(core, pipeline, service, streaming, serve, server_mod,
            {"device": "cpu"})
PKGS = {"jax": JAX, "port": PORT}
#: the reference's flat-carry backend, whose checkpoint format the port
#: shares (its default backend keeps a (workers, rows, channels) carry)
JAX_FLAT = SimpleNamespace(**{**vars(JAX), "build": {"backend": "pallas"}})

#: record fields measured on the host clock; every other field must match
_TIMES = {"pool_seconds", "submitted", "cold_start_seconds"}


def _counting_store(pkg):
    """A MemoryStore that counts get() and put() calls per key — the
    analogue of the paper's per-request S3 billing line."""

    class CountingStore(pkg.MemoryStore):
        def __init__(self):
            super().__init__()
            self.gets = Counter()
            self.put_counts = Counter()

        def get(self, key, *args, **kwargs):
            self.gets[key] += 1
            return super().get(key, *args, **kwargs)

        def put(self, key, data):
            self.put_counts[key] += 1
            return super().put(key, data)

    return CountingStore()


def _events(n=600, n_keys=5, span=120.0, seed=0, t0=0.0):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(t0, t0 + span, n))   # in order: no late drops
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 9, n).astype(float)    # ints exact in float32
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


def _program(pkg, job_id, *, agg="sum", batch_records=100,
             checkpoint_interval=1, sink="stream-output/", **build):
    return (pkg.Pipeline.from_source(batch_records=batch_records).key_by()
            .window(pkg.Windowing.tumbling(25.0)).reduce(agg).sink(sink)
            .build(num_buckets=16, n_workers=W, batch_records=batch_records,
                   checkpoint_interval=checkpoint_interval, job_id=job_id,
                   **{**pkg.build, **build}))


def _standalone(pkg, events, job_id, *, agg="sum", batch_records=100,
                **build):
    """Ground truth: the same program driven alone on a private store."""
    built = _program(pkg, job_id, agg=agg, batch_records=batch_records,
                     **build)
    store = pkg.MemoryStore()
    coord = pkg.StreamingCoordinator(store, pkg.MetadataStore(),
                                     program=built)
    coord.run_stream(pkg.StreamSource.from_records(
        events, batch_records=batch_records))
    return {m.key: store.get(m.key)
            for m in store.list_objects(f"stream-output/{job_id}/")}


def _sink_bytes(store, tenant, job_id):
    """A tenant's sink on the shared store, keyed namespace-relative so it
    compares directly against a standalone run."""
    ns = f"tenants/{tenant}/"
    return {m.key[len(ns):]: store.get(m.key)
            for m in store.list_objects(f"{ns}stream-output/{job_id}/")}


def _status(server, job_id):
    return {k: v for k, v in server.status(job_id).items()
            if k not in _TIMES}


def _both(scenario, *args, **kwargs):
    """Run ``scenario(pkg, ...)`` through both packages; the port's result
    must equal the reference's.  Returns the port's."""
    got = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------------------
# Shared ingest: physical-once + byte parity (tests/test_job_service.py)
# ---------------------------------------------------------------------------

def _two_tenants(pkg, events):
    store = _counting_store(pkg)
    pkg.write_event_log(store, "gps/", events, segment_records=128)
    server = pkg.JobServer(store, pkg.MetadataStore())
    server.add_tenant("alice")
    server.add_tenant("bob")
    a = server.submit("alice", _program(pkg, "shared-a"),
                      source_prefix="gps/")
    b = server.submit("bob", _program(pkg, "shared-b", agg="count"),
                      source_prefix="gps/")
    states = server.run_until_complete()
    seg_reads = {k: c for k, c in store.gets.items()
                 if k.startswith("gps/segment-")}
    return dict(states=states, seg_reads=seg_reads,
                ingest=server.stats()["ingests"],
                status={j: _status(server, j) for j in (a, b)},
                sinks={j: _sink_bytes(store, t, j)
                       for t, j in (("alice", a), ("bob", b))})


def test_two_tenants_one_physical_ingest_byte_identical_sinks():
    events = _events(n=600, seed=1)
    got = _both(_two_tenants, events)
    assert set(got["states"].values()) == {"DONE"}
    assert got["seg_reads"] and set(got["seg_reads"].values()) == {1}
    assert got["ingest"]["gps"]["pumped"] == len(events)
    assert got["ingest"]["gps"]["subscribers"] == 2
    assert got["sinks"]["shared-a"] == _standalone(PORT, events, "shared-a")
    assert got["sinks"]["shared-b"] == \
        _standalone(PORT, events, "shared-b", agg="count")


def _late_registration(pkg, events, n_partitions):
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", events, segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore(),
                           ingest_partitions=n_partitions)
    server.add_tenant("alice")
    server.add_tenant("bob")
    server.submit("alice", _program(pkg, "early-1"), source_prefix="gps/")
    server.step()                   # ingest fully materialized, alice ahead
    pumped = server.ingests["gps"].pumped
    late = server.submit("bob", _program(pkg, "late-1", agg="count"),
                         source_prefix="gps/")
    cursor = server.jobs[late].cursor
    server.run_until_complete()
    return dict(pumped=pumped, cursor=cursor,
                partitions=server.ingests["gps"].n_partitions,
                early=_sink_bytes(store, "alice", "early-1"),
                late=_sink_bytes(store, "bob", "late-1"))


@pytest.mark.parametrize("n_partitions", [1, 3])
def test_late_registering_job_replays_from_log_start(n_partitions):
    events = _events(n=400, seed=4)
    got = _both(_late_registration, events, n_partitions)
    assert got["pumped"] == len(events) and got["cursor"] == 0
    assert got["partitions"] == n_partitions
    assert got["early"] == _standalone(PORT, events, "early-1")
    assert got["late"] == _standalone(PORT, events, "late-1", agg="count")


# ---------------------------------------------------------------------------
# Scale-to-zero lifecycle and crash re-attach
# ---------------------------------------------------------------------------

def _park_and_restore(pkg, events):
    first, second = events[:250], events[250:]
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", first, segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore(),
                           park_policy=pkg.ParkPolicy(idle_seconds=0.0))
    server.add_tenant("alice")
    jid = server.submit("alice", _program(pkg, "cold-1"),
                        source_prefix="gps/")
    while server.step():
        pass
    job = server.jobs[jid]
    parked = (job.state, job.coord is None,
              server.pool.stats()["replicas"],
              server.pool.stats()["scale_downs"] >= 1, _status(server, jid))
    pkg.write_event_log(store, "gps/", second, segment_records=64)
    states = server.run_until_complete()
    rec = server.registry.record(jid)
    assert rec["cold_start_seconds"] > 0
    assert job.cold_start_latencies and all(
        t > 0 for t in job.cold_start_latencies)
    return dict(parked=parked, states=states, parks=rec["parks"],
                restores=rec["restores"], status=_status(server, jid),
                sink=_sink_bytes(store, "alice", "cold-1"))


def test_park_scales_to_zero_and_cold_restore_is_exactly_once():
    events = _events(n=400, seed=2, span=100.0)
    got = _both(_park_and_restore, events)
    assert got["parked"][:3] == ("PARKED", True, 0) and got["parked"][3]
    assert got["states"] == {"cold-1": "DONE"}
    assert got["parks"] >= 1 and got["restores"] >= 1
    assert got["sink"] == _standalone(PORT, events, "cold-1")


def _crash_reattach(pkg, events, n_partitions, split, first_pkg=None):
    """Run the job until it parks on the first ``split`` records, drop the
    server (the crash), append the rest, and re-attach on a fresh server
    over the same store and metadata — built by ``first_pkg`` first when
    given, so the checkpoint crosses packages."""
    first_pkg = first_pkg or pkg
    store = pkg.MemoryStore()
    meta = pkg.MetadataStore()
    first_pkg.write_event_log(store, "gps/", events[:split],
                              segment_records=64)
    server = first_pkg.JobServer(
        store, meta, ingest_partitions=n_partitions,
        park_policy=first_pkg.ParkPolicy(idle_seconds=0.0))
    server.add_tenant("alice")
    server.submit("alice", _program(first_pkg, "crash-1"),
                  source_prefix="gps/")
    while server.step():
        pass
    before = (server.jobs["crash-1"].state, _status(server, "crash-1"),
              server.jobs["crash-1"].sub.partition_cursors(split))
    del server                          # the crash: all live state gone
    pkg.write_event_log(store, "gps/", events[split:], segment_records=64)
    server2 = pkg.JobServer(store, meta, ingest_partitions=n_partitions)
    server2.add_tenant("alice")
    server2.submit("alice", _program(pkg, "crash-1"), source_prefix="gps/",
                   resume=True)
    reattached = _status(server2, "crash-1")
    server2.ingests["gps"].pump()       # re-materialize from the log
    after = (server2.status("crash-1")["lag"],
             server2.jobs["crash-1"].sub.partition_cursors(split))
    states = server2.run_until_complete()
    return dict(before=before, reattached=reattached, after=after,
                states=states, status=_status(server2, "crash-1"),
                sink=_sink_bytes(store, "alice", "crash-1"))


@pytest.mark.parametrize("n_partitions,split", [(1, 300), (3, 290)])
def test_crashed_server_reattaches_and_finishes_exactly_once(n_partitions,
                                                             split):
    """The checkpoint falls mid-segment at 290 records (64 a segment): the
    per-partition cursor dissection comes back identical after the crash,
    and a re-attached job reports its checkpointed offset before its first
    drive (tests/test_job_service_overlap.py's status fix)."""
    events = _events(n=400, seed=3)
    got = _both(_crash_reattach, events, n_partitions, split)
    state, parked, cursors = got["before"]
    assert state == "PARKED" and parked["cursor"] == split == \
        parked["checkpointed_offset"] and parked["lag"] == 0
    assert got["reattached"]["cursor"] == split == \
        got["reattached"]["checkpointed_offset"]
    assert got["after"] == (len(events) - split, cursors)
    assert sum(cursors.values()) == split
    assert got["states"] == {"crash-1": "DONE"}
    assert got["sink"] == _standalone(PORT, events, "crash-1")


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_checkpoint_reattaches_across_packages(first, then):
    """A job parked and checkpointed by one package's JobServer re-attaches
    in the other's (resume=True) and finishes with the bytes the reference
    gives when it runs the whole log alone."""
    events = _events(n=400, seed=5)
    flat = {"jax": JAX_FLAT, "port": PORT}
    got = _crash_reattach(flat[then], events, 1, 260, first_pkg=flat[first])
    same = _crash_reattach(JAX, events, 1, 260)
    assert got["states"] == {"crash-1": "DONE"}
    assert got["reattached"]["checkpointed_offset"] == 260
    assert got["sink"] == same["sink"] == \
        _standalone(JAX, events, "crash-1")


# ---------------------------------------------------------------------------
# Tenancy: quotas and cross-job prefix claims
# ---------------------------------------------------------------------------

def _byte_quota(pkg, events):
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", events, segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore())
    server.add_tenant("alice")
    server.add_tenant("cheap", quota_bytes=64)  # too small for any state
    a = server.submit("alice", _program(pkg, "q-ok"), source_prefix="gps/")
    c = server.submit("cheap", _program(pkg, "q-poor"), source_prefix="gps/")
    states = server.run_until_complete()
    return dict(states=states, error=server.jobs[c].error,
                status=_status(server, c), a=_status(server, a),
                sink=_sink_bytes(store, "alice", "q-ok"))


def test_quota_breach_fails_only_the_offending_tenant():
    events = _events(n=300, seed=5)
    got = _both(_byte_quota, events)
    assert got["states"] == {"q-ok": "DONE", "q-poor": "FAILED"}
    assert "QuotaExceeded" in got["error"]
    assert "QuotaExceeded" in got["status"]["error"]
    assert got["sink"] == _standalone(PORT, events, "q-ok")


def test_quota_counts_replaced_objects_once():
    store = core.MemoryStore()
    server = service.JobServer(store, core.MetadataStore())
    view = server.add_tenant("tiny", quota_bytes=10).store_view(store)
    view.put("x", b"12345678")          # 8 of 10 bytes
    view.put("x", b"87654321")          # replacement frees the old 8 first
    with pytest.raises(core.QuotaExceeded):
        view.put("y", b"123")           # 8 + 3 > 10
    assert view.used_bytes() == 8


def _collisions(pkg):
    store = pkg.MemoryStore()
    server = pkg.JobServer(store, pkg.MetadataStore())
    server.add_tenant("alice")
    pkg.write_event_log(store, "gps/", _events(n=10), segment_records=8)
    server.submit("alice", _program(pkg, "dup-1"), source_prefix="gps/")
    errors = []
    with pytest.raises(ValueError, match="already registered") as e1:
        server.submit("alice", _program(pkg, "dup-1"), source_prefix="gps/")
    errors.append(str(e1.value))
    with pytest.raises(pkg.PipelineError, match="collides") as e2:
        server.submit("alice", _program(pkg, "dup-2",
                                        sink="stream-output/dup-1/"),
                      source_prefix="gps/")
    errors.append(str(e2.value))
    server.add_tenant("bob")
    server.submit("bob", _program(pkg, "dup-3"), source_prefix="gps/")
    jid = server.submit("alice", _program(pkg, "gone-1",
                                          sink="other-output/"),
                        source_prefix="gps/")
    server.step()
    server.cancel(jid)
    states = server.run_until_complete()
    with pytest.raises(ValueError, match="already CANCELLED") as e3:
        server.cancel(jid)
    errors.append(str(e3.value))
    # the cancelled job's prefix claim survives (its objects may too)
    with pytest.raises(pkg.PipelineError, match="collides") as e4:
        server.submit("alice", _program(pkg, "gone-2",
                                        sink="other-output/gone-1/"),
                      source_prefix="gps/")
    errors.append(str(e4.value))
    return dict(errors=errors, states=states, jobs=server.registry.jobs(),
                claims=server.registry.claimed_prefixes())


def test_prefix_collisions_and_cancel_keep_claims():
    got = _both(_collisions)
    assert got["states"]["gone-1"] == "CANCELLED"
    assert got["jobs"] == ["dup-1", "dup-3", "gone-1"]
    assert "tenants/alice/other-output/gone-1/" in got["claims"]


def _plan_rejected(pkg):
    """planlint admission: a sink over the reserved checkpoint namespace
    (PL005) is rejected before the job registers."""
    server = pkg.JobServer(pkg.MemoryStore(), pkg.MetadataStore())
    server.add_tenant("alice")
    with pytest.warns(UserWarning):
        program = _program(pkg, "lint-1", sink="jobs/")
    with pytest.raises(Exception, match="PL005") as exc:
        server.submit("alice", program, source_prefix="gps/")
    return type(exc.value).__name__, server.registry.jobs()


def test_planlint_rejects_at_submit():
    assert _both(_plan_rejected) == ("PlanRejected", [])


# ---------------------------------------------------------------------------
# Control plane: RPC skeleton + metadata-only client
# ---------------------------------------------------------------------------

def _lifecycle(pkg, events):
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", events[:150], segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore())
    server.add_tenant("alice")
    rpc = pkg.JobRPC(server)
    client = pkg.JobServiceClient(server)
    seen = []
    seen.append(rpc.handle({"method": "register", "name": "rollup",
                            "program": _program(pkg, "life-1")}))
    resp = rpc.handle({"method": "submit", "tenant": "alice",
                       "program": "rollup", "source_prefix": "gps/"})
    jid = resp["result"]
    seen += [resp, client.status(jid)["state"]]
    server.step()
    seen.append(client.status(jid)["state"])
    seen.append(rpc.handle({"method": "pause", "job_id": jid}))
    # paused jobs do NOT wake on arriving events — only resume() does
    pkg.write_event_log(store, "gps/", events[150:], segment_records=64)
    while server.step():
        pass
    seen += [client.status(jid)["state"], server.status(jid)["lag"]]
    seen.append(rpc.handle({"method": "resume", "job_id": jid}))
    seen.append(server.run_until_complete())
    seen += [_status(server, jid), client.jobs(),
             rpc.handle({"method": "jobs"}),
             rpc.handle({"method": "nope"}),
             rpc.handle({"method": "status", "job_id": "ghost"}),
             {k: v for k, v in client.status(jid).items()
              if k not in _TIMES}]
    return dict(seen=seen, sink=_sink_bytes(store, "alice", "life-1"))


def test_lifecycle_verbs_via_rpc_and_client():
    events = _events(n=300, seed=6)
    got = _both(_lifecycle, events)
    seen = got["seen"]
    assert seen[0] == {"ok": True, "result": "rollup"}
    assert seen[1] == {"ok": True, "result": "life-1"}
    assert seen[2:4] == ["PENDING", "RUNNING"]
    assert seen[4] == {"ok": True, "result": "PAUSED"}
    assert seen[5] == "PAUSED" and seen[6] > 0
    assert seen[7] == {"ok": True, "result": "RUNNING"}
    assert seen[8] == {"life-1": "DONE"}
    assert seen[9]["windows_emitted"] > 0
    assert seen[10] == ["life-1"]
    assert not seen[12]["ok"]
    assert not seen[13]["ok"] and "KeyError" in seen[13]["error"]
    assert got["sink"] == _standalone(PORT, events, "life-1")


# ---------------------------------------------------------------------------
# The overlapped drive (tests/test_job_service_overlap.py)
# ---------------------------------------------------------------------------

_TENANTS = (("alice", "sum"), ("bob", "count"), ("carol", "mean"))


def _service(pkg, events, *, overlap, store=None, meta=None, resume=False):
    """All three tenants on one shared source, driven to completion."""
    store = store if store is not None else pkg.MemoryStore()
    if not resume:
        pkg.write_event_log(store, "gps/", events, segment_records=128)
    server = pkg.JobServer(store, meta or pkg.MetadataStore(),
                           overlap=overlap)
    for name, agg in _TENANTS:
        server.add_tenant(name)
        server.submit(name, _program(pkg, f"ov-{name}", agg=agg,
                                     checkpoint_interval=2),
                      source_prefix="gps/", resume=resume)
    return store, server


def _overlap_vs_serial(pkg, events):
    out = {}
    for overlap in (False, True):
        store, server = _service(pkg, events, overlap=overlap)
        states = server.run_until_complete()
        out[overlap] = (states, {name: _sink_bytes(store, name, f"ov-{name}")
                                 for name, _ in _TENANTS},
                        {j: _status(server, j) for j in server.jobs})
    assert out[False] == out[True]
    return out[True]


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_overlapped_drive_byte_identical_to_serial(seed):
    events = _events(n=700, seed=seed)
    states, sinks, _ = _both(_overlap_vs_serial, events)
    assert set(states.values()) == {"DONE"}
    for name, agg in _TENANTS:
        assert sinks[name], f"{name} emitted nothing"
        assert sinks[name] == _standalone(PORT, events, f"ov-{name}",
                                          agg=agg, checkpoint_interval=2)


class _Boom(RuntimeError):
    pass


def _crash_mid_overlap(pkg, events, crash_job, crash_after, monkeypatch):
    class Crashing(pkg.StreamingCoordinator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._survived = 0

        def _process_prepared(self, prep, report):
            if self.prog.job_id == crash_job:
                if self._survived >= crash_after:
                    raise _Boom(f"injected crash before batch {prep.index}")
                self._survived += 1
            return super()._process_prepared(prep, report)

    store = _counting_store(pkg)
    meta = pkg.MetadataStore()
    store, server = _service(pkg, events, overlap=True, store=store,
                             meta=meta)
    with monkeypatch.context() as m:
        m.setattr(pkg.server_mod, "StreamingCoordinator", Crashing)
        with pytest.raises(_Boom):
            while server.step():
                pass
            server.run_until_complete()
    del server                                   # the crash
    _, server2 = _service(pkg, events, overlap=True, store=store, meta=meta,
                          resume=True)
    states = server2.run_until_complete()
    sinks = {name: _sink_bytes(store, name, f"ov-{name}")
             for name, _ in _TENANTS}
    for name, _ in _TENANTS:
        for key in sinks[name]:
            assert store.put_counts[f"tenants/{name}/{key}"] == 1, key
    return states, sinks


@pytest.mark.parametrize("seed,crash_after", [(0, 0), (4, 3), (5, 5)])
def test_crash_mid_overlap_reattaches_exactly_once(seed, crash_after,
                                                   monkeypatch):
    """Kill the server while the overlapped drive is in flight (one
    tenant's coordinator raises; the others' prefetch lanes hold prepared
    batches), re-attach every job on a fresh server: every sink converges
    to the standalone run, each window object written once."""
    events = _events(n=700, seed=seed)
    crash_job = f"ov-{_TENANTS[seed % len(_TENANTS)][0]}"
    states, sinks = _both(_crash_mid_overlap, events, crash_job,
                          crash_after, monkeypatch)
    assert set(states.values()) == {"DONE"}
    for name, agg in _TENANTS:
        assert sinks[name] == _standalone(PORT, events, f"ov-{name}",
                                          agg=agg, checkpoint_interval=2)


def test_overlapped_drive_prepares_off_thread_and_folds_on_the_driver(
        monkeypatch):
    """Prepare runs on each job's prefetch thread; every fold runs on the
    driver thread, in each job's batch order."""
    import threading
    events = _events(n=700, seed=9)
    main = threading.get_ident()
    where = {"prepare": set(), "fold": set()}
    order: dict = {}
    prepare = streaming.StreamingCoordinator._prepare_batch
    process = streaming.StreamingCoordinator._process_prepared

    def spy_prepare(self, batch):
        where["prepare"].add(threading.get_ident())
        return prepare(self, batch)

    def spy_process(self, prep, report):
        where["fold"].add(threading.get_ident())
        order.setdefault(self.prog.job_id, []).append(prep.index)
        return process(self, prep, report)

    monkeypatch.setattr(streaming.StreamingCoordinator, "_prepare_batch",
                        spy_prepare)
    monkeypatch.setattr(streaming.StreamingCoordinator, "_process_prepared",
                        spy_process)
    _, server = _service(PORT, events, overlap=True)
    server.run_until_complete()
    assert where["fold"] == {main}
    assert main not in where["prepare"] and where["prepare"]
    for indices in order.values():
        assert indices == list(range(len(indices)))


# ---------------------------------------------------------------------------
# ParkPolicy: wall-clock idleness + lag thresholds
# ---------------------------------------------------------------------------

def _park_policy(pkg, events, dribble1, dribble2):
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", events, segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore(), park_policy=pkg.
                           ParkPolicy(idle_seconds=0.05, max_lag=8))
    server.add_tenant("alice")
    jid = server.submit("alice", _program(pkg, "park-1",
                                          checkpoint_interval=2),
                        source_prefix="gps/")
    while server.step():
        pass
    job = server.jobs[jid]
    seen = [job.state]                  # drained, idle clock not run out
    time.sleep(0.06)
    server.step()
    seen += [job.state, server.pool.stats()["replicas"]]
    pkg.write_event_log(store, "gps/", dribble1, segment_records=64)
    server.step()                       # at or below max_lag: no wake
    seen += [job.state, server.status(jid)["lag"]]
    pkg.write_event_log(store, "gps/", dribble2, segment_records=64)
    server.step()                       # above it: a cold restore
    seen += [job.state, server.registry.record(jid)["restores"]]
    seen.append(server.run_until_complete())
    return seen, _sink_bytes(store, "alice", "park-1")


def test_park_waits_out_idle_seconds_and_max_lag_batches_dribbles():
    events = _events(n=300, seed=11, span=60.0)
    dribble1 = _events(n=5, seed=12, span=10.0, t0=60.0)
    dribble2 = _events(n=10, seed=13, span=10.0, t0=70.0)
    seen, sink = _both(_park_policy, events, dribble1, dribble2)
    assert seen == ["RUNNING", "PARKED", 0, "PARKED", 5, "RUNNING", 1,
                    {"park-1": "DONE"}]
    assert sink == _standalone(PORT, events + dribble1 + dribble2, "park-1",
                               checkpoint_interval=2)


def test_park_policy_validates_and_per_job_policy_overrides():
    with pytest.raises(ValueError, match="idle_seconds"):
        service.JobServer(core.MemoryStore(), core.MetadataStore(),
                          park_policy=service.ParkPolicy(idle_seconds=-1.0))
    with pytest.raises(ValueError, match="max_lag"):
        service.ParkPolicy(max_lag=-1).validate()
    store = core.MemoryStore()
    streaming.write_event_log(store, "gps/", _events(n=200, seed=14),
                              segment_records=64)
    server = service.JobServer(store, core.MetadataStore(),
                               park_policy=service.ParkPolicy(
                                   idle_seconds=60.0))
    server.add_tenant("alice")
    jid = server.submit("alice", _program(PORT, "park-2"),
                        source_prefix="gps/",
                        park_policy=service.ParkPolicy(idle_seconds=0.0))
    while server.step():
        pass
    server.step()
    assert server.jobs[jid].state == service.JobStatus.PARKED


# ---------------------------------------------------------------------------
# Compute metering + pool-time quotas
# ---------------------------------------------------------------------------

def _metering(pkg, events):
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", events, segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore())
    server.add_tenant("alice")
    server.add_tenant("bob")
    a = server.submit("alice", _program(pkg, "meter-a"), source_prefix="gps/")
    b = server.submit("bob", _program(pkg, "meter-b", agg="count"),
                      source_prefix="gps/")
    server.run_until_complete()
    for jid in (a, b):
        s = server.status(jid)
        rec = server.registry.record(jid)
        assert s["pool_seconds"] > 0 and s["fold_invocations"] > 0
        assert rec["pool_seconds"] == s["pool_seconds"]
        assert rec["fold_invocations"] == s["fold_invocations"]
    total = server.pool.stats()["invocations"]
    metered = sum(j.meter.invocations for j in server.jobs.values())
    assert 0 < metered <= total
    return {j: _status(server, j) for j in (a, b)}


def test_status_reports_per_job_compute_bill():
    got = _both(_metering, _events(n=400, seed=15))
    assert all(s["fold_invocations"] > 0 for s in got.values())


def _pool_quota(pkg, events):
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", events, segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore())
    server.add_tenant("rich")
    server.add_tenant("broke", quota_pool_seconds=1e-9)
    r = server.submit("rich", _program(pkg, "quota-ok"), source_prefix="gps/")
    p = server.submit("broke", _program(pkg, "quota-poor", agg="count"),
                      source_prefix="gps/")
    states = server.run_until_complete()
    error = server.jobs[p].error
    return dict(states=states, error=error.split(":")[0],
                status_error=server.status(p)["error"].split(":")[0],
                sink=_sink_bytes(store, "rich", "quota-ok"),
                r=_status(server, r))


def test_pool_time_quota_fails_only_the_offending_tenant():
    events = _events(n=400, seed=16)
    got = _both(_pool_quota, events)
    assert got["states"] == {"quota-ok": "DONE", "quota-poor": "FAILED"}
    assert got["error"] == got["status_error"] == "ComputeQuotaExceeded"
    assert got["sink"] == _standalone(PORT, events, "quota-ok")
    assert issubclass(service.ComputeQuotaExceeded, RuntimeError)


def test_kernel_failure_fails_only_that_job(monkeypatch):
    """A fold whose kernel cannot build, load or launch fails its own job
    with the error; the neighbor finishes, and nothing re-runs it.  The
    planted error is a launch-configuration error, which leaves the CUDA
    context usable; a sticky fault (an illegal address) would end every
    tenant's later launches too, and is not contained per job."""
    from repro_torch.kernels._build import KernelError
    events = _events(n=300, seed=18)
    store = core.MemoryStore()
    streaming.write_event_log(store, "gps/", events, segment_records=64)
    server = service.JobServer(store, core.MetadataStore())
    server.add_tenant("alice")
    server.add_tenant("bob")
    server.submit("alice", _program(PORT, "ok-1"), source_prefix="gps/")
    bad = _program(PORT, "bad-1", agg="count")
    calls = []

    def broken(*args, **kwargs):
        calls.append(1)
        raise KernelError("fused_fold launch failed: CUDA error 9")

    monkeypatch.setattr(bad.stages[0].sides[0].compiled, "step", broken)
    server.submit("bob", bad, source_prefix="gps/")
    states = server.run_until_complete()
    assert states == {"ok-1": "DONE", "bad-1": "FAILED"}
    assert len(calls) == 1
    assert "KernelError" in server.status("bad-1")["error"]
    assert _sink_bytes(store, "alice", "ok-1") == \
        _standalone(PORT, events, "ok-1")


def _introspection(pkg, events, interval):
    """One coordinator runs the log without a flush; a second one over the
    same store restarts from its barrier checkpoint."""
    built = _program(pkg, f"intro-{interval}",
                     checkpoint_interval=interval)
    store, meta = pkg.MemoryStore(), pkg.MetadataStore()
    src = pkg.StreamSource.from_records(events, batch_records=100)
    coord = pkg.StreamingCoordinator(store, meta, program=built)
    first = coord.run_stream(src, flush=False)
    pool = {k: v for k, v in coord.pool_stats().items()
            if k not in _TIMES}
    offset = coord.checkpointed_offset()
    again = pkg.StreamingCoordinator(store, meta, program=built)
    replayed = again.run_stream(src, announce=False, flush=False).batches
    return dict(offset=offset, pool=pool, max_lag=first.max_lag,
                replayed=replayed)


@pytest.mark.parametrize("n,interval,offset,replayed",
                         [(600, 1, 600, 0), (500, 3, 300, 2),
                          (500, 2, 400, 1), (3000, 1, 3000, 0)])
def test_checkpointed_offset_and_pool_stats_match_reference(
        n, interval, offset, replayed):
    """The coordinator's introspection the service reads: the record
    offset of the last barrier checkpoint and
    the fold pool's counters, scaled from the backlog and clamped to the
    workers (the reference's ``test_checkpointed_offset_resume``,
    ``test_stream_scales_pool_from_lag`` and
    ``test_checkpoint_interval_override_reaches_coordinator``)."""
    got = _both(_introspection, _events(n=n, seed=19), interval)
    assert got["offset"] == offset
    assert got["replayed"] == replayed
    if n == 3000:
        assert got["max_lag"] >= 10 and got["pool"]["replicas"] == W


# ---------------------------------------------------------------------------
# Partitioned shared ingest (tests/test_ingest_partitions.py)
# ---------------------------------------------------------------------------

def _ingest(pkg, events, n_partitions, *, prefix="part/", seg=64):
    store = pkg.MemoryStore()
    pkg.write_event_log(store, prefix, events, segment_records=seg)
    ing = pkg.SharedIngest(pkg.EventBus(), store, prefix,
                           n_partitions=n_partitions)
    ing.pump()
    return ing


def _widths(ing):
    return [ing.bus.end_offset(ing.topic, p) for p in range(ing.n_partitions)]


def _partition_views(pkg, events):
    one = _ingest(pkg, events, 1)
    four = _ingest(pkg, events, 4)
    three = _ingest(pkg, events, 3)
    left = four.subscribe("left", partitions=[0, 1])
    right = four.subscribe("right", partitions=[2, 3])
    cursors = [three.partition_cursors(c) for c in (0, 1, 64, 200, 257)]
    tail = []
    cur = three.partition_cursors(100)
    for p in range(3):
        for rec in three.bus.fetch(three.topic, p, cur[p]):
            tail.append(tuple(rec.value.data["record"]))
    for bad in ([7], []):
        with pytest.raises(ValueError):
            four.subscribe(f"bad{bad}", partitions=bad)
    return dict(
        one=list(one.records_from(0)),
        four={off: list(four.records_from(off))
              for off in (0, 1, 99, 250, len(events))},
        widths=_widths(four), cursors=cursors, tail=sorted(tail),
        left=list(left._events_from(0)), right=list(right._events_from(0)),
        lags=(left.lag(0), right.lag(0)),
        batch_sizes=(left.batch_sizes(0), right.batch_sizes(10)))


def test_partitioned_views_cursors_and_subsets_match_reference():
    events = _events(n=300, seed=1)
    got = _both(_partition_views, events)
    assert got["one"] == events
    for off, recs in got["four"].items():
        assert recs == events[off:]
    assert sum(got["widths"]) == len(events)
    assert sum(1 for w in got["widths"] if w) > 1
    for c, cur in zip((0, 1, 64, 200, 257), got["cursors"]):
        assert sum(cur.values()) == c
    assert got["tail"] == sorted(tuple(e) for e in events[100:])
    assert sorted(got["left"] + got["right"]) == sorted(events)
    assert sum(got["lags"]) == len(events)


def _hot_key(pkg, events):
    ing = _ingest(pkg, events, 4)
    store = pkg.MemoryStore()
    pkg.write_event_log(store, "gps/", events, segment_records=64)
    server = pkg.JobServer(store, pkg.MetadataStore(), ingest_partitions=4)
    server.add_tenant("alice")
    jid = server.submit("alice", _program(pkg, "skew-p"),
                        source_prefix="gps/")
    return dict(widths=_widths(ing), cur=ing.partition_cursors(123),
                recs=list(ing.records_from(0)),
                states=server.run_until_complete(),
                sink=_sink_bytes(store, "alice", jid))


def test_partition_skewed_traffic_single_hot_key():
    events = [(float(t), "hot", float(v % 9))
              for t, v in zip(np.linspace(0, 100, 300), range(300))]
    got = _both(_hot_key, events)
    assert sorted(got["widths"])[-1] == len(events)
    assert sum(got["cur"].values()) == 123 == max(got["cur"].values())
    assert got["recs"] == events
    assert got["states"] == {"skew-p": "DONE"}
    assert got["sink"] == _standalone(PORT, events, "skew-p")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _tenants_on(device, events):
    store = core.MemoryStore()
    streaming.write_event_log(store, "gps/", events, segment_records=128)
    server = service.JobServer(store, core.MetadataStore(),
                               park_policy=service.ParkPolicy(
                                   idle_seconds=0.0))
    for name, agg in (("alice", "sum"), ("bob", "mean")):
        server.add_tenant(name)
        server.submit(name, _program(PORT, f"dev-{name}", agg=agg,
                                     device=device),
                      source_prefix="gps/")
    states = server.run_until_complete()
    return states, {name: _sink_bytes(store, name, f"dev-{name}")
                    for name in ("alice", "bob")}


@pytest.mark.cuda
def test_card_tenants_equal_the_same_jobs_on_the_cpu(cuda_device):
    """Two tenants built for the card fold through the fused_fold kernel
    and give the sinks the same jobs give on the CPU."""
    events = _events(n=2000, n_keys=12, seed=21)
    before = fold_ops.fold.launches
    states, sinks = _tenants_on(cuda_device, events)
    assert fold_ops.fold.launches > before
    assert set(states.values()) == {"DONE"}
    assert (states, sinks) == _tenants_on("cpu", events)
    assert all(sinks.values())


@pytest.mark.cuda
def test_card_park_and_restore_give_back_the_exact_carry(cuda_device):
    """Parking checkpoints the carry from the card into the store; the
    cold restore puts the same bits back on the card."""
    events = _events(n=800, n_keys=12, seed=22, span=300.0)
    store = core.MemoryStore()
    streaming.write_event_log(store, "gps/", events, segment_records=128)
    server = service.JobServer(store, core.MetadataStore(),
                               park_policy=service.ParkPolicy(
                                   idle_seconds=0.0))
    server.add_tenant("alice")
    jid = server.submit("alice", _program(PORT, "carry-1", agg="mean",
                                          checkpoint_interval=1000,
                                          device=cuda_device),
                        source_prefix="gps/")
    server.step()
    job = server.jobs[jid]
    carry = job.coord.stages[0].carry.clone()
    assert carry.device.type == torch.device(cuda_device).type
    assert carry.abs().sum() > 0
    server.step()
    assert job.state == "PARKED" and job.coord is None
    server._restore(job, verb="restored")
    restored = job.coord.stages[0].carry
    assert restored.device == carry.device
    assert torch.equal(restored, carry)
    assert server.run_until_complete() == {jid: "DONE"}
    assert _sink_bytes(store, "alice", "carry-1") == \
        _standalone(PORT, events, "carry-1", agg="mean",
                    checkpoint_interval=1000)
