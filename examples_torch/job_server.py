"""Multi-tenant job service on the port: two tenants, one shared GPS
ingest, and a scale-to-zero round trip — every tenant's carry on the card,
folded by ``fused_fold``.

The paper's platform shape — many jobs from many teams against one
serverless deployment — on the repo's job server: a fleet-operations
tenant (mean speed per region per minute) and a billing tenant (ping
counts per region) both subscribe to the SAME physical GPS log.  The
server materializes the log once onto a bus topic and fans it out through
per-subscriber replay cursors, so adding the second tenant adds zero
object-store reads.  When the stream goes quiet both jobs park: state
checkpointed at a micro-batch barrier, coordinators dropped, worker pool
scaled to zero.  The next batch of pings cold-restores them (latency
recorded — the serverless trade) and every sink ends byte-identical to
the tenant running alone on a private deployment.

    PYTHONPATH=src python examples_torch/job_server.py
    JOB_SERVER_DURATION=120 PYTHONPATH=src python examples_torch/job_server.py  # CI cap
    PYTHONPATH=src python examples_torch/job_server.py --device cpu  # plain versions
"""

import argparse
import os
import warnings

import numpy as np

from repro_torch.analysis import PlanLintWarning
from repro_torch.core import JobServiceClient, MemoryStore, MetadataStore
from repro_torch.launch.serve import JobRPC
from repro_torch.pipeline import Pipeline, Windowing
from repro_torch.service import JobServer, JobStatus, ParkPolicy
from repro_torch.streaming import (StreamSource, StreamingCoordinator,
                                   write_event_log)

REGIONS = ["north", "south", "east", "west", "centre", "port", "depot", "hub"]
WINDOW = 60.0          # 1-minute tumbling windows
RATE = 40.0            # events per second of event time
DURATION = float(os.environ.get("JOB_SERVER_DURATION", 300.0))
BATCH = 1024


def synth_gps_events(seed: int = 0):
    """A fleet's GPS pings: (event_time, region, speed_kmh) — in arrival
    order (the shared log is totally ordered; every subscriber replays
    the same sequence)."""
    rng = np.random.default_rng(seed)
    n = int(RATE * DURATION)
    ts = np.sort(rng.uniform(0, DURATION, n))
    regions = rng.integers(0, len(REGIONS), n)
    speeds = rng.integers(5, 110, n).astype(float)
    return [(float(t), REGIONS[r], float(s))
            for t, r, s in zip(ts, regions, speeds)]


def tenant_program(job_id: str, agg: str, device="cuda"):
    """A tenant's program: ``agg`` of speed per region per minute."""
    return (Pipeline.from_source(batch_records=BATCH)
            .key_by(lambda r: r[1])
            .window(Windowing.tumbling(WINDOW))
            .reduce(agg)
            .sink("stream-output/")
            .build(num_buckets=8, n_workers=4, batch_records=BATCH,
                   job_id=job_id, device=device))


def rogue_program(job_id: str, device="cuda"):
    """A tenant submission planlint must reject at admission: it sinks
    under the reserved ``jobs/`` checkpoint namespace, so its restore
    scans would list the carry blob as a persisted window (PL005)."""
    return (Pipeline.from_source(batch_records=BATCH)
            .key_by(lambda r: r[1])
            .window(Windowing.tumbling(WINDOW))
            .reduce("count")
            .sink("jobs/")
            .build(num_buckets=8, n_workers=4, batch_records=BATCH,
                   job_id=job_id, device=device))


def build_pipelines():
    """Planlint hook: every program this example builds, for
    ``python -m repro_torch.analysis.planlint`` (built for the CPU: the
    device does not change the plan).  The rogue program is deliberately
    absent — it exists to be rejected, and the demo asserts that it is."""
    return {"speed-rollup": tenant_program("gps-speed", "mean", "cpu"),
            "ping-billing": tenant_program("gps-bill", "count", "cpu")}


def standalone_sink(events, job_id: str, agg: str, device="cuda"):
    """Ground truth: the same program on a private single-tenant store."""
    store = MemoryStore()
    coord = StreamingCoordinator(store, MetadataStore(),
                                 program=tenant_program(job_id, agg, device))
    coord.run_stream(StreamSource.from_records(events, batch_records=BATCH))
    return {m.key: store.get(m.key)
            for m in store.list_objects(f"stream-output/{job_id}/")}


def tenant_sink(store, tenant: str, job_id: str):
    ns = f"tenants/{tenant}/"
    return {m.key[len(ns):]: store.get(m.key)
            for m in store.list_objects(f"{ns}stream-output/{job_id}/")}


def main(argv=None) -> dict:
    """Run the demo; returns each tenant's sink objects by job id."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    dev = ap.parse_args(argv).device
    events = synth_gps_events()
    first, second = events[: len(events) // 2], events[len(events) // 2:]

    # 1. producers fill the shared log's first half
    store = MemoryStore()
    write_event_log(store, "streams/gps", first, segment_records=4096)

    # 2. the control plane: one server, two tenants, the RPC skeleton
    # park as soon as a drive round finds a job idle (idle_seconds=0.0)
    server = JobServer(store, MetadataStore(),
                       park_policy=ParkPolicy(idle_seconds=0.0))
    server.add_tenant("fleet-ops")
    server.add_tenant("billing")
    rpc = JobRPC(server)
    client = JobServiceClient(server)
    rpc.handle({"method": "register", "name": "speed-rollup",
                "program": tenant_program("gps-speed", "mean", dev)})
    rpc.handle({"method": "register", "name": "ping-billing",
                "program": tenant_program("gps-bill", "count", dev)})
    a = rpc.handle({"method": "submit", "tenant": "fleet-ops",
                    "program": "speed-rollup",
                    "source_prefix": "streams/gps"})["result"]
    b = rpc.handle({"method": "submit", "tenant": "billing",
                    "program": "ping-billing",
                    "source_prefix": "streams/gps"})["result"]
    print(f"submitted {a!r} (fleet-ops) and {b!r} (billing) against one "
          f"shared ingest")

    # 2b. admission control: a program that fails planlint is rejected
    # before it registers — the build already warned (PlanLintWarning),
    # and the submit fails for this tenant only
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PlanLintWarning)  # shown at submit
        rogue = rogue_program("gps-rogue", dev)
    server.add_tenant("rogue-team")
    rpc.handle({"method": "register", "name": "rogue", "program": rogue})
    rej = rpc.handle({"method": "submit", "tenant": "rogue-team",
                      "program": "rogue", "source_prefix": "streams/gps"})
    assert not rej["ok"] and "PlanRejected" in rej["error"]
    assert client.status(a)["state"] is not None     # neighbors unaffected
    print(f"rogue submit rejected by planlint: {rej['error'].split(':')[0]} "
          f"(PL005 — sink under the reserved jobs/ namespace); "
          f"other tenants unaffected")

    # 3. drive until the stream goes quiet: both jobs drain, checkpoint,
    # park — and the pool scales to zero
    while server.step():
        pass
    assert client.status(a)["state"] == JobStatus.PARKED
    assert client.status(b)["state"] == JobStatus.PARKED
    pool = server.pool.stats()
    assert pool["replicas"] == 0
    print(f"stream idle → both jobs parked, pool at {pool['replicas']} "
          f"replicas ({pool['scale_downs']} scale-downs)")

    # 4. the second half of the night's pings arrives: the next step
    # cold-restores both jobs from their checkpoints and folds the tail
    write_event_log(store, "streams/gps", second, segment_records=4096)
    states = server.run_until_complete()
    assert states == {a: JobStatus.DONE, b: JobStatus.DONE}
    for jid in (a, b):
        rec = client.status(jid)
        lat = max(server.jobs[jid].cold_start_latencies) * 1e3
        print(f"  {jid}: parks={rec['parks']} restores={rec['restores']} "
              f"cold-start {lat:.1f} ms → {rec['state']}")

    # 5. physical-once: the log was read exactly once for both tenants
    ing = server.stats()["ingests"]["streams/gps"]
    assert ing["pumped"] == len(events) and ing["subscribers"] == 2
    print(f"shared ingest: {ing['pumped']} records materialized once for "
          f"{ing['subscribers']} subscribers")

    # 6. byte parity: each tenant's sink == the same program running alone
    sinks = {"gps-speed": tenant_sink(store, "fleet-ops", "gps-speed"),
             "gps-bill": tenant_sink(store, "billing", "gps-bill")}
    assert sinks["gps-speed"] == standalone_sink(events, "gps-speed", "mean",
                                                 dev)
    assert sinks["gps-bill"] == standalone_sink(events, "gps-bill", "count",
                                                dev)
    print("sinks byte-identical to standalone single-tenant runs ✓")
    return sinks


if __name__ == "__main__":
    main()
