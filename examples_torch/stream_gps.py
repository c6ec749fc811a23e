"""Streaming logistics on the port's Pipeline API: windowed per-region GPS
aggregates, end to end — one declarative definition, flipped between
streaming and batch execution, folded on the card by ``fused_fold``.

The paper's motivating workload — continuous GPS/IoT event streams from a
logistics fleet — authored once as a dataflow graph: event log → key_by
region → 1-minute tumbling windows → mean speed.  The same built pipeline
then runs (1) continuously through the streaming micro-batch engine
(replayable event log, watermark finalization, lag-driven pool scaling)
and (2) as a one-shot batch drive over the same prefix, and the emitted
windows are asserted byte-identical.  A second graph sessionizes each
vehicle's pings into trips (``Windowing.session``) — the data-dependent
window variant.

    PYTHONPATH=src python examples_torch/stream_gps.py
    STREAM_GPS_DURATION=120 PYTHONPATH=src python examples_torch/stream_gps.py  # CI cap
    PYTHONPATH=src python examples_torch/stream_gps.py --device cpu  # plain versions
"""

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from repro_torch.core import MemoryStore
from repro_torch.core.events import EventBus, TOPIC_STREAM_WINDOW
from repro_torch.pipeline import Pipeline, RunOptions, Windowing
from repro_torch.streaming import write_event_log

REGIONS = ["north", "south", "east", "west", "centre", "port", "depot", "hub"]
WINDOW = 60.0          # 1-minute tumbling windows
RATE = 40.0            # events per second of event time
DURATION = float(os.environ.get("STREAM_GPS_DURATION", 600.0))


def synth_gps_events(seed: int = 0):
    """A fleet's GPS pings: (event_time, region, speed_kmh), mildly
    out-of-order like real device uploads."""
    rng = np.random.default_rng(seed)
    n = int(RATE * DURATION)
    ts = np.sort(rng.uniform(0, DURATION, n))
    ts = ts + rng.normal(0, 0.5, n)          # upload jitter → out-of-order
    ts = np.clip(ts, 0, None)
    regions = rng.integers(0, len(REGIONS), n)
    speeds = rng.integers(5, 110, n).astype(float)
    return [(float(t), REGIONS[r], float(s))
            for t, r, s in zip(ts, regions, speeds)]


def fleet_pipeline():
    """The demo's main program: mean speed per region per minute."""
    return (Pipeline.from_source(prefix="streams/gps", batch_records=2048)
            .key_by(lambda r: r[1])
            .window(Windowing.tumbling(WINDOW))
            .reduce("mean")
            .sink("stream-output/"))


def trips_pipeline(trips):
    """Each vehicle's pings split into trips by a 30 s inactivity gap."""
    return (Pipeline.from_source(records=trips, batch_records=512)
            .key_by()
            .window(Windowing.session(gap=30.0))
            .reduce("mean"))


def build_pipelines():
    """Planlint hook (``python -m repro_torch.analysis.planlint``): the
    example's programs, built as the demo builds them (the session job
    with stub records — sources do not affect the plan), for the CPU
    (nor does the device)."""
    return {
        "gps-fleet": fleet_pipeline().build(
            num_buckets=8, n_workers=4, allowed_lateness=5.0,
            job_id="gps-fleet", device="cpu"),
        "gps-trips": trips_pipeline([]).build(
            num_buckets=8, n_workers=4, n_slots=4, job_id="gps-trips",
            device="cpu"),
    }


def main(argv=None) -> dict:
    """Run the demo; returns the streaming run's sink objects."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    events = synth_gps_events()

    # 1. producers append to the replayable event log (the Kafka stand-in)
    store = MemoryStore()
    n = write_event_log(store, "streams/gps", events, segment_records=4096)
    print(f"event log: {n} GPS pings, "
          f"{len(store.list_objects('streams/gps'))} segments")

    # 2. ONE definition: mean speed per region per 1-minute window
    built = fleet_pipeline().build(num_buckets=8, n_workers=4,
                                   allowed_lateness=5.0, job_id="gps-fleet",
                                   device=args.device)

    # 2a. streaming mode through the one front door: the graph's bound
    # source is a log prefix, so run() dispatches to the streaming
    # coordinator — here with the pipelined scheduler's knobs spelled out
    # (all on by default: prefetch + host-prepare the next micro-batch
    # while the device folds this one, drain stats and sink writes at the
    # batch barrier)
    bus = EventBus()
    report = built.run(store=store, bus=bus,
                       options=RunOptions(overlap=True, prefetch_batches=2,
                                          sink_batching=True))
    print(f"stream {built.job_id}: {report.batches} micro-batches, "
          f"{report.records_in} records in {report.wall_time:.3f}s "
          f"({report.records_per_sec:,.0f} rec/s)")
    print(f"  windows emitted: {report.windows_emitted}, "
          f"late dropped: {report.late_dropped}, "
          f"mean batch latency: {report.mean_batch_latency * 1e3:.2f} ms")
    print(f"  close→emit latency: p50 {report.p50_emit_latency * 1e3:.2f} ms, "
          f"p99 {report.p99_emit_latency * 1e3:.2f} ms")
    print(f"  backpressure: max lag {report.max_lag}, "
          f"{report.scale_events} scale events")

    # 2b. batch mode: the SAME built pipeline, one drive over the prefix
    # (mode= pins the dispatch; a log-bound graph would otherwise stream)
    batch_store = MemoryStore()
    for m in store.list_objects("streams/gps"):
        batch_store.put(m.key, store.get(m.key))
    batch_out, _ = built.run(store=batch_store, mode="batch")
    stream_out = {m.key: store.get(m.key)
                  for m in store.list_objects("stream-output/gps-fleet/")}
    assert stream_out and stream_out == batch_out
    print(f"  batch flip: {len(batch_out)} windows, byte-identical to the "
          f"streaming run ✓")

    # 3. downstream consumers see finalized windows as CloudEvents
    recs = bus.poll("dashboard", TOPIC_STREAM_WINDOW, timeout=0.1,
                    max_records=64)
    print(f"  {len(recs)} window-finalized events on the bus; first: "
          f"{recs[0].value.data['output_key']}")

    # 4. agreement with a host-side oracle over the same log
    batch: dict[int, dict[str, list[float]]] = defaultdict(
        lambda: defaultdict(list))
    for ts, region, speed in events:
        batch[int(ts // WINDOW)][region].append(speed)
    worst = 0.0
    checked = 0
    for widx, per_region in batch.items():
        key = (f"stream-output/gps-fleet/"
               f"window-{widx * WINDOW:.3f}-{(widx + 1) * WINDOW:.3f}")
        got = dict(json.loads(line) for line in store.get(key).splitlines())
        for region, speeds in per_region.items():
            want = sum(speeds) / len(speeds)
            worst = max(worst, abs(got[region] - want))
            checked += 1
    assert worst < 1e-3, worst
    print(f"  incremental == oracle on {checked} (window, region) "
          f"aggregates (max |Δ| = {worst:.2e}) ✓")

    # 5. sessionized GPS traces: each vehicle's pings split into trips by
    # a 30s inactivity gap — the data-dependent window variant
    rng = np.random.default_rng(1)
    trips = []
    for v in range(6):
        t = float(rng.uniform(0, 30.0))
        while t < DURATION:
            for _ in range(int(rng.integers(5, 20))):    # one trip's pings
                trips.append((t, f"vehicle-{v}", float(rng.integers(5, 110))))
                t += float(rng.uniform(0.5, 8.0))
            t += float(rng.uniform(60.0, 180.0))         # parked > gap
    trips.sort()
    outs, srep = trips_pipeline(trips).build(
        num_buckets=8, n_workers=4, n_slots=4, job_id="gps-trips",
        device=args.device).run(store=store)
    print(f"  sessionized trips: {srep.windows_emitted} trips from "
          f"{len(trips)} pings across 6 vehicles "
          f"(e.g. {sorted(outs)[0].rsplit('/', 1)[1]})")
    return stream_out


if __name__ == "__main__":
    main()
