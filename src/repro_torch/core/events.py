"""Event transport — the Kafka / CloudEvents stand-in.

In the paper the Coordinator spawns workers by *producing CloudEvents to Kafka
topics*; Knative JobSinks consume them and materialize containers.  This module
keeps the same shape in-process:

  * topics with a fixed partition count; events carry key/value/timestamp/headers,
  * producers append; partition chosen by ``hash(key) % n_partitions``
    (exactly the record→partition rule Kafka uses and the paper relies on),
  * consumer groups with offset tracking — each partition is owned by at most
    one consumer of a group, replays are possible from a saved offset (this is
    what makes worker restarts exactly-once-ish in the paper's design),
  * a blocking ``poll`` so worker loops look like real consumers.

CloudEvent envelope fields follow the CloudEvents 1.0 spec attributes the
paper's Knative JobSinks consume (id, source, type, subject, data).
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any


@dataclass
class CloudEvent:
    """CloudEvents-1.0-shaped envelope."""

    type: str                      # e.g. "repro.mapper.trigger"
    source: str                    # e.g. "coordinator"
    data: dict[str, Any]
    subject: str | None = None     # e.g. "job-42/mapper-3"
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    time: float = field(default_factory=time.time)


@dataclass
class Record:
    key: str | None
    value: CloudEvent
    timestamp: float
    offset: int
    partition: int
    headers: dict[str, str] = field(default_factory=dict)


class _Partition:
    def __init__(self) -> None:
        self.log: list[Record] = []
        self.cond = threading.Condition()

    def append(self, rec: Record) -> None:
        with self.cond:
            self.log.append(rec)
            self.cond.notify_all()


class Topic:
    def __init__(self, name: str, n_partitions: int = 4) -> None:
        self.name = name
        self.partitions = [_Partition() for _ in range(n_partitions)]

    def partition_for(self, key: str | None) -> int:
        if key is None:
            return 0
        # FNV-1a over the key bytes — stable across processes (unlike hash())
        h = 0xCBF29CE484222325
        for b in key.encode():
            h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        return h % len(self.partitions)


class EventBus:
    """Broker: topics + consumer groups with offsets."""

    def __init__(self) -> None:
        self._topics: dict[str, Topic] = {}
        self._offsets: dict[tuple[str, str, int], int] = {}  # (group, topic, part)
        self._lock = threading.Lock()
        self.produced = 0  # instrumentation

    def create_topic(self, name: str, n_partitions: int = 4) -> Topic:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = Topic(name, n_partitions)
            return self._topics[name]

    def topic(self, name: str) -> Topic:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = Topic(name)
            return self._topics[name]

    # -- producer ------------------------------------------------------------
    def produce(self, topic: str, event: CloudEvent, key: str | None = None,
                headers: dict[str, str] | None = None) -> Record:
        t = self.topic(topic)
        p = t.partition_for(key)
        part = t.partitions[p]
        with part.cond:
            rec = Record(key=key, value=event, timestamp=time.time(),
                         offset=len(part.log), partition=p,
                         headers=headers or {})
            part.log.append(rec)
            part.cond.notify_all()
        self.produced += 1
        return rec

    # -- consumer ------------------------------------------------------------
    def poll(self, group: str, topic: str, timeout: float = 1.0,
             max_records: int = 64) -> list[Record]:
        """Fetch new records for a consumer group across all partitions."""
        t = self.topic(topic)
        deadline = time.time() + timeout
        out: list[Record] = []
        while not out and time.time() < deadline:
            for p_idx, part in enumerate(t.partitions):
                okey = (group, topic, p_idx)
                with self._lock:
                    off = self._offsets.get(okey, 0)
                with part.cond:
                    new = part.log[off: off + max_records]
                if new:
                    out.extend(new)
                    with self._lock:
                        self._offsets[okey] = off + len(new)
                if len(out) >= max_records:
                    break
            if not out:
                time.sleep(0.001)
        return out

    def seek(self, group: str, topic: str, partition: int, offset: int) -> None:
        """Rewind a consumer group — replay after a worker failure."""
        with self._lock:
            self._offsets[(group, topic, partition)] = offset

    def fetch(self, topic: str, partition: int = 0, offset: int = 0,
              max_records: int | None = None) -> list[Record]:
        """Group-less record-addressed read: the log from ``offset`` on.

        Consumer groups share one cursor per partition; a *subscriber*
        keeps its own.  The job server's shared-ingest fan-out reads the
        materialized stream this way — every subscriber replays from its
        private record cursor (a late registrant starts at 0 and catches
        up) without advancing anyone else's position.
        """
        t = self.topic(topic)
        part = t.partitions[partition]
        with part.cond:
            if max_records is None:
                return part.log[offset:]
            return part.log[offset: offset + max_records]

    def end_offset(self, topic: str, partition: int = 0) -> int:
        """Next offset to be written — a subscriber's lag is
        ``end_offset - cursor``."""
        t = self.topic(topic)
        part = t.partitions[partition]
        with part.cond:
            return len(part.log)

    def lag(self, group: str, topic: str) -> int:
        """Unconsumed records — the autoscaler's scaling signal (KPA uses
        concurrency; Kafka-based KEDA-style scaling uses consumer lag)."""
        t = self.topic(topic)
        total = 0
        for p_idx, part in enumerate(t.partitions):
            with self._lock:
                off = self._offsets.get((group, topic, p_idx), 0)
            total += max(0, len(part.log) - off)
        return total


# Topic names used by the framework — one per worker role, as the paper's
# Coordinator produces distinct CloudEvent types per component.
TOPIC_SPLITTER = "repro.splitter"
TOPIC_MAPPER = "repro.mapper"
TOPIC_REDUCER = "repro.reducer"
TOPIC_FINALIZER = "repro.finalizer"
TOPIC_STATUS = "repro.status"      # worker → coordinator completion callbacks

# Streaming topics: the source announces each micro-batch on STREAM_BATCH
# (the trigger the streaming loop consumes; its consumer lag is the
# backpressure/scaling signal), and the coordinator publishes every finalized
# window on STREAM_WINDOW for downstream consumers.
TOPIC_STREAM_BATCH = "repro.stream.batch"
TOPIC_STREAM_WINDOW = "repro.stream.window"

# Job-service topics: the control plane announces every lifecycle
# transition (submitted/running/parked/…) on JOB_LIFECYCLE, and each
# shared source materializes its one physical log read onto a private
# ``repro.ingest.<source>`` topic that all subscribing jobs replay from
# their own record cursors.
TOPIC_JOB_LIFECYCLE = "repro.job.lifecycle"
TOPIC_INGEST_PREFIX = "repro.ingest."


def ingest_topic(source_id: str) -> str:
    """Topic name for one shared source's materialized record stream.

    The topic may carry one partition (the default — offset equals
    record index) or N partitions keyed by record key.  Either way every
    record carries its global materialization sequence number (``seq``),
    so any subset of partitions merges back into one deterministic total
    order and replay stays exactly-once per partition — see
    ``repro.service.ingest_share``."""
    return TOPIC_INGEST_PREFIX + source_id.strip("/").replace("/", ".")

_event_counter = itertools.count()


def trigger_event(role: str, job_id: str, worker_id: int,
                  payload: dict[str, Any]) -> CloudEvent:
    return CloudEvent(
        type=f"repro.{role}.trigger",
        source="coordinator",
        subject=f"{job_id}/{role}-{worker_id}",
        data={"job_id": job_id, "worker_id": worker_id, **payload},
    )


def batch_event(job_id: str, batch_index: int, n_records: int,
                max_event_time: float | None = None) -> CloudEvent:
    """Micro-batch announcement — one per batch on TOPIC_STREAM_BATCH.
    ``max_event_time`` is None when the producer announced from record
    counts without parsing payloads."""
    return CloudEvent(
        type="repro.stream.batch.available",
        source="stream-source",
        subject=f"{job_id}/batch-{batch_index}",
        data={"job_id": job_id, "batch_index": batch_index,
              "n_records": n_records, "max_event_time": max_event_time},
    )


def window_event(job_id: str, window_start: float, window_end: float,
                 n_keys: int, output_key: str) -> CloudEvent:
    """Finalized-window emission notice on TOPIC_STREAM_WINDOW."""
    return CloudEvent(
        type="repro.stream.window.finalized",
        source="streaming-coordinator",
        subject=f"{job_id}/window-{window_start}",
        data={"job_id": job_id, "window_start": window_start,
              "window_end": window_end, "n_keys": n_keys,
              "output_key": output_key},
    )


def job_lifecycle_event(job_id: str, tenant: str, state: str,
                        info: dict[str, Any] | None = None) -> CloudEvent:
    """Control-plane transition notice on TOPIC_JOB_LIFECYCLE — the job
    server's submit/pause/park/restore audit stream."""
    return CloudEvent(
        type=f"repro.job.{state}",
        source="job-server",
        subject=f"{tenant}/{job_id}",
        data={"job_id": job_id, "tenant": tenant, "state": state,
              **(info or {})},
    )


def status_event(role: str, job_id: str, worker_id: int, status: str,
                 info: dict[str, Any] | None = None) -> CloudEvent:
    return CloudEvent(
        type=f"repro.{role}.{status}",
        source=f"{role}-{worker_id}",
        subject=f"{job_id}/{role}-{worker_id}",
        data={"job_id": job_id, "worker_id": worker_id, "status": status,
              **(info or {})},
    )
