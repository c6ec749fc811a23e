"""Shared ingest — one physical log read, fanned out to every job.

When N jobs consume the same source, the naive deployment reads the
event log N times (N× the GET traffic the paper bills for).  The job
server instead materializes each source ONCE: a :class:`SharedIngest`
owns the only :class:`~repro_torch.streaming.source.StreamSource` over the
physical log and ``pump()`` appends its unread tail onto a private bus
topic (``repro.ingest.<source>``) — the "materialized intermediate
stream".  Every subscribing job reads that topic through a
:class:`SubscriberSource` with a *private record cursor* (the bus's
group-less ``fetch``), so:

* subscribers never advance each other's positions,
* a job registering late replays from offset 0 and catches up,
* a restored job resumes from its checkpointed record offset — cursor
  addressing is identical to the coordinator's record-addressed resume.

Partitioning.  The topic may carry ``n_partitions`` partitions routed
by record key (the bus's stable FNV-1a ``partition_for``), so parallel
subscribers can each drain a disjoint partition subset of one source
concurrently.  Determinism survives partitioning because every
materialized event carries its global ``seq`` (the record's index in
the physical log): a subscriber's view is the seq-sorted merge of its
assigned partitions, which is a pure function of the log — independent
of pump timing, partition interleaving, or crash/re-materialization.
A subscriber's scalar cursor counts records of *its own merged view*,
and :meth:`SharedIngest.partition_cursors` dissects that scalar into
the equivalent per-(subscriber, partition) replay cursors — the prefix
of length ``cursor`` always splits into the same per-partition
prefixes, which is what makes replay exactly-once per partition across
a crash/re-attach.
"""

from __future__ import annotations

import heapq
from itertools import islice
from typing import Iterable, Iterator, Sequence

from ..core.events import CloudEvent, EventBus, Record, ingest_topic
from ..core.storage import ObjectStore
from ..streaming.source import StreamSource

__all__ = ["SharedIngest", "SubscriberSource"]


def _record_event(source_id: str, record: tuple, seq: int) -> CloudEvent:
    """Materialized-record envelope: the ``(ts, key, value)`` triple plus
    ``seq``, the record's global index in the physical log — the anchor
    that lets any partition subset merge back into log order."""
    return CloudEvent(type="repro.ingest.record", source=source_id,
                      data={"record": list(record), "seq": seq})


def _seq(rec: Record) -> int:
    return rec.value.data["seq"]


class SharedIngest:
    """One source's single physical reader plus its materialized topic.

    ``n_partitions`` controls the materialized topic's width: 1 (the
    default) mirrors the log one-to-one; N > 1 routes records by key so
    subscribers can drain disjoint partition subsets in parallel.  Every
    subscriber view — whole topic or subset — is deterministic because
    records merge by their global ``seq``.
    """

    def __init__(self, bus: EventBus, store: ObjectStore, prefix: str, *,
                 source_id: str | None = None,
                 batch_records: int = 1024,
                 n_partitions: int = 1) -> None:
        if n_partitions < 1:
            raise ValueError("n_partitions must be >= 1")
        self.bus = bus
        self.prefix = prefix
        self.source_id = source_id or prefix.strip("/")
        self.source = StreamSource(store=store, prefix=prefix,
                                   batch_records=batch_records)
        self.topic = ingest_topic(self.source_id)
        topic = bus.create_topic(self.topic, n_partitions=n_partitions)
        # create_topic returns the existing topic if someone else made it
        # first — adopt its width so cursors stay consistent
        self.n_partitions = len(topic.partitions)
        self.pumped = 0          # records materialized so far
        self.pumps = 0           # physical tail reads taken
        self.subscribers: dict[str, "SubscriberSource"] = {}

    # -- the one physical read ----------------------------------------------
    def pump(self) -> int:
        """Materialize the log's unread tail onto the topic — the only
        place the physical log is ever read, however many jobs subscribe.
        Records are routed to partitions by record key (stable FNV-1a, so
        a crashed server re-materializes the identical layout) and carry
        their global ``seq``.  Returns new records appended."""
        n = 0
        for rec in self.source.events_from(self.pumped):
            self.bus.produce(self.topic,
                             _record_event(self.source_id, rec,
                                           self.pumped + n),
                             key=str(rec[1]))
            n += 1
        self.pumped += n
        self.pumps += 1
        return n

    # -- subscriber fan-out --------------------------------------------------
    def subscribe(self, subscriber_id: str, batch_records: int = 1024,
                  partitions: Iterable[int] | None = None,
                  ) -> "SubscriberSource":
        """A private replay cursor over the materialized stream.  Always
        starts at offset 0 — a late registrant catches up from the log's
        beginning; an already-checkpointed job resumes further in because
        the *coordinator* passes its record offset to ``batches()``.
        ``partitions`` restricts the view to a partition subset (default:
        all) so parallel subscribers can split one source between them."""
        if subscriber_id in self.subscribers:
            raise ValueError(f"subscriber {subscriber_id!r} already "
                             f"registered on {self.topic}")
        sub = SubscriberSource(self, subscriber_id,
                               batch_records=batch_records,
                               partitions=partitions)
        self.subscribers[subscriber_id] = sub
        return sub

    def _parts(self, partitions: Sequence[int] | None) -> tuple[int, ...]:
        if partitions is None:
            return tuple(range(self.n_partitions))
        return tuple(partitions)

    def end_offset(self, partitions: Sequence[int] | None = None) -> int:
        """Total materialized records across ``partitions`` (default all)
        — the length of that view's merged log."""
        return sum(self.bus.end_offset(self.topic, p)
                   for p in self._parts(partitions))

    def records_from(self, offset: int,
                     partitions: Sequence[int] | None = None,
                     ) -> Iterator[tuple]:
        """The merged ``(ts, key, value)`` view of ``partitions`` in
        global ``seq`` order, skipping its first ``offset`` records.
        Single-partition views read the partition log directly (offset ==
        partition offset); multi-partition views seq-merge — both yield
        the identical deterministic sequence for a given log."""
        parts = self._parts(partitions)
        if len(parts) == 1:
            records = iter(self.bus.fetch(self.topic, parts[0], offset))
        else:
            logs = [self.bus.fetch(self.topic, p, 0) for p in parts]
            records = islice(heapq.merge(*logs, key=_seq), offset, None)
        for rec in records:
            ts, key, value = rec.value.data["record"]
            yield (ts, key, value)

    def partition_cursors(self, cursor: int,
                          partitions: Sequence[int] | None = None,
                          ) -> dict[int, int]:
        """Dissect a subscriber's scalar cursor into per-(subscriber,
        partition) replay cursors: for each assigned partition, how many
        of its records fall inside the first ``cursor`` records of the
        merged view.  Because the merge order is a pure function of the
        log (global ``seq``), this dissection is stable across pump
        timing and crash/re-attach — replaying partition ``p`` from
        ``partition_cursors(c)[p]`` is exactly-once per partition."""
        parts = self._parts(partitions)
        cursors = {p: 0 for p in parts}
        logs = [[(_seq(r), p) for r in self.bus.fetch(self.topic, p, 0)]
                for p in parts]
        for _, p in islice(heapq.merge(*logs), cursor):
            cursors[p] += 1
        return cursors

    def lag(self, cursor: int,
            partitions: Sequence[int] | None = None) -> int:
        """Materialized records a subscriber at ``cursor`` has not yet
        consumed from its view — the unpark signal."""
        return max(0, self.end_offset(partitions) - cursor)


class SubscriberSource(StreamSource):
    """One job's view of a shared ingest: a ``StreamSource`` whose log is
    the materialized topic (or a partition subset of it), read from a
    private record cursor.

    Subclassing matters — the run-time dispatch (``BuiltPipeline.run``'s
    mode inference) and the coordinator's record-addressed ``batches(
    start_record=...)`` contract both see exactly the source type they
    already handle, so a job cannot tell whether it owns its log or
    shares it — or whether its view is the whole topic or a partition
    slice.
    """

    def __init__(self, ingest: SharedIngest, subscriber_id: str, *,
                 batch_records: int = 1024,
                 partitions: Iterable[int] | None = None) -> None:
        # deliberately not calling super().__init__: the log lives on the
        # shared topic, not in a store prefix or an in-memory record list
        if batch_records < 1:
            raise ValueError("batch_records must be >= 1")
        if partitions is None:
            parts = None
        else:
            parts = tuple(sorted(set(int(p) for p in partitions)))
            if not parts:
                raise ValueError("partitions must be non-empty when given")
            bad = [p for p in parts if not 0 <= p < ingest.n_partitions]
            if bad:
                raise ValueError(
                    f"partition(s) {bad} out of range for "
                    f"{ingest.topic} with {ingest.n_partitions} partitions")
        self.ingest = ingest
        self.subscriber_id = subscriber_id
        self.batch_records = batch_records
        self.partitions = parts
        self.store = None
        self.prefix = ingest.prefix
        self._records = None

    def _events_from(self, skip: int) -> Iterator[tuple]:
        return self.ingest.records_from(skip, self.partitions)

    def batch_sizes(self, start_record: int = 0) -> list[int]:
        total = max(0, self.ingest.end_offset(self.partitions) - start_record)
        sizes = []
        while total > 0:
            sizes.append(min(total, self.batch_records))
            total -= sizes[-1]
        return sizes

    def lag(self, cursor: int) -> int:
        """Unconsumed records in this subscriber's view — the park/unpark
        signal the job server polls."""
        return self.ingest.lag(cursor, self.partitions)

    def partition_cursors(self, cursor: int) -> dict[int, int]:
        """This subscriber's per-partition replay cursors at scalar
        position ``cursor`` (see ``SharedIngest.partition_cursors``)."""
        return self.ingest.partition_cursors(cursor, self.partitions)
