"""Replayable event-log source — the Kafka-topic stand-in for streams.

A stream is a sequence of ``(event_time, key, value)`` records persisted as
JSON-lines *segment* objects under an object-store prefix (append-only, like
a Kafka partition's segment files).  ``StreamSource`` reads the log in key
order and chunks it into bounded micro-batches; because segments are
immutable, iteration is replayable from the start — the property worker
restarts and exactly-once-ish reprocessing rely on, same as the batch
engine's idempotent spills.

Producers call ``write_event_log`` (or ``StreamSource.from_records`` for
in-memory tests/benchmarks, which skips storage entirely).
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass
from typing import Any, Iterable, Iterator

from ..core.storage import ObjectStore


def write_event_log(store: ObjectStore, prefix: str,
                    events: Iterable[tuple[float, Any, float]],
                    segment_records: int = 4096) -> int:
    """Append events to the log as numbered JSON-lines segment objects.
    Returns the number of records written."""
    existing = len(store.list_objects(prefix.rstrip("/") + "/segment-"))
    buf = io.BytesIO()
    n_seg, n_rec, in_seg = existing, 0, 0

    def flush() -> None:
        nonlocal n_seg, in_seg
        if in_seg:
            # record count travels in the key (-nNNN) so readers can skip
            # or size segments without downloading them
            key = f"{prefix.rstrip('/')}/segment-{n_seg:06d}-n{in_seg}"
            store.put(key, buf.getvalue())
            n_seg += 1
            in_seg = 0
            buf.seek(0)
            buf.truncate()

    for ts, key, value in events:
        buf.write(json.dumps([ts, key, value],
                             separators=(",", ":")).encode())
        buf.write(b"\n")
        n_rec += 1
        in_seg += 1
        if in_seg >= segment_records:
            flush()
    flush()
    return n_rec


@dataclass
class MicroBatch:
    """A bounded chunk of the stream: the unit one incremental round folds."""

    index: int
    records: list  # of (event_time, key, value)

    @property
    def max_event_time(self) -> float:
        return max(r[0] for r in self.records)

    @property
    def min_event_time(self) -> float:
        return min(r[0] for r in self.records)

    def __len__(self) -> int:
        return len(self.records)


class StreamSource:
    """Chunk a persisted (or in-memory) event log into micro-batches."""

    def __init__(self, store: ObjectStore | None = None, prefix: str = "",
                 records: Iterable[tuple[float, Any, float]] | None = None,
                 batch_records: int = 1024) -> None:
        if (store is None) == (records is None):
            raise ValueError("pass exactly one of (store+prefix, records)")
        if batch_records < 1:
            raise ValueError("batch_records must be >= 1")
        self.store = store
        self.prefix = prefix
        self._records = list(records) if records is not None else None
        self.batch_records = batch_records

    @classmethod
    def from_records(cls, records: Iterable[tuple[float, Any, float]],
                     batch_records: int = 1024) -> "StreamSource":
        return cls(records=records, batch_records=batch_records)

    # -- reading ---------------------------------------------------------------
    def segments(self) -> list[str]:
        assert self.store is not None
        prefix = self.prefix.rstrip("/") + "/segment-"
        return sorted(m.key for m in self.store.list_objects(prefix))

    @staticmethod
    def _segment_count(key: str) -> int | None:
        """Record count embedded in the segment key (-nNNN suffix), or None
        for legacy keys that need a download to count."""
        tail = key.rsplit("-", 1)[-1]
        if tail.startswith("n") and tail[1:].isdigit():
            return int(tail[1:])
        return None

    def _events_from(self, skip: int) -> Iterator[tuple[float, Any, float]]:
        """Records in log order, skipping the first ``skip`` cheaply:
        store-backed logs drop whole already-consumed segments by their
        key-embedded record counts, without downloading them."""
        if self._records is not None:
            yield from self._records[skip:]
            return
        for seg in self.segments():
            count = self._segment_count(seg)
            if count is not None and skip >= count:
                skip -= count
                continue
            lines = [ln for ln in self.store.get(seg).splitlines() if ln]
            if skip >= len(lines):
                skip -= len(lines)
                continue
            for line in lines[skip:]:
                ts, key, value = json.loads(line)
                yield float(ts), key, float(value)
            skip = 0

    def events(self) -> Iterator[tuple[float, Any, float]]:
        """Every record in log order — a fresh, replayable pass."""
        return self._events_from(0)

    def events_from(self, skip: int) -> Iterator[tuple[float, Any, float]]:
        """Records from offset ``skip`` on, skipping consumed segments
        without downloading them — the shared-ingest pump's tail read."""
        return self._events_from(skip)

    def batch_sizes(self, start_record: int = 0) -> list[int]:
        """Per-batch record counts from metadata alone — key-embedded
        segment counts when available, a line count otherwise.  Lets a
        producer announce batch triggers without parsing (or, for counted
        segments, even downloading) the payloads a second time."""
        if self._records is not None:
            total = len(self._records)
        else:
            total = 0
            for seg in self.segments():
                count = self._segment_count(seg)
                if count is None:
                    count = len([ln for ln in self.store.get(seg).splitlines()
                                 if ln])
                total += count
        total = max(0, total - start_record)
        sizes = []
        while total > 0:
            sizes.append(min(total, self.batch_records))
            total -= sizes[-1]
        return sizes

    def batches(self, start_record: int = 0) -> Iterator[MicroBatch]:
        """Chunk the log from record ``start_record`` onward into
        micro-batches of ``batch_records``.

        Resume is record-addressed, not batch-addressed: a restarted
        StreamingCoordinator passes its checkpointed *record* offset, so
        chunk boundaries cannot drift when the log has grown past a
        previously-partial final batch.  Batch indices restart at 0 for each
        iteration — they identify batches within one run.
        """
        chunk: list = []
        index = 0
        for rec in self._events_from(start_record):
            chunk.append(rec)
            if len(chunk) >= self.batch_records:
                yield MicroBatch(index, chunk)
                index += 1
                chunk = []
        if chunk:
            yield MicroBatch(index, chunk)
