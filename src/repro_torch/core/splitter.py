"""Splitter — byte-range division of the input (§III-A.2).

Given S3 path prefixes the Splitter measures total input size, divides it into
``n_mappers`` equal byte ranges, and — for text input — extends each boundary
forward to the next record separator so no record is cut in half.  Binary
input splits purely on byte offsets.  The resulting ranges are written to the
metadata store so stateless Mappers can ranged-GET their chunk.

In the reference the same algorithm also shards the training corpus across
data-parallel hosts; the port's training reader waits for ROADMAP Queue A
#13f.
"""

from __future__ import annotations

from dataclasses import dataclass

from .metadata import MetadataStore, split_key
from .storage import ObjectStore


@dataclass(frozen=True)
class ByteRange:
    """A half-open byte range [lo, hi) within one object."""

    key: str
    lo: int
    hi: int

    @property
    def size(self) -> int:
        return self.hi - self.lo

    def to_meta(self) -> dict:
        return {"key": self.key, "lo": self.lo, "hi": self.hi}

    @classmethod
    def from_meta(cls, d: dict) -> "ByteRange":
        return cls(d["key"], int(d["lo"]), int(d["hi"]))


def _extend_to_separator(store: ObjectStore, key: str, pos: int, size: int,
                         sep: bytes, probe: int = 64 * 1024) -> int:
    """Move ``pos`` forward to just past the next separator (or EOF).

    Mirrors the paper: 'In case of the input being text-based, the splitter
    extends the boundaries it will split, in order to not cut any record in
    half.'  Probes in bounded ranged-GETs to avoid reading whole objects.
    """
    if pos <= 0 or pos >= size:
        return max(0, min(pos, size))
    while pos < size:
        chunk = store.get(key, (pos, min(pos + probe, size)))
        idx = chunk.find(sep)
        if idx >= 0:
            return pos + idx + len(sep)
        pos += len(chunk)
    return size


def split_object(store: ObjectStore, key: str, n_splits: int,
                 binary: bool = False, sep: bytes = b"\n") -> list[ByteRange]:
    """Split one object into ``n_splits`` contiguous byte ranges."""
    size = store.head(key).size
    if size == 0 or n_splits < 1:
        return []
    n_splits = min(n_splits, size)  # never hand out empty ranges
    raw = [round(i * size / n_splits) for i in range(n_splits + 1)]
    if binary:
        bounds = raw
    else:
        bounds = [0]
        for b in raw[1:-1]:
            adj = _extend_to_separator(store, key, b, size, sep)
            # keep bounds monotone — a long record can swallow a split
            bounds.append(max(adj, bounds[-1]))
        bounds.append(size)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            out.append(ByteRange(key, lo, hi))
    return out


def split_prefix(store: ObjectStore, prefix: str, n_mappers: int,
                 binary: bool = False, sep: bytes = b"\n") -> list[list[ByteRange]]:
    """Split everything under an S3 prefix into ``n_mappers`` assignments.

    Sizes the per-object split counts proportionally to object size so the
    payload is 'equally distributed' across Mappers (§III-A.2), then
    round-robins ranges into per-mapper lists balanced by bytes.
    """
    objs = store.list_objects(prefix)
    total = sum(m.size for m in objs)
    if total == 0:
        return [[] for _ in range(n_mappers)]
    ranges: list[ByteRange] = []
    for m in objs:
        if m.size == 0:
            continue
        # at least 1 split per object; proportional share of the mapper count
        n = max(1, round(n_mappers * m.size / total))
        ranges.extend(split_object(store, m.key, n, binary, sep))
    # greedy balance: biggest range to the lightest mapper
    assignments: list[list[ByteRange]] = [[] for _ in range(n_mappers)]
    loads = [0] * n_mappers
    for r in sorted(ranges, key=lambda r: -r.size):
        i = loads.index(min(loads))
        assignments[i].append(r)
        loads[i] += r.size
    return assignments


def publish_splits(meta: MetadataStore, job_id: str,
                   assignments: list[list[ByteRange]]) -> None:
    """Write chunk metadata to the store for Mappers to fetch (§III-A.2)."""
    for mapper_id, ranges in enumerate(assignments):
        meta.set(split_key(job_id, mapper_id),
                 [r.to_meta() for r in ranges])


def fetch_split(meta: MetadataStore, job_id: str, mapper_id: int) -> list[ByteRange]:
    raw = meta.get(split_key(job_id, mapper_id), [])
    return [ByteRange.from_meta(d) for d in raw]
