"""The paper's worker components: Mapper, Reducer, Finalizer (§III-A.3–5).

These are the *host-side, paper-faithful* implementations — stateless
functions of (job config, metadata store, object store) that could each run in
a separate container, communicate only through storage/metadata, and report
back to the Coordinator over the status topic.  The port's array pipeline
(``repro_torch.pipeline``, its combiner the ``hash_combine`` kernel on the
card) computes the same word count on the device; tests check the two agree.

Record wire format for intermediate data: one JSON array per line,
``[key, value]`` — text-sortable by serialized key, which is what makes the
Mapper's sorted spills merge-able with a plain k-way merge in the Reducer.
The streaming coordinator writes its finalized windows with the same
``_encode_records``, so sink objects compare byte for byte across the two
packages.

Every worker returns a ``PhaseTimes`` breakdown (downloading / processing /
uploading) — the quantities behind the paper's Fig. 8.
"""

from __future__ import annotations

import heapq
import io
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

from .job import JobConfig, load_udf
from .metadata import MetadataStore, stage_done_counter, task_status_key
from .splitter import fetch_split
from .storage import MultipartWriter, ObjectStore, parse_spill_key, spill_key


@dataclass
class PhaseTimes:
    downloading: float = 0.0
    processing: float = 0.0
    uploading: float = 0.0
    records_in: int = 0
    records_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    spills: int = 0

    @property
    def total(self) -> float:
        return self.downloading + self.processing + self.uploading

    def as_dict(self) -> dict[str, float]:
        return {
            "downloading": self.downloading, "processing": self.processing,
            "uploading": self.uploading, "total": self.total,
            "records_in": self.records_in, "records_out": self.records_out,
            "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
            "spills": self.spills,
        }


def _encode_records(records: list[tuple[str, Any]]) -> bytes:
    out = io.BytesIO()
    for k, v in records:
        out.write(json.dumps([k, v], separators=(",", ":")).encode())
        out.write(b"\n")
    return out.getvalue()


def _decode_records(blob: bytes) -> Iterator[tuple[str, Any]]:
    for line in blob.splitlines():
        if line:
            k, v = json.loads(line)
            yield k, v


def _hash_partition(key: str, n_reducers: int) -> int:
    """hash(key) % R — must be stable across processes (FNV-1a, not hash())."""
    h = 0xCBF29CE484222325
    for b in key.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h % n_reducers


def _combine(records: list[tuple[str, Any]],
             combiner: Callable | None) -> list[tuple[str, Any]]:
    """Sort by key, then locally reduce adjacent groups (the combiner)."""
    records.sort(key=lambda kv: kv[0])
    if combiner is None:
        return records
    out: list[tuple[str, Any]] = []
    i = 0
    while i < len(records):
        j = i
        key = records[i][0]
        while j < len(records) and records[j][0] == key:
            j += 1
        if j - i == 1:
            out.append(records[i])
        else:
            out.append(tuple(combiner(key, [v for _, v in records[i:j]])))
        i = j
    return out


# ---------------------------------------------------------------------------
# Mapper (§III-A.3)
# ---------------------------------------------------------------------------

def run_mapper(cfg: JobConfig, mapper_id: int, store: ObjectStore,
               meta: MetadataStore) -> PhaseTimes:
    """Fetch assigned chunks, run the map UDF, sort+combine buffered records,
    hash-partition and spill to storage.  Stateless: everything it needs is in
    metadata (byte ranges) and storage (input bytes)."""
    times = PhaseTimes()
    map_fn = load_udf(cfg.mapper_src)
    combine_fn = None
    if cfg.run_combiner:
        combine_fn = load_udf(cfg.combiner_src or cfg.reducer_src) \
            if (cfg.combiner_src or cfg.reducer_src) else None

    n_part = max(1, cfg.n_reducers)
    buffers: list[list[tuple[str, Any]]] = [[] for _ in range(n_part)]
    buffered_bytes = 0
    spill_counts = [0] * n_part
    spill_limit = cfg.output_buffer_bytes * cfg.spill_threshold

    def spill(partition: int) -> None:
        nonlocal buffered_bytes
        records = buffers[partition]
        if not records:
            return
        t0 = time.perf_counter()
        records = _combine(records, combine_fn)  # sorted (+ combined) spill
        times.processing += time.perf_counter() - t0
        blob = _encode_records(records)
        t0 = time.perf_counter()
        key = spill_key(cfg.job_id, partition, spill_counts[partition], mapper_id)
        if len(blob) > cfg.multipart_bytes:
            w = MultipartWriter(part_size=cfg.multipart_bytes)
            w.write(blob)
            store.multipart_upload(key, w.finish(), part_size=cfg.multipart_bytes)
        else:
            store.put(key, blob)
        times.uploading += time.perf_counter() - t0
        times.bytes_out += len(blob)
        times.records_out += len(records)
        times.spills += 1
        spill_counts[partition] += 1
        buffered_bytes -= sum(len(k) + 16 for k, _ in buffers[partition])
        buffers[partition] = []

    def spill_all() -> None:
        for p in range(n_part):
            spill(p)

    for r in fetch_split(meta, cfg.job_id, mapper_id):
        # download the assigned byte range in input-buffer-sized pieces
        lo = r.lo
        while lo < r.hi:
            hi = min(lo + cfg.input_buffer_bytes, r.hi)
            t0 = time.perf_counter()
            chunk = store.get(r.key, (lo, hi))
            times.downloading += time.perf_counter() - t0
            times.bytes_in += len(chunk)
            lo = hi
            t0 = time.perf_counter()
            payload = chunk if cfg.binary_input else chunk.decode("utf-8", "replace")
            for k, v in map_fn(r.key, payload):
                k = str(k)
                p = _hash_partition(k, n_part)
                buffers[p].append((k, v))
                buffered_bytes += len(k) + 16
                times.records_in += 1
            times.processing += time.perf_counter() - t0
            if buffered_bytes >= spill_limit:
                spill_all()
    spill_all()

    meta.set(task_status_key(cfg.job_id, "mapper", mapper_id),
             {"status": "done", **times.as_dict()})
    meta.incr(stage_done_counter(cfg.job_id, "mapper"))
    return times


# ---------------------------------------------------------------------------
# Reducer (§III-A.4)
# ---------------------------------------------------------------------------

def _merge_runs(runs: list[list[tuple[str, Any]]],
                fan_in: int) -> Iterator[tuple[str, Any]]:
    """k-way merge of sorted runs, multi-pass if runs exceed the fan-in."""
    while len(runs) > fan_in:
        merged = list(heapq.merge(*runs[:fan_in], key=lambda kv: kv[0]))
        runs = [merged] + runs[fan_in:]
    return heapq.merge(*runs, key=lambda kv: kv[0])


def _group_reduce(stream: Iterable[tuple[str, Any]],
                  reduce_fn: Callable) -> Iterator[tuple[str, Any]]:
    """Apply the reduce UDF per key group of a key-sorted stream — 'for each
    key, all values are processed before moving to the next' (§III-A.4)."""
    cur_key: str | None = None
    cur_vals: list[Any] = []
    for k, v in stream:
        if k != cur_key:
            if cur_key is not None:
                yield tuple(reduce_fn(cur_key, cur_vals))
            cur_key, cur_vals = k, [v]
        else:
            cur_vals.append(v)
    if cur_key is not None:
        yield tuple(reduce_fn(cur_key, cur_vals))


def reducer_output_key(cfg: JobConfig, reducer_id: int) -> str:
    return f"{cfg.output_prefix.rstrip('/')}/{cfg.job_id}/part-{reducer_id:05d}"


def run_reducer(cfg: JobConfig, reducer_id: int, store: ObjectStore,
                meta: MetadataStore) -> PhaseTimes:
    times = PhaseTimes()
    reduce_fn = load_udf(cfg.reducer_src)

    # find assigned spill files by name (format spill-reducer_id-idx-mapper_id)
    prefix = f"jobs/{cfg.job_id}/intermediate/spill-{reducer_id}-"
    spill_objs = [m for m in store.list_objects(prefix)
                  if parse_spill_key(m.key)[0] == reducer_id]

    runs: list[list[tuple[str, Any]]] = []
    for obj in spill_objs:
        t0 = time.perf_counter()
        blob = store.get(obj.key)
        times.downloading += time.perf_counter() - t0
        times.bytes_in += len(blob)
        run = list(_decode_records(blob))
        times.records_in += len(run)
        runs.append(run)

    t0 = time.perf_counter()
    merged = _merge_runs(runs, cfg.merge_fan_in)
    results = list(_group_reduce(merged, reduce_fn))
    times.processing += time.perf_counter() - t0
    times.records_out = len(results)

    blob = _encode_records(results)
    t0 = time.perf_counter()
    store.put(reducer_output_key(cfg, reducer_id), blob)
    times.uploading += time.perf_counter() - t0
    times.bytes_out += len(blob)

    meta.set(task_status_key(cfg.job_id, "reducer", reducer_id),
             {"status": "done", **times.as_dict()})
    meta.incr(stage_done_counter(cfg.job_id, "reducer"))
    return times


# ---------------------------------------------------------------------------
# Finalizer (§III-A.5)
# ---------------------------------------------------------------------------

def final_output_key(cfg: JobConfig) -> str:
    return f"{cfg.output_prefix.rstrip('/')}/{cfg.job_id}/final"


def run_finalizer(cfg: JobConfig, store: ObjectStore,
                  meta: MetadataStore) -> PhaseTimes:
    """Stream the Reducer outputs into a single object — S3 does not support
    updates, so the Finalizer reads each part and writes one combined file."""
    times = PhaseTimes()
    keys = [reducer_output_key(cfg, r) for r in range(cfg.n_reducers)]
    keys = [k for k in keys if store.exists(k)]
    t0 = time.perf_counter()
    n = store.stream_concat(final_output_key(cfg), keys)
    dt = time.perf_counter() - t0
    # stream_concat interleaves read/write; attribute half to each phase
    times.downloading += dt / 2
    times.uploading += dt / 2
    times.bytes_in += n
    times.bytes_out += n
    meta.set(task_status_key(cfg.job_id, "finalizer", 0),
             {"status": "done", **times.as_dict()})
    meta.incr(stage_done_counter(cfg.job_id, "finalizer"))
    return times


def read_final_output(cfg: JobConfig, store: ObjectStore) -> dict[str, Any]:
    """Convenience for tests: parse the final object back into a dict."""
    blob = store.get(final_output_key(cfg))
    return dict(_decode_records(blob))
