"""Executing a built pipeline — one program, one front door, two modes.

``run(built, source_or_data, options=RunOptions(...))`` — surfaced as
``BuiltPipeline.run`` — dispatches by source kind: a
``StreamSource``/``JoinSource`` (or a pair of them) drives **streaming**
mode through the ``StreamingCoordinator`` (micro-batches, watermarks,
checkpoints, backpressure, the pipelined scheduler's prepare/fold/drain
lanes); an in-memory record list (or a join's pair of lists, or the
graph's bound ``records=``) drives **batch** mode — the same program once
over the full input, where the end-of-input flush finalizes every window
and carry handoffs ripple through the stage DAG in topological order, so
per-window output bytes equal the streaming run's on every branch.
``None`` falls back to the graph's bound source: a log prefix streams,
bound records run as one batch.  An array pipeline has one mode: its
batch plan runs once over the worker shards (``data``, or the bound
``shards=``) and returns ``(result, stats)``; under ``"shard_map"`` every
rank is given the same ``data`` and runs on its contiguous share of
axis 0 (``rank_shard``), as the reference's ``P(axis)`` placement cuts
it.

``JoinSource`` merges two event logs into one side-tagged record stream
(``(ts, key, value, side)``), in event-time order with a deterministic
left-before-right tie-break, so a two-input program — a join, even over
multi-stage sides — replays identically in both modes and across restarts
(the tag selects the record's ingestion stage via
``BuiltPipeline.inputs``).
"""

from __future__ import annotations

import dataclasses
import heapq
from itertools import islice
from typing import Iterator

from ..core.metadata import MetadataStore
from ..core.storage import MemoryStore, ObjectStore
from ..engine.stages import fold_key24
from ..streaming.coordinator import RunOptions, StreamingCoordinator
from ..streaming.source import MicroBatch, StreamSource
from .lower import BuiltPipeline, SourceSpec


class JoinSource:
    """Two event logs as one merged, side-tagged micro-batch stream."""

    def __init__(self, left: StreamSource, right: StreamSource,
                 batch_records: int) -> None:
        self.left = left
        self.right = right
        self.batch_records = batch_records

    @staticmethod
    def _tagged(src: StreamSource, side: int) -> Iterator[tuple]:
        for r in src.events():
            yield (r[0], side, r)

    def _merged(self, skip: int) -> Iterator[tuple]:
        merged = heapq.merge(self._tagged(self.left, 0),
                             self._tagged(self.right, 1),
                             key=lambda t: (t[0], t[1]))
        for _ts, side, rec in islice(merged, skip, None):
            yield (rec[0], rec[1], rec[2], side)

    def batch_sizes(self, start_record: int = 0) -> list[int]:
        """Record counts of the merged stream's micro-batches from
        ``start_record`` on."""
        total = sum(sum(src.batch_sizes()) for src in (self.left, self.right))
        total = max(0, total - start_record)
        sizes = []
        while total > 0:
            sizes.append(min(total, self.batch_records))
            total -= sizes[-1]
        return sizes

    def batches(self, start_record: int = 0) -> Iterator[MicroBatch]:
        """The merged, side-tagged stream as micro-batches, skipping the
        first ``start_record`` records (a restore's resume point)."""
        chunk: list = []
        index = 0
        for rec in self._merged(start_record):
            chunk.append(rec)
            if len(chunk) >= self.batch_records:
                yield MicroBatch(index, chunk)
                index += 1
                chunk = []
        if chunk:
            yield MicroBatch(index, chunk)


def _side_source(spec: SourceSpec, store: ObjectStore | None,
                 batch_records: int, override=None) -> StreamSource:
    if override is not None:
        if isinstance(override, StreamSource):
            return override
        return StreamSource.from_records(override,
                                         batch_records=batch_records)
    if spec.kind == "log":
        if store is None:
            raise ValueError("a log-backed pipeline needs a store")
        return StreamSource(store=store, prefix=spec.prefix,
                            batch_records=batch_records)
    if spec.kind == "records":
        return StreamSource.from_records(spec.records,
                                         batch_records=batch_records)
    raise ValueError("this pipeline's source is unbound — pass source= "
                     "(or sources= for a join) at run time")


def resolve_source(built: BuiltPipeline, store: ObjectStore | None,
                   source=None, sources=None):
    """The graph's sources (or run-time overrides) as one drivable
    micro-batch stream.  A two-input program (a join, whether its sides
    are single- or multi-stage chains) merges both logs into one
    side-tagged stream whose tag selects the record's ingestion point
    (``BuiltPipeline.inputs``)."""
    specs = [built.stages[si].sides[side].source
             for si, side in built.inputs]
    if len(specs) == 2:
        overrides = sources or (None, None)
        left = _side_source(specs[0], store, built.batch_records,
                            overrides[0])
        right = _side_source(specs[1], store, built.batch_records,
                             overrides[1])
        return JoinSource(left, right, built.batch_records)
    return _side_source(specs[0], store, built.batch_records, source)


def _resolve(built: BuiltPipeline, store, source, sources):
    """``resolve_source`` plus the one case it cannot express: an
    already-merged ``JoinSource`` passed as the single drivable source."""
    if isinstance(source, JoinSource):
        return source
    return resolve_source(built, store, source, sources)


def _infer_mode(built: BuiltPipeline, source, sources) -> str:
    """Live streams stream, in-memory records run as one batch, and
    ``None`` falls back to what the graph bound (a log prefix is an
    unbounded stream; bound records are a dataset)."""
    if isinstance(source, (StreamSource, JoinSource)):
        return "streaming"
    if sources is not None:
        return ("streaming"
                if any(isinstance(s, StreamSource)
                       for s in sources if s is not None) else "batch")
    if source is not None:
        return "batch"
    specs = [built.stages[si].sides[side].source
             for si, side in built.inputs]
    return ("streaming" if any(sp.kind == "log" for sp in specs)
            else "batch")


def _shard_source(built: BuiltPipeline, store, source, sources,
                  shard: tuple[int, int]):
    """Restrict the run to one partition of the key space (``fold_key24``
    of each record's key, so every shard agrees on the assignment), under
    a suffixed job id."""
    index, count = shard
    if len(built.inputs) != 1:
        raise ValueError("shard= currently drives single-input pipelines; "
                         "shard a join by sharding its upstream logs")
    src = _resolve(built, store, source, sources)
    recs = [r for r in src.events() if fold_key24(r[1]) % count == index]
    sharded = StreamSource.from_records(recs,
                                        batch_records=built.batch_records)
    built = dataclasses.replace(
        built, job_id=f"{built.job_id}-shard{index}of{count}")
    return built, sharded


def rank_shard(built: BuiltPipeline, data):
    """This rank's contiguous share of axis 0 of an array pipeline's
    ``data`` under ``"shard_map"`` (``len / n_workers`` rows, rank ``r``
    taking the ``r``-th); the data itself under the other backends."""
    return built.batch_plan.axis.shard(data)


def run(built: BuiltPipeline, source_or_data=None, *,
        options: RunOptions | None = None, store=None, meta=None,
        sources=None, bus=None, autoscaler=None, pool=None,
        announce: bool = True, flush: bool = True, mode: str | None = None):
    """The one front door for driving a built pipeline.

    ``source_or_data`` picks the mode (a ``StreamSource``/``JoinSource``,
    or a join's ``(left, right)`` pair with a live side, streams; a list of
    records — or a join's pair of lists — runs as one batch; ``None`` uses
    the graph's bound source); ``mode="streaming"|"batch"`` forces it.
    ``sources=(left, right)`` overrides a join's two sources.  Returns a
    ``StreamReport`` in streaming mode, ``(outputs, report)`` for a
    windowed batch run, and ``(result, stats)`` for an array pipeline.
    """
    opts = options if options is not None else RunOptions()
    opts.validate()
    if mode not in (None, "streaming", "batch"):
        raise ValueError(f"mode must be 'streaming' or 'batch', got {mode!r}")
    if built.is_array:
        if mode == "streaming":
            raise ValueError("array pipelines have no streaming mode")
        if opts.shard is not None:
            raise ValueError("shard= partitions a keyed record stream; "
                             "array pipelines shard via their input shards")
        shards = (source_or_data if source_or_data is not None
                  else built.sides[0].source.shards)
        return built.batch_plan.run(rank_shard(built, shards))

    # one positional accepts a join's (left, right) pair too
    source = None
    if source_or_data is not None:
        if (len(built.inputs) == 2 and sources is None
                and isinstance(source_or_data, (tuple, list))
                and len(source_or_data) == 2
                and all(isinstance(s, (StreamSource, list))
                        for s in source_or_data)):
            sources = tuple(source_or_data)
        else:
            source = source_or_data
    if mode is None:
        mode = _infer_mode(built, source, sources)
    if opts.shard is not None:
        built, source = _shard_source(built, store, source, sources,
                                      opts.shard)
        sources = None

    if mode == "streaming":
        store = store if store is not None else MemoryStore()
        meta = meta if meta is not None else MetadataStore()
        coord = StreamingCoordinator(store, meta, bus=bus,
                                     autoscaler=autoscaler, pool=pool,
                                     program=built, options=opts)
        return coord.run_stream(_resolve(built, store, source, sources),
                                announce=announce, flush=flush)

    # Batch: the same program, one pass, end-of-input flush; checkpoint
    # spacing is a streaming knob, so the override is dropped here.
    opts = dataclasses.replace(opts, checkpoint_interval=None)
    store = store if store is not None else MemoryStore()
    src = _resolve(built, store, source, sources)
    prog = built.one_shot(sum(src.batch_sizes()))
    src = _resolve(prog, store, source, sources)
    coord = StreamingCoordinator(store, MetadataStore(), program=prog,
                                 options=opts)
    report = coord.run_stream(src, announce=False, flush=True)
    return built.collect_outputs(store), report


def run_batch(built: BuiltPipeline, store=None, *, data=None, source=None,
              sources=None, options: RunOptions | None = None):
    """One-shot mode, pinned: :func:`run` with ``mode="batch"``.  Array
    pipelines run the batch plan over ``data`` (or the graph's bound
    shards) and return its ``(result, stats)``; windowed pipelines fold
    ``source`` (``sources=`` for a join) in one pass and return
    ``(outputs, report)``."""
    if built.is_array:
        return run(built, data, options=options, mode="batch")
    return run(built, source, store=store, sources=sources,
               options=options, mode="batch")
