"""Executing a built pipeline — one program, one front door, two modes.

``run(built, source_or_data, options=RunOptions(...))`` — surfaced as
``BuiltPipeline.run`` — dispatches by source kind: a ``StreamSource``
drives **streaming** mode through the ``StreamingCoordinator``
(micro-batches, watermarks, checkpoints, backpressure, the pipelined
scheduler's prepare/fold/drain lanes); an in-memory record list (or the
graph's bound ``records=``) drives **batch** mode — the same program once
over the full input, where the end-of-input flush finalizes every window,
so per-window output bytes equal the streaming run's.  ``None`` falls
back to the graph's bound source: a log prefix streams, bound records run
as one batch.
"""

from __future__ import annotations

import dataclasses

from ..core.metadata import MetadataStore
from ..core.storage import MemoryStore, ObjectStore
from ..engine.stages import fold_key24
from ..streaming.coordinator import RunOptions, StreamingCoordinator
from ..streaming.source import StreamSource
from .lower import BuiltPipeline


def resolve_source(built: BuiltPipeline, store: ObjectStore | None,
                   source=None) -> StreamSource:
    """The graph's source (or a run-time override) as one drivable
    micro-batch stream."""
    if source is not None:
        if isinstance(source, StreamSource):
            return source
        return StreamSource.from_records(source,
                                         batch_records=built.batch_records)
    spec = built.sides[0].source
    if spec.kind == "log":
        if store is None:
            raise ValueError("a log-backed pipeline needs a store")
        return StreamSource(store=store, prefix=spec.prefix,
                            batch_records=built.batch_records)
    if spec.kind == "records":
        return StreamSource.from_records(spec.records,
                                         batch_records=built.batch_records)
    raise ValueError("this pipeline's source is unbound — pass a source at "
                     "run time")


def _infer_mode(built: BuiltPipeline, source) -> str:
    """Live streams stream, in-memory records run as one batch, and
    ``None`` falls back to what the graph bound (a log prefix is an
    unbounded stream; bound records are a dataset)."""
    if isinstance(source, StreamSource):
        return "streaming"
    if source is not None:
        return "batch"
    return "streaming" if built.sides[0].source.kind == "log" else "batch"


def _shard_source(built: BuiltPipeline, store, source,
                  shard: tuple[int, int]):
    """Restrict the run to one partition of the key space (``fold_key24``
    of each record's key, so every shard agrees on the assignment), under
    a suffixed job id."""
    index, count = shard
    src = resolve_source(built, store, source)
    recs = [r for r in src.events() if fold_key24(r[1]) % count == index]
    sharded = StreamSource.from_records(recs,
                                        batch_records=built.batch_records)
    built = dataclasses.replace(
        built, job_id=f"{built.job_id}-shard{index}of{count}")
    return built, sharded


def run(built: BuiltPipeline, source_or_data=None, *,
        options: RunOptions | None = None, store=None, meta=None, bus=None,
        autoscaler=None, pool=None, announce: bool = True,
        flush: bool = True, mode: str | None = None):
    """The one front door for driving a built pipeline.

    ``source_or_data`` picks the mode (a ``StreamSource`` streams, a list
    of records runs as one batch, ``None`` uses the graph's bound source);
    ``mode="streaming"|"batch"`` forces it.  Returns a ``StreamReport`` in
    streaming mode and ``(outputs, report)`` in batch mode.
    """
    opts = options if options is not None else RunOptions()
    opts.validate()
    if mode not in (None, "streaming", "batch"):
        raise ValueError(f"mode must be 'streaming' or 'batch', got {mode!r}")
    source = source_or_data
    if mode is None:
        mode = _infer_mode(built, source)
    if opts.shard is not None:
        built, source = _shard_source(built, store, source, opts.shard)

    if mode == "streaming":
        store = store if store is not None else MemoryStore()
        meta = meta if meta is not None else MetadataStore()
        coord = StreamingCoordinator(store, meta, bus=bus,
                                     autoscaler=autoscaler, pool=pool,
                                     program=built, options=opts)
        return coord.run_stream(resolve_source(built, store, source),
                                announce=announce, flush=flush)

    # Batch: the same program, one pass, end-of-input flush; checkpoint
    # spacing is a streaming knob, so the override is dropped here.
    opts = dataclasses.replace(opts, checkpoint_interval=None)
    store = store if store is not None else MemoryStore()
    src = resolve_source(built, store, source)
    prog = built.one_shot(sum(src.batch_sizes()))
    src = resolve_source(prog, store, source)
    coord = StreamingCoordinator(store, MetadataStore(), program=prog,
                                 options=opts)
    report = coord.run_stream(src, announce=False, flush=True)
    return built.collect_outputs(store), report
