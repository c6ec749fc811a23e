"""StreamingCoordinator — continuous MapReduce, one round per micro-batch.

A long-lived loop over a replayable event log: consume the next
micro-batch, fold it through the compiled pipeline program
(``repro_torch.pipeline.BuiltPipeline``) on the device, advance the
watermark, and finalize + emit every window the watermark has passed.
The full streaming state — consumed record offset, the carried window
aggregates, the watermark/ring (or session) tracker and the key
dictionary — checkpoints at batch boundaries (metadata + object store),
so a restarted coordinator resumes exactly where it stopped.

This is the port of the reference coordinator for **single-stage**
programs: one stage, one input, fixed (tumbling/sliding) or session
windows, dense or hashed key spaces, aggregate or top-k emission.  The
carry is a torch tensor on the program's device, folded in place by the
fused fold (``kernels/fused_fold``); multi-stage chains, tee, joins and
group mode are rejected at build time and queued in ``ROADMAP.md``.

Checkpoints keep the reference's format byte for byte: an npz of
``leaf{i}`` arrays for the tuple of stage carries (one here) under
``jobs/<job_id>/stream/carry``, and the same metadata JSON (offset,
``carry_shapes``, per-stage tracker and key tables, ``edge_fed``).  A job
checkpointed by the reference's ``backend="pallas"`` coordinator resumes
here, and the reverse.

The drive loop is the reference's three-lane scheduler (``RunOptions``).
*Prepare*: a background thread reads and host-prepares micro-batch N+1
(source read, the fused map chain) while batch N folds — it does host
work only; key-table lookups, ring admission and every CUDA launch stay
on the driving thread, strictly in batch order, so output bytes are
identical with overlap on or off.  *Fold*: each step copies its rows to
the device through pinned memory and launches the fold kernel without
waiting for it.  *Drain*: each fold's ``[late, expanded, dropped]`` stats
tensor stays on the device until the micro-batch barrier, where all of
them are read back in one host transfer; window emissions within one
finalization sweep go through a single ``ObjectStore.put_many``.
Checkpoints land at barriers only, after the drain and the sink flush.
"""

from __future__ import annotations

import io
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..analysis.lanes import lane
from ..core.autoscaler import AutoscalerConfig, ServerlessPool
from ..core.events import (EventBus, TOPIC_STREAM_BATCH, TOPIC_STREAM_WINDOW,
                           batch_event, window_event)
from ..core.metadata import MetadataStore
from ..core.storage import ObjectStore
from ..core.workers import _encode_records
from ..engine.stages import fold_key24, host_bucket
from .source import MicroBatch
from .state import LateEventError
from .windows import Window

#: the three-lane scheduler's shared-state contract: coordinator
#: attributes more than one piece of the drive loop touches, mapped to the
#: lanes allowed to mutate them.  Keep entries literal (a linter reads it).
LANE_SHARED = {
    "_pending_stats": ("driver", "barrier"),   # deferred fold counters
    "_pending_puts": ("driver", "barrier"),    # staged sink writes
    "tables": ("driver",),                     # key-id dictionaries
    "tracker": ("driver", "barrier"),          # ring + watermark state
    "carry": ("driver", "barrier"),            # device fold state
}

#: names that hold device tensors on the hot path: reading one on the
#: host inside a driver/prefetch lane forces a device->host sync
LANE_DEVICE_STATE = {"carry", "stats"}

_MAX_WIRE_INT = 1 << 24  # largest int the float32 wire carries exactly
_NEG_INF = float("-inf")


@dataclass(frozen=True)
class RunOptions:
    """Scheduler knobs for one drive of a built pipeline — the single
    options surface behind ``BuiltPipeline.run(...)``.

    * ``overlap`` — prefetch + host-prepare micro-batch N+1 on a
      background thread while batch N folds, and defer the per-fold
      device→host stats reads to the micro-batch barrier.  ``False`` is
      the fully synchronous loop; output bytes are identical either way.
    * ``prefetch_batches`` — how many prepared batches may queue ahead.
    * ``sink_batching`` — write every window emitted during one
      finalization sweep through a single ``ObjectStore.put_many``.
    * ``checkpoint_interval`` — overrides the built program's barrier
      spacing (``None`` keeps the build-time value).
    * ``shard`` — ``(index, count)``: drive only the keys this coordinator
      owns (``fold_key24(key) % count == index``) under a per-shard job id.
    """

    overlap: bool = True
    prefetch_batches: int = 2
    sink_batching: bool = True
    checkpoint_interval: int | None = None
    shard: tuple[int, int] | None = None

    def validate(self) -> None:
        if self.prefetch_batches < 1:
            raise ValueError("prefetch_batches must be >= 1")
        if self.checkpoint_interval is not None \
                and self.checkpoint_interval < 0:
            raise ValueError("checkpoint_interval must be >= 0 "
                             "(0 disables checkpointing)")
        if self.shard is not None:
            index, count = self.shard
            if count < 1 or not 0 <= index < count:
                raise ValueError(f"shard must be (index, count) with "
                                 f"0 <= index < count, got {self.shard}")


@dataclass
class _PreparedBatch:
    """One micro-batch after prepare-lane work: records pushed through the
    fused map chain.  Key-table lookups, admission and folding stay on the
    driving thread."""

    index: int
    n_records: int
    max_event_time: float
    recs: list                      # transformed (ts, key, value, side)


class _Prefetcher:
    """Bounded-depth background prefetcher — the prepare lane.

    Reads micro-batches from the source iterator and host-prepares them on
    a worker thread while the main loop folds the batch in flight; at most
    ``depth`` prepared batches queue ahead.  A source or prepare error is
    re-raised on the main thread where the synchronous loop would have
    raised it.  ``close`` stops the thread promptly even when the main
    loop exits early, leaving prepared-but-unconsumed batches to the next
    run's replay from the checkpoint barrier."""

    def __init__(self, batches: Iterator[MicroBatch],
                 prepare: Callable[[MicroBatch], _PreparedBatch],
                 depth: int) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._fill, args=(batches, prepare),
            name="stream-prefetch", daemon=True)
        self._thread.start()

    def _fill(self, batches: Iterator[MicroBatch], prepare) -> None:
        try:
            for batch in batches:
                if not self._offer(("batch", prepare(batch))):
                    return
            self._offer(("end", None))
        except BaseException as exc:  # forwarded, re-raised by the consumer
            self._offer(("error", exc))

    def _offer(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[_PreparedBatch]:
        while True:
            kind, payload = self._q.get()
            if kind == "batch":
                yield payload
            elif kind == "end":
                return
            else:
                raise payload

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


@dataclass
class StreamReport:
    """Rolling accounting for a streaming run."""

    job_id: str
    batches: int = 0
    records_in: int = 0             # raw events consumed
    records_expanded: int = 0       # (record, window) pairs folded
    late_dropped: int = 0
    windows_emitted: int = 0        # windows written to the store
    wall_time: float = 0.0
    batch_latencies: list[float] = field(default_factory=list)
    max_lag: int = 0                # worst backpressure observed
    scale_events: int = 0           # pool resizes driven by lag
    hash_collisions: int = 0        # hashed key space: keys sharing a bucket
    writes_skipped: int = 0         # restart: windows already persisted
    folds: int = 0                  # fold steps dispatched to the device
    emit_latencies: list[float] = field(default_factory=list)
    # ^ per emitted window: wall-clock seconds from the watermark passing
    #   its end (close) to its bytes landing in the store (emit)
    error: str | None = None

    @property
    def records_per_sec(self) -> float:
        return self.records_in / self.wall_time if self.wall_time else 0.0

    @property
    def mean_batch_latency(self) -> float:
        ls = self.batch_latencies
        return sum(ls) / len(ls) if ls else 0.0

    def emit_latency_quantile(self, q: float) -> float:
        """Close-to-emit latency at quantile ``q`` (nearest-rank), in
        seconds; 0.0 when no window was emitted."""
        ls = sorted(self.emit_latencies)
        if not ls:
            return 0.0
        return ls[min(int(q * len(ls)), len(ls) - 1)]

    @property
    def p50_emit_latency(self) -> float:
        return self.emit_latency_quantile(0.50)

    @property
    def p99_emit_latency(self) -> float:
        return self.emit_latency_quantile(0.99)


def window_output_key(cfg, window: Window) -> str:
    """Object key for a fixed window's emission.  ``cfg`` is anything with
    ``output_prefix`` and ``job_id`` — typically a ``BuiltPipeline``."""
    return (f"{cfg.output_prefix.rstrip('/')}/{cfg.job_id}/"
            f"window-{window.start:.3f}-{window.end:.3f}")


def session_output_key(cfg, label: str, start: float, end: float) -> str:
    """Object key for a finalized session — the key's label is part of the
    address because two keys' sessions may share identical bounds."""
    return (f"{cfg.output_prefix.rstrip('/')}/{cfg.job_id}/"
            f"session-{label}-{start:.3f}-{end:.3f}")


def _state_key(job_id: str) -> str:
    return f"stream/{job_id}/state"


def _carry_key(job_id: str) -> str:
    return f"jobs/{job_id}/stream/carry"


def carries_from_reference(arrays, device="cuda") -> tuple[torch.Tensor, ...]:
    """The reference package's stage carries (numpy arrays, in its pytree
    leaf order — e.g. the ``leaf{i}`` entries of its checkpoint npz) as
    this port's carry tensors on ``device``.  The reference's
    ``backend="pallas"`` carry is the same flat ``(n_slots * carry_buckets,
    channels)`` float32 slab, so this is a typed, contiguous copy; a
    simulated-worker ``(W, per, channels)`` carry flattens to the same slab
    row order."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if a.dtype != np.float32:
            raise TypeError(f"stage carries are float32, got {a.dtype}")
        if a.ndim == 3:
            a = a.reshape(-1, a.shape[-1])
        if a.ndim != 2:
            raise ValueError(f"a stage carry is 2-D (rows, channels), got "
                             f"shape {a.shape}")
        out.append(torch.tensor(a, dtype=torch.float32, device=device))
    return tuple(out)


class _KeyTable:
    """The stage's key dictionary (the data layer's vocab analogue).

    Dense mode: a bounded key → bucket-id map, ids assigned in first-seen
    order.  Hashed mode: raw wire ids (``fold_key24``) plus bucket →
    first-seen labels, so emissions stay labeled and collisions are
    counted exactly instead of raising.
    """

    def __init__(self, mode: str, num_buckets: int) -> None:
        self.mode = mode
        self.num_buckets = num_buckets
        self._key_ids: dict[Any, int] = {}
        self._id_keys: list[Any] = []
        self._raw_ids: dict[Any, int] = {}
        self._bucket_keys: dict[int, list] = {}
        self.collisions = 0

    def key_id(self, key: Any) -> int:
        """The wire key id: a dense bucket id, or the 24-bit raw id the
        device hashes into buckets."""
        if self.mode == "hashed":
            return self._raw_key_id(key)
        kid = self._key_ids.get(key)
        if kid is None:
            kid = len(self._id_keys)
            if kid >= self.num_buckets:
                raise ValueError(
                    f"distinct key count exceeded num_buckets="
                    f"{self.num_buckets}; raise it (keys seen: {kid}) "
                    f"or open the domain with key_space='hashed'")
            self._key_ids[key] = kid
            self._id_keys.append(key)
        return kid

    def _raw_key_id(self, key: Any) -> int:
        raw = self._raw_ids.get(key)
        if raw is None:
            raw = fold_key24(key)
            self._raw_ids[key] = raw
            seen = self._bucket_keys.setdefault(
                host_bucket(raw, self.num_buckets), [])
            if seen and key not in seen:
                self.collisions += 1
            if key not in seen:
                seen.append(key)
        return raw

    def bucket_of(self, kid: int) -> int:
        """Host-side bucket for a wire key id — ``host_bucket`` mirrors the
        device's murmur bucketing exactly, so labels cannot drift."""
        if self.mode == "dense":
            return kid
        return host_bucket(kid, self.num_buckets)

    def label(self, bucket: int) -> str:
        """Output label for a bucket id."""
        if self.mode == "dense":
            return str(self._id_keys[bucket])
        seen = self._bucket_keys.get(bucket)
        if not seen:
            return f"bucket-{bucket}"
        if len(seen) == 1:
            return str(seen[0])
        return f"bucket-{bucket}[{'|'.join(sorted(str(k) for k in seen))}]"

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {"keys": list(self._id_keys),
                "bucket_keys": [[kid, keys]
                                for kid, keys in self._bucket_keys.items()],
                "collisions": self.collisions}

    def load_state_dict(self, d: dict) -> None:
        self._id_keys = list(d["keys"])
        self._key_ids = {k: i for i, k in enumerate(self._id_keys)}
        self._bucket_keys = {int(kid): list(keys)
                             for kid, keys in d.get("bucket_keys", [])}
        self._raw_ids = {k: fold_key24(k)
                         for keys in self._bucket_keys.values() for k in keys}
        self.collisions = int(d.get("collisions", 0))


class _StageState:
    """The stage's runtime state: compiled plan, carry, window tracker,
    key table and wire sizing."""

    def __init__(self, plan, key_space: str, wire_rows: int) -> None:
        self.plan = plan
        self.compiled = plan.sides[0].compiled
        self.assigner = plan.assigner()         # None for session windows
        self.tracker = plan.make_tracker()
        self.carry = self.compiled.init_carry()
        self.tables = [_KeyTable(key_space, plan.sides[0].num_buckets)]
        self.wire_rows = wire_rows
        self.window_base = 0                    # per-fold wire-index rebase


class StreamingCoordinator:
    """Long-lived coordinator: micro-batch rounds over a continuous stream,
    driving one compiled single-stage pipeline program on its device."""

    CONSUMER_GROUP = "streaming-coordinator"

    def __init__(self, store: ObjectStore, meta: MetadataStore,
                 bus: EventBus | None = None,
                 autoscaler: AutoscalerConfig | None = None, *,
                 program, options: RunOptions | None = None,
                 pool: ServerlessPool | None = None) -> None:
        if program is None:
            raise ValueError("pass program= (a BuiltPipeline)")
        if pool is not None and autoscaler is not None:
            raise ValueError("pass pool= (a shared ServerlessPool) or "
                             "autoscaler= (a config for a private pool), "
                             "not both")
        if len(program.stages) != 1:
            raise ValueError("the port's coordinator drives single-stage "
                             "programs")
        self.opts = options or RunOptions()
        self.opts.validate()
        self.store = store
        self.meta = meta
        self.prog = program
        self._ckpt_interval = (program.checkpoint_interval
                               if self.opts.checkpoint_interval is None
                               else self.opts.checkpoint_interval)
        self.bus = bus or EventBus()
        self.pool = pool if pool is not None else ServerlessPool(
            "stream-mapper", autoscaler or AutoscalerConfig(
                max_scale=program.n_workers))
        self.consumer_group = f"{self.CONSUMER_GROUP}:{program.job_id}"
        self._ext_wm = _NEG_INF             # the input's observed event time
        self.stages = [_StageState(program.stages[0], program.key_space,
                                   self._wire_rows())]
        self._records_consumed = 0      # checkpointed resume point (records)
        self._persisted: set[str] = set()   # restart: already-written windows
        # drain-lane staging: per-fold device stats awaiting their barrier
        # host read, and per-sweep window emissions awaiting their batched
        # store write
        self._pending_stats: list[torch.Tensor] = []
        self._pending_puts: list[tuple[str, bytes, float, float, int,
                                       float]] = []

    # -- construction ----------------------------------------------------------
    def _wire_rows(self) -> int:
        """Wire capacity: the micro-batch bound (times the window fan-out
        on the host fan-out wire).  The flat fold has no worker axis, so
        unlike the reference the wire is not split into ``n_workers``
        per-worker slices."""
        prog = self.prog
        sp = prog.stages[0]
        bound = prog.batch_records
        if not (sp.is_session or prog.fanout == "device"):
            bound *= sp.assigner().max_windows_per_event()
        return bound

    # -- record transforms -----------------------------------------------------
    @lane("prefetch")
    def _transform_recs(self, raw) -> list[tuple[float, Any, float, int]]:
        """Apply the stage's fused map chain and key/value extractors;
        returns ``(ts, key, value, side)`` records.  Touches only the
        immutable program, so the prepare lane may run it off-thread."""
        sp = self.stages[0].plan.sides[0]
        recs: list[tuple[float, Any, float, int]] = []
        for rec in raw:
            if sp.transform is None:
                out = (tuple(rec[:3]),)
            else:
                o = sp.transform(tuple(rec[:3]))
                out = () if o is None else \
                    ((o,) if isinstance(o, tuple) else tuple(o))
            for r in out:
                recs.append((float(r[0]), sp.key_fn(r),
                             float(sp.value_fn(r)), 0))
        return recs

    @lane("driver")
    def _grow_wire(self, recs: list) -> None:
        """Flat-maps may expand past the wire capacity: grow the buffer
        instead of failing, so the same graph runs in batch mode, where
        one "micro-batch" is the whole input."""
        stage = self.stages[0]
        if stage.plan.is_session or self.prog.fanout == "device":
            needed = len(recs)
        else:
            needed = len(recs) * stage.assigner.max_windows_per_event()
        stage.wire_rows = max(stage.wire_rows, needed)

    # -- folding -----------------------------------------------------------------
    @lane("driver")
    def _fold(self, rows: np.ndarray, report: StreamReport,
              min_window: int | None = None) -> torch.Tensor:
        """Dispatch one fold of wire rows into the stage's carry (in place
        on the device); returns its stats tensor, still on the device.
        ``min_window`` is the device wire's late-masking bound, already
        rebased.  Host-wire folds count their pairs on the host, so only
        the device wire accounts the returned stats."""
        stage = self.stages[0]
        stage.carry, stats = self.pool.submit(
            stage.compiled.step, rows, stage.carry, min_window)
        report.folds += 1
        return stats

    @lane("driver")
    def _fold_device(self, rows: np.ndarray, report: StreamReport) -> None:
        """Fold one-row-per-record [last_window, n_windows, key, value,
        valid] rows; the kernel fans out, masks late pairs against the
        watermark bound and returns the accounting.  Window indices on the
        wire are rebased by the stage's ``window_base`` (a multiple of
        ``n_slots``, so modular slots are unchanged) to stay exact in
        float32 at any absolute event time."""
        stage = self.stages[0]
        bound = stage.tracker.min_admissible() - stage.window_base
        bound = max(min(bound, 2 ** 31 - 1), -(2 ** 31))
        self._account_stats(self._fold(rows, report, bound), report)

    @lane("driver")
    def _account_stats(self, stats: torch.Tensor,
                       report: StreamReport) -> None:
        """Apply one fold's [late, expanded, dropped] counters.  With
        overlap on, the read is deferred: the stats tensor stays on the
        device and ``_drain_stats`` reads the whole batch's worth at the
        barrier, so no fold waits for the device.  The counters feed
        accounting only (never admission), so deferral cannot change any
        output byte."""
        if self.opts.overlap:
            self._pending_stats.append(stats)
            return
        # the synchronous (overlap-off) path reads per fold by design
        self._apply_stats(stats.tolist(), report)

    def _apply_stats(self, counters, report: StreamReport) -> None:
        late, expanded, _ = counters    # the third counter is group mode's
        self.stages[0].tracker.note_late(late)
        report.records_expanded += expanded

    @lane("barrier")
    def _drain_stats(self, report: StreamReport) -> None:
        """Batch-boundary drain: every deferred fold's counters in one
        device→host transfer."""
        if not self._pending_stats:
            return
        pending, self._pending_stats = self._pending_stats, []
        for counters in torch.stack(pending).tolist():
            self._apply_stats(counters, report)

    # -- window finalization --------------------------------------------------
    @lane("driver")
    def _put_window(self, out_key: str, records: list, start: float,
                    end: float, report: StreamReport,
                    t_close: float | None = None) -> None:
        """Persist one finalized window, idempotently across restarts: a
        window already in the store with identical bytes (a replayed
        emission from before the crash) is skipped; changed bytes
        overwrite.  With sink batching on, the write stages on the drain
        lane; ``_flush_sinks`` writes the sweep's windows in one
        ``put_many``."""
        blob = _encode_records(records)
        if t_close is None:
            t_close = time.perf_counter()
        if out_key in self._persisted and self.store.get(out_key) == blob:
            report.writes_skipped += 1
            return
        if self.opts.sink_batching:
            self._pending_puts.append((out_key, blob, start, end,
                                       len(records), t_close))
            return
        self.store.put(out_key, blob)
        report.emit_latencies.append(time.perf_counter() - t_close)
        self.bus.produce(TOPIC_STREAM_WINDOW,
                         window_event(self.prog.job_id, start, end,
                                      len(records), out_key),
                         key=f"{self.prog.job_id}/{start}")

    @lane("barrier")
    def _flush_sinks(self, report: StreamReport) -> None:
        """One batched store write for every window the sweep emitted,
        then the per-window bus events in emission order."""
        if not self._pending_puts:
            return
        pending, self._pending_puts = self._pending_puts, []
        self.store.put_many([(key, blob) for key, blob, *_ in pending])
        t_emit = time.perf_counter()
        for key, blob, start, end, n_records, t_close in pending:
            report.emit_latencies.append(t_emit - t_close)
            self.bus.produce(TOPIC_STREAM_WINDOW,
                             window_event(self.prog.job_id, start, end,
                                          n_records, key),
                             key=f"{self.prog.job_id}/{start}")

    def _aggregate_value(self, kind: str, total, count) -> Any:
        """``count`` → int, ``sum`` → float, ``mean`` → the float32
        quotient ``total / count``, as the reference emits them."""
        if kind == "count":
            return int(count)
        if kind == "sum":
            return float(total)
        return float(total / count)

    @lane("driver")
    def _window_records(self, slot: int) -> list[tuple[str, Any]]:
        """One finalized fixed window's output records, per the stage's
        emission spec (aggregate, or top-k in rank order)."""
        stage = self.stages[0]
        emit = stage.plan.emit
        compiled = stage.compiled
        table = stage.tables[0]
        records: list[tuple[str, Any]] = []
        if emit.kind == "top_k":
            ids, _vals, valid = compiled.top_k_slot(stage.carry, slot,
                                                    emit.rank_by)
            agg = compiled.read_slot(stage.carry, slot)
            for kid in ids[valid]:
                records.append((table.label(int(kid)), self._aggregate_value(
                    emit.aggregation, agg[kid, 0], agg[kid, 1])))
            # rank order, heaviest first (ties break on bucket id)
        else:
            agg = compiled.read_slot(stage.carry, slot)
            sums, counts = agg[:, 0], agg[:, 1]
            for kid in np.nonzero(counts > 0)[0]:
                records.append((table.label(int(kid)), self._aggregate_value(
                    emit.aggregation, sums[kid], counts[kid])))
            records.sort(key=lambda kv: kv[0])
        return records

    @lane("driver")
    def _emit_window(self, window_index: int, slot: int,
                     report: StreamReport) -> None:
        stage = self.stages[0]
        window = stage.assigner.window(window_index)
        records = self._window_records(slot)
        out_key = window_output_key(self.prog, window)
        t_close = stage.tracker.closed_at.get(window_index)
        self._put_window(out_key, records, window.start, window.end, report,
                         t_close=t_close)
        stage.carry = stage.compiled.clear_slot(stage.carry, slot)
        stage.tracker.release(window_index)

    @lane("driver")
    def _emit_session(self, session, report: StreamReport) -> None:
        stage = self.stages[0]
        compiled = stage.compiled
        cell = compiled.read_cell(stage.carry, session.slot, session.bucket)
        label = stage.tables[0].label(session.bucket)
        records: list[tuple[str, Any]] = []
        if cell[1] > 0:
            records.append((label, self._aggregate_value(
                stage.plan.emit.aggregation, cell[0], cell[1])))
        out_key = session_output_key(self.prog, label, session.start,
                                     session.end)
        self._put_window(out_key, records, session.start, session.end,
                         report)
        stage.carry = compiled.clear_cell(stage.carry, session.slot,
                                          session.bucket)
        stage.tracker.release(session)

    @lane("driver")
    def _admit_span(self, lo: int, hi: int, seen: float, ship, flush,
                    report: StreamReport, *ship_args) -> None:
        """Admit windows ``[lo, hi]`` on the ring and ship the span in
        contiguous segments — the ring/watermark protocol.

        ``ship(last, n, *ship_args)`` emits one segment covering
        ``[last - n + 1, last]`` (late windows inside it are masked and
        counted on the device).  On a mid-span ring-full, the already-safe
        prefix ships, ``flush()`` folds whatever the caller has staged,
        the watermark advances to ``seen``, ripe windows finalize, and the
        blocked window retries once — a second failure is a genuine
        capacity error and propagates.  A window the watermark closed
        during the retry stays in the span for the device mask
        (re-admitting it would double-count the pair)."""
        stage = self.stages[0]
        start = lo
        for widx in range(lo, hi + 1):
            if widx in stage.tracker.active or stage.tracker.is_late(widx):
                continue        # the kernel masks + counts the late pairs
            try:
                stage.tracker.slot_for(widx)
            except LateEventError:
                if widx > start:
                    ship(widx - 1, widx - start, *ship_args)
                    start = widx
                flush()
                stage.tracker.observe(seen)
                self._finalize_ripe(report)
                if not stage.tracker.is_late(widx):
                    stage.tracker.slot_for(widx)
        if hi >= start:
            ship(hi, hi - start + 1, *ship_args)

    @lane("driver")
    def _finalize_ripe(self, report: StreamReport) -> None:
        """Emit every window (or session) the watermark has passed, then
        flush the sweep's sink writes in one batch."""
        stage = self.stages[0]
        if stage.plan.is_session:
            for session in stage.tracker.ripe():
                self._emit_session(session, report)
                report.windows_emitted += 1
        else:
            for window_index, slot in stage.tracker.ripe():
                self._emit_window(window_index, slot, report)
                report.windows_emitted += 1
        self._flush_sinks(report)

    # -- checkpoint / restore --------------------------------------------------
    @lane("barrier")
    def save_state(self) -> None:
        """Persist the full streaming state at a batch boundary: the carry
        (as the reference's npz of pytree leaves) to the object store,
        tracker + key dictionary + the consumed *record* offset to the
        metadata store.  Only after the drain lane has emptied: staged
        sink writes must be durable before the offset advances, and
        deferred stats must be applied so the snapshot's late-drop
        counters match the synchronous loop's."""
        if self._pending_puts or self._pending_stats:
            raise RuntimeError(
                "internal: checkpoint requested with an undrained lane "
                f"({len(self._pending_puts)} staged sink writes, "
                f"{len(self._pending_stats)} deferred stats reads); "
                "checkpoints must follow the batch-boundary drain")
        leaves = [st.carry.to("cpu", copy=True).numpy()
                  for st in self.stages]
        buf = io.BytesIO()
        np.savez(buf, **{f"leaf{i}": leaf for i, leaf in enumerate(leaves)})
        self.store.put(_carry_key(self.prog.job_id), buf.getvalue())
        self.meta.set(_state_key(self.prog.job_id), {
            "offset": self._records_consumed,
            "carry_shapes": [list(leaf.shape) for leaf in leaves],
            "edge_fed": [],
            "stages": [{
                "tracker": st.tracker.state_dict(),
                "tables": [t.state_dict() for t in st.tables],
            } for st in self.stages],
        })

    def restore_state(self) -> int:
        """Load a prior run's checkpoint (this package's or the
        reference's); returns the record offset to resume from (0 when
        starting fresh).  Also lists the windows the prior run already
        persisted, so the replay of the uncheckpointed tail does not
        re-write them."""
        self._persisted = {
            m.key for out_prefix in self.prog.output_prefixes()
            for m in self.store.list_objects(out_prefix)}
        state = self.meta.get(_state_key(self.prog.job_id))
        if state is None:
            self._records_consumed = 0
            return 0
        if "carry_shapes" not in state or "stages" not in state:
            raise ValueError(
                f"checkpoint for job {self.prog.job_id} predates the "
                f"multi-stage carry format; restart the stream under a "
                f"fresh job_id or replay it from the log")
        if len(state["stages"]) != len(self.stages) or state.get("edge_fed"):
            raise ValueError(
                f"checkpoint for job {self.prog.job_id} holds "
                f"{len(state['stages'])} stages but this program has "
                f"{len(self.stages)}; the pipeline changed under the job")
        shapes = [tuple(s) for s in state["carry_shapes"]]
        mine = [tuple(st.carry.shape) for st in self.stages]
        if shapes != mine:
            raise ValueError(
                f"checkpointed carry shapes {shapes} do not match this "
                f"coordinator's {mine}; the streaming config changed under "
                f"job {self.prog.job_id}")
        blob = self.store.get(_carry_key(self.prog.job_id))
        with np.load(io.BytesIO(blob)) as loaded:
            arrays = [loaded[f"leaf{i}"] for i in range(len(self.stages))]
        device = self.stages[0].carry.device
        for st, carry in zip(self.stages,
                             carries_from_reference(arrays, device)):
            st.carry = carry
        for st, sdict in zip(self.stages, state["stages"]):
            st.tracker.load_state_dict(sdict["tracker"])
            for table, tdict in zip(st.tables, sdict["tables"]):
                table.load_state_dict(tdict)
        self._records_consumed = int(state["offset"])
        return self._records_consumed

    # -- backpressure ----------------------------------------------------------
    def _autoscale(self, report: StreamReport) -> None:
        lag = self.bus.lag(self.consumer_group, TOPIC_STREAM_BATCH)
        report.max_lag = max(report.max_lag, lag)
        want = self.pool.desired_scale_from_backlog(lag)
        if want > self.pool.replicas():
            self.pool.ensure_scale(want)
            report.scale_events += 1
        elif want < self.pool.replicas():
            if self.pool.reap_idle():
                report.scale_events += 1

    # -- the streaming loop -----------------------------------------------------
    def announce(self, source, start_record: int = 0) -> int:
        """Publish one trigger CloudEvent per available micro-batch; the
        resulting consumer lag drives autoscaling.  ``start_record`` skips
        already-processed records on resume."""
        n = 0
        for index, size in enumerate(source.batch_sizes(start_record)):
            self.bus.produce(
                TOPIC_STREAM_BATCH,
                batch_event(self.prog.job_id, index, size),
                key=f"{self.prog.job_id}/{index}")
            n += 1
        return n

    @lane("driver")
    def _ingest_device(self, recs, report: StreamReport) -> None:
        """Device fan-out ingestion: one 5-column row per record; window
        *indices* are assigned host-side in float64 (bit-identical to the
        host-fan-out assigner) but the event × window expansion happens in
        the kernel.  A batch that spans more windows than the ring holds
        folds and finalizes mid-batch instead of aborting."""
        stage = self.stages[0]
        w0 = stage.assigner.window(0)
        step = stage.assigner.window(1).start - w0.start
        ts = np.array([r[0] for r in recs], np.float64)
        rel = ts - w0.start
        last = np.floor(rel / step).astype(np.int64)
        if stage.plan.window.slide is None:
            first = last
        else:
            first = np.floor((rel - w0.size) / step).astype(np.int64) + 1
        # rebase wire indices so they stay exact in float32 at any absolute
        # event time; a multiple of n_slots keeps w mod n_slots unchanged
        n_slots = stage.plan.n_slots
        base = (int(first.min()) // n_slots) * n_slots
        if int(last.max()) - base >= _MAX_WIRE_INT:
            raise ValueError(
                f"one ingestion round spans {int(last.max()) - base} "
                f"windows, beyond the float32 wire's exact-integer range; "
                f"reduce batch_records or raise the window slide")
        stage.window_base = base
        shape = (stage.wire_rows, 5)
        rows = np.zeros(shape, np.float32)
        n = 0

        def fold_staged() -> None:
            nonlocal rows, n
            if n:
                self._fold_device(rows, report)
                rows = np.zeros(shape, np.float32)
                n = 0

        def ship(seg_last: int, nw: int, kid: int, value: float) -> None:
            nonlocal n
            rows[n] = (seg_last - base, nw, kid, value, 1.0)
            n += 1

        seen = _NEG_INF             # stream position within this round
        table = stage.tables[0]
        for i, (tsi, key, value, _side) in enumerate(recs):
            seen = tsi if tsi > seen else seen
            kid = table.key_id(key)
            self._admit_span(int(first[i]), int(last[i]), seen, ship,
                             fold_staged, report, kid, value)
        self._fold_device(rows, report)

    @lane("driver")
    def _ingest_host(self, recs, report: StreamReport) -> None:
        """Host fan-out: expand every record into one row per containing
        window on the host (numpy).  Host-dropped pairs are counted here
        through the tracker's single accounting entry point."""
        stage = self.stages[0]
        rows = np.zeros((stage.wire_rows, 4), np.float32)
        n = 0
        seen = _NEG_INF
        for ts, key, value, _side in recs:
            seen = ts if ts > seen else seen
            for widx in stage.assigner.assign(ts):
                try:
                    slot = stage.tracker.slot_for(widx)
                except LateEventError:
                    if n:
                        self._fold(rows, report)
                        report.records_expanded += n
                        rows = np.zeros_like(rows)
                        n = 0
                    stage.tracker.observe(seen)
                    self._finalize_ripe(report)
                    slot = stage.tracker.slot_for(widx)
                if slot is None:        # late: window already emitted
                    stage.tracker.note_late(1)
                    continue
                rows[n] = (slot, stage.tables[0].key_id(key), value, 1.0)
                n += 1
        report.records_expanded += n
        self._fold(rows, report)

    @lane("driver")
    def _ingest_session(self, recs, report: StreamReport) -> None:
        """Session ingestion: the tracker assigns each admitted event a
        carry cell (slot, bucket), merging bridged sessions; rows ship on
        the host wire with fan-out 1.  Cell merges apply *after* folding
        the rows already staged for the source cells, so the carry and the
        tracker never disagree about where a session lives."""
        stage = self.stages[0]
        compiled = stage.compiled
        table = stage.tables[0]
        shape = (stage.wire_rows, 4)
        rows = np.zeros(shape, np.float32)
        n = 0
        seen = _NEG_INF

        def fold_staged() -> None:
            nonlocal rows, n
            if n:
                report.records_expanded += n
                self._fold(rows, report)
                rows = np.zeros(shape, np.float32)
                n = 0

        for tsi, key, value, _side in recs:
            seen = tsi if tsi > seen else seen
            kid = table.key_id(key)
            bucket = table.bucket_of(kid)
            try:
                admitted = stage.tracker.admit(bucket, tsi)
            except LateEventError:
                fold_staged()
                stage.tracker.observe(seen)
                self._finalize_ripe(report)
                admitted = stage.tracker.admit(bucket, tsi)
            if admitted is None:        # late: session already emitted
                stage.tracker.note_late(1)
                continue
            slot, merges = admitted
            if merges:
                fold_staged()
                for src, dst in merges:
                    stage.carry = compiled.merge_cell(stage.carry, src, dst,
                                                      bucket)
            rows[n] = (slot, kid, value, 1.0)
            n += 1
        fold_staged()

    @lane("prefetch")
    def _prepare_batch(self, batch: MicroBatch) -> _PreparedBatch:
        """Prepare-lane work for one micro-batch: size check and the fused
        map chain.  Reads only the immutable program, so the prefetch
        thread runs it for batch N+1 while the main thread folds batch N."""
        if len(batch.records) > self.prog.batch_records:
            raise ValueError(
                f"micro-batch {batch.index} carries {len(batch.records)} "
                f"records but the coordinator was sized for batch_records="
                f"{self.prog.batch_records}; create the StreamSource with "
                f"batch_records <= the coordinator's")
        return _PreparedBatch(
            index=batch.index, n_records=len(batch.records),
            max_event_time=batch.max_event_time,
            recs=self._transform_recs(batch.records))

    def _process_prepared(self, prep: _PreparedBatch,
                          report: StreamReport) -> None:
        """Fold + drain lanes for one prepared micro-batch: admit → fold
        (device) → watermark → finalize, then drain the deferred stats at
        the barrier and checkpoint if due."""
        prog = self.prog
        t0 = time.perf_counter()
        self.bus.poll(self.consumer_group, TOPIC_STREAM_BATCH,
                      timeout=0.01, max_records=1)
        self._autoscale(report)
        stage = self.stages[0]
        late_before = stage.tracker.late_dropped
        report.records_in += prep.n_records
        if prep.recs:
            self._grow_wire(prep.recs)
            if stage.plan.is_session:
                self._ingest_session(prep.recs, report)
            elif prog.fanout == "device":
                self._ingest_device(prep.recs, report)
            else:
                self._ingest_host(prep.recs, report)
        self._ext_wm = max(self._ext_wm, prep.max_event_time)
        stage.tracker.observe(self._ext_wm)
        self._finalize_ripe(report)
        self._drain_stats(report)       # micro-batch barrier: lanes empty
        report.late_dropped += stage.tracker.late_dropped - late_before
        report.hash_collisions = stage.tables[0].collisions
        report.batches += 1
        self._records_consumed += prep.n_records
        if self._ckpt_interval and \
                (prep.index + 1) % self._ckpt_interval == 0:
            self.save_state()
        report.batch_latencies.append(time.perf_counter() - t0)

    def process_batch(self, batch: MicroBatch,
                      report: StreamReport) -> None:
        """One micro-batch round, prepared and processed inline."""
        self._process_prepared(self._prepare_batch(batch), report)

    def flush_end_of_stream(self, report: StreamReport) -> None:
        """Finalize every still-open window as if the stream had ended:
        checkpoint first (a later run over a grown log must resume with
        the real watermark, not +inf), then advance the watermark to +inf
        and drain the lanes."""
        if report.batches and self._ckpt_interval:
            self.save_state()
        self._ext_wm = float("inf")
        self.stages[0].tracker.observe(float("inf"))
        self._finalize_ripe(report)
        self._drain_stats(report)
        self._flush_sinks(report)

    def run_stream(self, source, *, announce: bool = True,
                   flush: bool = True) -> StreamReport:
        """Consume the whole currently-available log; with ``flush`` also
        finalize the still-open windows at the end.  With overlap on, a
        background prefetcher prepares batch N+1 while batch N folds; a
        crash leaves prepared-but-unconsumed batches to the replay."""
        report = StreamReport(self.prog.job_id)
        t_start = time.perf_counter()
        start = self.restore_state()
        try:
            if announce:
                self.announce(source, start_record=start)
            if self.opts.overlap:
                prefetcher = _Prefetcher(source.batches(start_record=start),
                                         self._prepare_batch,
                                         self.opts.prefetch_batches)
                try:
                    for prep in prefetcher:
                        self._process_prepared(prep, report)
                finally:
                    prefetcher.close()
            else:
                for batch in source.batches(start_record=start):
                    self.process_batch(batch, report)
            if flush:
                self.flush_end_of_stream(report)
        except Exception as exc:
            report.error = str(exc)
            raise
        finally:
            report.wall_time = time.perf_counter() - t_start
        return report

