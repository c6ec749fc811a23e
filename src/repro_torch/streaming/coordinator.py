"""StreamingCoordinator — continuous MapReduce, one round per micro-batch.

A long-lived loop over a replayable event log: consume the next
micro-batch, fold it through the compiled pipeline program
(``repro_torch.pipeline.BuiltPipeline``) on the device, advance the
watermark, and finalize + emit every window the watermark has passed.
The full streaming state — consumed record offset, the carried window
aggregates, the watermark/ring (or session) tracker and the key
dictionary — checkpoints at batch boundaries (metadata + object store),
so a restarted coordinator resumes exactly where it stopped.

The program is a **stage DAG** (``BuiltPipeline.stages`` in topological
order, wired by ``BuiltPipeline.edges``).  A plain chain has one stage; a
windowed join has one stage with two sides compiled over disjoint channel
pairs of **one shared carry** — left records fold into channels [0, 2),
right into [2, 4), and finalization inner-joins the keys populated on
both sides (by label for dense joins, whose sides may size their key
spaces independently; by bucket for hashed joins).  A multi-stage graph
runs as a *plan cascade*: when stage N's watermark finalizes a window, the
window's aggregates become each successor's input through a **carry
handoff**, one delivery per out-*edge* — a ``tee``'d stage fans one
finalized window out to every branch, each edge with its own transport
and its own bucket → next-key relabel table.  A device edge builds the
successor's wire rows from the finalized slot on the device
(``CompiledStreamAggregate.handoff_rows``) and folds them through the
destination's ``fused_fold`` on the same stream, with no host copy in
between; a host edge (an inter-stage map or custom ``key_by``)
materializes the same records and feeds them through the ordinary
ingestion path.  Fixed windows finalize in start order, so every
successor sees a monotone event-time feed and batch and streaming replays
stay bit-identical.  Finalization is one forward sweep over the stages,
and a stage with several inputs (a join over multi-stage sides) advances
its watermark to the *minimum* over its input channels.  Session windows
run in single-stage pipelines only.  The carries are torch tensors on the
program's device: an aggregate stage's is folded in place by the fused
fold (``kernels/fused_fold``); a group-mode stage's is its record
buffers per (worker, window slot), whose finalized windows run the
stage's reducer over each key's values (``CompiledStreamGroup``) and
emit — or feed a successor over a host edge — ``(label, value)``
records in label order.  Its third fold counter, the records the
buffers dropped past their capacity, adds up in
``StreamReport.capacity_dropped``.

The backend of the program's plans sets the wire's layout
(``engine.compile``): the flat ``(rows, 4|5)`` wire under ``"fused"``;
under ``"vmap"`` the same rows padded to a multiple of ``n_workers`` and
seen as ``(W, per, 4|5)``, worker ``w`` taking rows ``[w * per, (w + 1) *
per)`` as the reference pads and deals them; under ``"shard_map"`` each
rank runs this coordinator over the same source and folds its own
``per`` rows of that padded wire.  Finalized windows are gathered from
every rank, so every rank emits the same records, and only rank 0
writes them (and the carry checkpoints) to the store, so exactly-once
holds; each rank records the checkpoint's metadata, which is the same on
every rank.

Checkpoints keep the reference's format byte for byte: an npz of
``leaf{i}`` arrays for the tuple of stage carries under
``jobs/<job_id>/stream/carry`` (in pytree leaf order: an aggregate
stage's slab is one leaf, a group stage's dict three — ``counts``,
``keys``, ``vals``), and the same metadata JSON (offset,
``carry_shapes``, per-stage tracker and key tables, per-edge
``edge_fed``).  A job checkpointed by the reference's coordinator resumes
here, and the reverse, where the carries have one layout in both: the
aggregate slab of its ``backend="pallas"`` and ``"shard_map"`` (which
the port's ``"fused"`` and ``"shard_map"`` write: the latter gathers the
ranks' shares first, and each rank takes its own back on restore), and
the ``vmap`` layouts (the port's ``"vmap"``; its group buffers also under
``"fused"``).

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
import math
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
    """One micro-batch after prepare-lane work: records routed to their
    root stages and pushed through the fused map chains.  Key-table
    lookups, admission and folding stay on the driving thread."""

    index: int
    n_records: int
    max_event_time: float
    groups: dict[int, list]         # root stage → transformed records


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
    windows_emitted: int = 0        # terminal windows written to the store
    handoffs: int = 0               # windows handed to a successor stage
    wall_time: float = 0.0
    batch_latencies: list[float] = field(default_factory=list)
    max_lag: int = 0                # worst backpressure observed
    scale_events: int = 0           # pool resizes driven by lag
    hash_collisions: int = 0        # hashed key space: keys sharing a bucket
    capacity_dropped: int = 0       # group mode: window-buffer overflow
    writes_skipped: int = 0         # restart: windows already persisted
    folds: int = 0                  # fold steps dispatched, all stages
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


def window_output_key(cfg, window: Window, prefix: str | None = None) -> str:
    """Object key for a fixed window's emission.  ``cfg`` is anything with
    ``output_prefix`` and ``job_id`` — typically a ``BuiltPipeline``.
    ``prefix`` overrides the program's prefix for a terminal fan-out
    branch that sinks to its own stream."""
    return (f"{(prefix or cfg.output_prefix).rstrip('/')}/{cfg.job_id}/"
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


def _carry_leaves(carry) -> list:
    """One stage's carry as the reference's pytree leaves: the aggregate
    slab, or a group carry's ``counts``, ``keys``, ``vals`` (a dict's
    leaves come in sorted key order)."""
    if isinstance(carry, dict):
        return [carry[k] for k in sorted(carry)]
    return [carry]


def _restore_carry(like, arrays: list, device):
    """Checkpointed leaves as a carry of ``like``'s kind and shape on
    ``device``: an aggregate carry through ``carries_from_reference``, a
    group carry leaf by leaf in its own dtypes."""
    if not isinstance(like, dict):
        return carries_from_reference(arrays, device)[0].reshape(like.shape)
    out = {}
    for name, arr in zip(sorted(like), arrays):
        want = like[name].dtype
        if torch.from_numpy(np.zeros(0, arr.dtype)).dtype != want:
            raise TypeError(f"group carry leaf {name!r} is {want}, the "
                            f"checkpoint holds {arr.dtype}")
        out[name] = torch.tensor(arr, dtype=want, device=device)
    return out


class _KeyTable:
    """One side's key dictionary (the data layer's vocab analogue).

    Dense mode: a bounded key → bucket-id map, ids assigned in first-seen
    order.  Hashed mode: raw wire ids (``fold_key24``) plus bucket →
    first-seen labels, so emissions stay labeled and collisions are
    counted exactly instead of raising.  ``on_new`` (dense only) fires
    when a key is first registered — the eager edges use it to grow every
    identity successor's dictionary (and a device edge's relabel table) at
    once, so checkpoints always hold a closed mapping.
    """

    def __init__(self, mode: str, num_buckets: int, name: str = "") -> None:
        self.mode = mode
        self.num_buckets = num_buckets
        self.name = name
        self.on_new: Callable[[int, str], None] | None = None
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
                side = f" on the {self.name} side" if self.name else ""
                raise ValueError(
                    f"distinct key count exceeded num_buckets="
                    f"{self.num_buckets}{side}; raise it (keys seen: {kid}) "
                    f"or open the domain with key_space='hashed'")
            self._key_ids[key] = kid
            self._id_keys.append(key)
            if self.on_new is not None:
                self.on_new(kid, str(key))
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

    @property
    def dense_keys(self) -> list:
        return self._id_keys

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> dict:
        return {"keys": list(self._id_keys),
                "bucket_keys": [[kid, keys]
                                for kid, keys in self._bucket_keys.items()],
                "collisions": self.collisions}

    def load_state_dict(self, d: dict) -> None:
        """Restore without firing ``on_new`` — relabel tables are rebuilt
        explicitly after every table has loaded."""
        self._id_keys = list(d["keys"])
        self._key_ids = {k: i for i, k in enumerate(self._id_keys)}
        self._bucket_keys = {int(kid): list(keys)
                             for kid, keys in d.get("bucket_keys", [])}
        self._raw_ids = {k: fold_key24(k)
                         for keys in self._bucket_keys.values() for k in keys}
        self.collisions = int(d.get("collisions", 0))


class _StageState:
    """One stage's runtime state: the compiled plan handle(s), carry,
    window tracker, per-side key tables and wire sizing."""

    def __init__(self, plan, wire_rows: int) -> None:
        self.plan = plan
        self.compiled = plan.sides[0].compiled
        self.assigner = plan.assigner()         # None for session windows
        self.tracker = plan.make_tracker()
        self.carry = self.compiled.init_carry()
        self.tables: list[_KeyTable] = []
        self.wire_rows = wire_rows
        self.window_base = 0                    # per-fold wire-index rebase


class _EdgeState:
    """One DAG edge's runtime state: the lowered transport flags
    (``spec`` is a ``pipeline.lower.StageEdge``), the bucket →
    next-stage-key relabel table (a device edge owns one — a teed stage
    relabels independently toward each successor — kept on the host and
    copied to the device before the next handoff that reads it after it
    grew), and the feed watermark driving the destination's
    min-over-inputs observation."""

    def __init__(self, spec) -> None:
        self.spec = spec
        self.relabel: np.ndarray | None = None  # src bucket → dst key id
        self.relabel_dev: torch.Tensor | None = None
        self.fed: float = _NEG_INF              # max window start handed off


class StreamingCoordinator:
    """Long-lived coordinator: micro-batch rounds over a continuous stream,
    driving one compiled pipeline program — a DAG of execution-plan stages
    chained by carry handoffs — on its device."""

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
        # the stage DAG: adjacency first (wire sizing needs the in-edges),
        # then per-stage state
        self.edges = [_EdgeState(e) for e in program.edges]
        self._out: dict[int, list[_EdgeState]] = {}
        self._in: dict[int, list[_EdgeState]] = {}
        for e in self.edges:
            self._out.setdefault(e.spec.src, []).append(e)
            self._in.setdefault(e.spec.dst, []).append(e)
        self._roots = sorted({si for si, _side in program.inputs})
        self._ext_wm: dict[int, float] = {}  # per-root external watermark
        # the worker axis of the program's plans: its size rounds the
        # wire, its rank picks this process's shard and the store writer
        self._axis = program.stages[0].sides[0].compiled.axis
        self._writer = self._axis.rank == 0
        self.stages = [_StageState(sp, self._wire_rows(si))
                       for si, sp in enumerate(program.stages)]
        self._build_tables()
        self._records_consumed = 0      # checkpointed resume point (records)
        self._persisted: set[str] = set()   # restart: already-written windows
        # drain-lane staging: per-fold device stats awaiting their barrier
        # host read, and per-sweep window emissions awaiting their batched
        # store write
        self._pending_stats: list[tuple[int, torch.Tensor]] = []
        self._pending_puts: list[tuple[str, bytes, float, float, int,
                                       float]] = []

    # -- construction ----------------------------------------------------------
    def _wire_rows(self, si: int) -> int:
        """Wire capacity of stage ``si``: the micro-batch bound where an
        external input lands, each in-edge source's worst-case window
        output where the carry feeds it (a stage fed both ways takes the
        max; grown on demand if flat-maps expand it), times the window
        fan-out on the host fan-out wire.  A group stage's window holds
        up to ``n_workers * capacity`` groups.  Under ``"vmap"`` and
        ``"shard_map"`` the wire is dealt to ``n_workers`` workers, so the
        bound rounds up to a multiple of them (the reference's
        ``per_worker``); the fused wire is not rounded."""
        prog = self.prog
        sp = prog.stages[si]
        bounds = [prog.batch_records] if any(
            s == si for s, _side in prog.inputs) else []
        for e in self._in.get(si, ()):
            prev = prog.stages[e.spec.src]
            if prev.emit.kind == "top_k":
                bounds.append(max(prev.emit.k, 1))
            elif prev.emit.kind == "group":
                bounds.append(prog.n_workers * max(prev.capacity, 1))
            else:
                bounds.append(prev.num_buckets)
        bound = max(bounds)
        if not (sp.is_session or prog.fanout == "device"):
            bound *= sp.assigner().max_windows_per_event()
        return self._axis.round_rows(bound)

    def _build_tables(self) -> None:
        prog = self.prog
        for st in self.stages:
            if st.plan.is_join and prog.key_space == "dense":
                # dense joins match by label at emission, so each side keeps
                # its own dictionary — per-side key-space sizes stay honest
                st.tables = [_KeyTable("dense", sp.num_buckets, name=sp.name)
                             for sp in st.plan.sides]
            else:
                # hashed joins match by bucket id: one shared table keeps
                # cross-side collision accounting and labels identical
                table = _KeyTable(prog.key_space,
                                  st.plan.sides[0].num_buckets)
                st.tables = [table] * len(st.plan.sides)
        for si, st in enumerate(self.stages):
            eager = [e for e in self._out.get(si, ()) if e.spec.eager]
            if not eager:
                continue
            for e in eager:
                if e.spec.device:
                    e.relabel = np.full(st.plan.num_buckets, -1, np.int32)

            def on_new(kid: int, label: str, edges=tuple(eager)) -> None:
                # eager: every identity successor's dictionary (and, on a
                # device edge, the edge's relabel table) grows the moment
                # this stage first sees a key — both handoff transports
                # assign the same downstream id order, and every checkpoint
                # snapshots a closed mapping on every edge
                for e in edges:
                    dst = self.stages[e.spec.dst]
                    next_id = dst.tables[e.spec.dst_side].key_id(label)
                    if e.relabel is not None:
                        e.relabel[kid] = next_id
                        e.relabel_dev = None    # stale on the device now

            st.tables[0].on_new = on_new

    # -- record transforms -----------------------------------------------------
    @lane("prefetch")
    def _transform_recs(self, si: int,
                        raw) -> list[tuple[float, Any, float, int]]:
        """Apply stage ``si``'s fused map chain and key/value extractors;
        returns side-tagged ``(ts, key, value, side)`` records.  Touches
        only the immutable program, so the prepare lane may run it
        off-thread."""
        stage = self.stages[si]
        recs: list[tuple[float, Any, float, int]] = []
        for rec in raw:
            side = int(rec[3]) if len(rec) > 3 else 0
            sp = stage.plan.sides[side]
            if sp.transform is None:
                out = (tuple(rec[:3]),)
            else:
                o = sp.transform(tuple(rec[:3]))
                out = () if o is None else \
                    ((o,) if isinstance(o, tuple) else tuple(o))
            for r in out:
                recs.append((float(r[0]), sp.key_fn(r),
                             float(sp.value_fn(r)), side))
        return recs

    @lane("driver")
    def _grow_wire(self, si: int, recs: list) -> None:
        """Flat-maps may expand past the wire capacity: grow the buffer
        instead of failing, so the same graph runs in batch mode, where
        one "micro-batch" is the whole input."""
        stage = self.stages[si]
        if stage.plan.is_session or self.prog.fanout == "device":
            needed = len(recs)
        else:
            needed = len(recs) * stage.assigner.max_windows_per_event()
        stage.wire_rows = max(stage.wire_rows,
                              self._axis.round_rows(needed))

    @lane("driver")
    def _stage_recs(self, si: int, raw, report: StreamReport,
                    count_in: bool) -> list[tuple[float, Any, float, int]]:
        """Transform + wire growth in one synchronous call — the host-edge
        feed path."""
        if count_in:
            report.records_in += len(raw)
        recs = self._transform_recs(si, raw)
        self._grow_wire(si, recs)
        return recs

    # -- folding -----------------------------------------------------------------
    @lane("driver")
    def _fold(self, si: int, rows, report: StreamReport,
              min_window: int | None = None, side: int = 0) -> torch.Tensor:
        """Dispatch one fold of wire rows (host rows, or a tensor already
        on the device) through side ``side``'s plan into stage ``si``'s
        carry (in place on the device); returns its stats tensor, still on
        the device.  ``min_window`` is the device wire's late-masking
        bound, already rebased.  Every fold of every stage — record
        ingestion and carry handoff alike — passes here, so
        ``report.folds`` counts the run's fold steps."""
        stage = self.stages[si]
        # the backend's wire: (W, per, width) under "vmap", this rank's
        # per rows under "shard_map", the flat rows under "fused"
        wire = self._axis.shard(self._axis.layout(rows))
        stage.carry, stats = self.pool.submit(
            stage.plan.sides[side].compiled.step, wire, stage.carry,
            min_window)
        report.folds += 1
        return stats

    def _device_bound(self, stage: _StageState) -> int:
        bound = stage.tracker.min_admissible() - stage.window_base
        return max(min(bound, 2 ** 31 - 1), -(2 ** 31))

    @lane("driver")
    def _fold_device(self, si: int, rows: np.ndarray, report: StreamReport,
                     side: int = 0) -> None:
        """Fold one-row-per-record [last_window, n_windows, key, value,
        valid] rows through one side's plan; the kernel fans out, masks
        late pairs against the watermark bound and returns the accounting.
        Window indices on the wire are rebased by the stage's
        ``window_base`` (a multiple of ``n_slots``, so modular slots are
        unchanged) to stay exact in float32 at any absolute event time."""
        bound = self._device_bound(self.stages[si])
        self._account_stats(si, self._fold(si, rows, report, bound, side),
                            report)

    @lane("driver")
    def _account_stats(self, si: int, stats: torch.Tensor,
                       report: StreamReport) -> None:
        """Apply one fold's [late, expanded, dropped] counters.  With
        overlap on, the read is deferred: the stats tensor stays on the
        device and ``_drain_stats`` reads the whole batch's worth at the
        barrier, so no fold waits for the device (and sibling tee-branch
        handoffs queue back to back).  The counters feed accounting only
        (never admission), so deferral cannot change any output byte."""
        if self.opts.overlap:
            self._pending_stats.append((si, stats))
            return
        # the synchronous (overlap-off) path reads per fold by design
        counters = stats.tolist()  # reprolint: disable=RL102
        self._apply_stats(si, counters, report)

    def _apply_stats(self, si: int, counters, report: StreamReport) -> None:
        late, expanded, dropped = counters
        self.stages[si].tracker.note_late(late)
        report.records_expanded += expanded
        report.capacity_dropped += dropped

    @lane("barrier")
    def _drain_stats(self, report: StreamReport) -> None:
        """Batch-boundary drain: every deferred fold's counters in one
        device→host transfer."""
        if not self._pending_stats:
            return
        pending, self._pending_stats = self._pending_stats, []
        counters = torch.stack([stats for _si, stats in pending]).tolist()
        for (si, _stats), row in zip(pending, counters):
            self._apply_stats(si, row, report)

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
        if not self._writer:
            return              # rank 0 writes every rank's (equal) windows
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
    def _window_records(self, si: int, slot: int) -> list[tuple[str, Any]]:
        """One finalized fixed window's output records, per the stage's
        emission spec — written to the store by a terminal stage, fed to
        the next stage's ingestion by an intermediate one over a host
        edge."""
        stage = self.stages[si]
        emit = stage.plan.emit
        compiled = stage.compiled
        table = stage.tables[0]
        records: list[tuple[str, Any]] = []
        if emit.kind == "group":
            gk, gv, gvalid = compiled.finalize_slot(stage.carry, slot)
            records = [(table.label(int(k)), float(v))
                       for k, v in zip(gk[gvalid], gv[gvalid])]
            records.sort(key=lambda kv: kv[0])
        elif emit.kind == "top_k":
            ids, _vals, valid = compiled.top_k_slot(stage.carry, slot,
                                                    emit.rank_by)
            agg = compiled.read_slot(stage.carry, slot)
            for kid in ids[valid]:
                records.append((table.label(int(kid)), self._aggregate_value(
                    emit.aggregation, agg[kid, 0], agg[kid, 1])))
            # rank order, heaviest first (ties break on bucket id)
        elif emit.kind == "join":
            agg = compiled.read_slot(stage.carry, slot)
            lkind, rkind = emit.join_aggs
            lt, rt = stage.tables
            if lt is rt:
                # hashed join: both sides share one bucket space — match by
                # bucket id, label from the shared table
                both = np.nonzero((agg[:, 1] > 0) & (agg[:, 3] > 0))[0]
                for kid in both:
                    records.append((lt.label(int(kid)), [
                        self._aggregate_value(lkind, agg[kid, 0],
                                              agg[kid, 1]),
                        self._aggregate_value(rkind, agg[kid, 2],
                                              agg[kid, 3]),
                    ]))
            else:
                # dense join (possibly asymmetric key spaces): each side
                # owns its dictionary, so equality is by label
                left = {lt.label(int(k)): int(k)
                        for k in np.nonzero(agg[:lt.num_buckets, 1] > 0)[0]}
                for rk in np.nonzero(agg[:rt.num_buckets, 3] > 0)[0]:
                    lab = rt.label(int(rk))
                    lk = left.get(lab)
                    if lk is None:
                        continue
                    records.append((lab, [
                        self._aggregate_value(lkind, agg[lk, 0], agg[lk, 1]),
                        self._aggregate_value(rkind, agg[rk, 2], agg[rk, 3]),
                    ]))
            records.sort(key=lambda kv: kv[0])
        else:
            agg = compiled.read_slot(stage.carry, slot)
            sums, counts = agg[:, 0], agg[:, 1]
            for kid in np.nonzero(counts > 0)[0]:
                records.append((table.label(int(kid)), self._aggregate_value(
                    emit.aggregation, sums[kid], counts[kid])))
            records.sort(key=lambda kv: kv[0])
        return records

    @lane("driver")
    def _emit_window(self, si: int, window_index: int, slot: int,
                     report: StreamReport) -> None:
        stage = self.stages[si]
        window = stage.assigner.window(window_index)
        records = self._window_records(si, slot)
        out_key = window_output_key(self.prog, window,
                                    prefix=self.prog.stage_prefix(si))
        t_close = stage.tracker.closed_at.get(window_index)
        self._put_window(out_key, records, window.start, window.end, report,
                         t_close=t_close)
        stage.carry = stage.compiled.clear_slot(stage.carry, slot)
        stage.tracker.release(window_index)

    @lane("driver")
    def _emit_session(self, si: int, session, report: StreamReport) -> None:
        stage = self.stages[si]
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

    # -- span admission (shared by record ingestion and the carry handoff) -----
    @lane("driver")
    def _admit_span(self, si: int, lo: int, hi: int, seen: float,
                    ship, flush, report: StreamReport, *ship_args,
                    via: "_EdgeState | None" = None) -> None:
        """Admit windows ``[lo, hi]`` on stage ``si``'s ring and ship the
        span in contiguous segments — the ring/watermark protocol, in one
        place for both transports.

        ``ship(last, n, *ship_args)`` emits one segment covering
        ``[last - n + 1, last]`` (late windows inside it are masked and
        counted on the device).  On a mid-span ring-full, the already-safe
        prefix ships, ``flush()`` folds whatever the caller has staged,
        the watermark advances to ``seen`` (capped by every other input
        channel), ripe windows finalize, and the blocked window retries
        once — a second failure is a genuine capacity error and
        propagates.  A window the watermark closed during the retry stays
        in the span for the device mask (re-admitting it would
        double-count the pair)."""
        stage = self.stages[si]
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
                self._observe_floor(si, seen, via)
                self._finalize_ripe(report, si)
                if not stage.tracker.is_late(widx):
                    stage.tracker.slot_for(widx)
        if hi >= start:
            ship(hi, hi - start + 1, *ship_args)

    # -- the carry handoff (stage N windows → successor batches) ---------------
    @lane("driver")
    def _handoff_device(self, edge: _EdgeState, slot: int, wstart: float,
                        report: StreamReport) -> None:
        """Device edge: re-key/re-window one finalized window of the
        edge's source and fold it into the destination's carry without
        the aggregates visiting the host.  Admission (which target windows
        are open) stays on the host — scalar math on the window's start —
        through the same ``_admit_span`` protocol as record ingestion."""
        dst = self.stages[edge.spec.dst]
        asg = dst.assigner
        w0 = asg.window(0)
        step = asg.window(1).start - w0.start
        rel = wstart - w0.start
        last = int(math.floor(rel / step))
        if dst.plan.window.slide is None:
            first = last
        else:
            first = int(math.floor((rel - w0.size) / step)) + 1
        dst.window_base = (first // dst.plan.n_slots) * dst.plan.n_slots
        self._admit_span(
            edge.spec.dst, first, last, wstart,
            lambda seg_last, n: self._handoff_step(edge, slot, seg_last, n,
                                                   report),
            lambda: None, report, via=edge)

    @lane("driver")
    def _handoff_step(self, edge: _EdgeState, slot: int, last: int,
                      n_windows: int, report: StreamReport) -> None:
        """One handoff: the source's finalized slot relabelled through the
        *edge's* table, re-windowed and folded through the destination
        side's step — two launches queued on one stream (the rows, then
        ``fused_fold``), no host copy between them.  The relabel table is
        copied to the device first when it grew since the last handoff."""
        src = self.stages[edge.spec.src]
        dst = self.stages[edge.spec.dst]
        if edge.relabel_dev is None:
            edge.relabel_dev = torch.tensor(edge.relabel, dtype=torch.int32,
                                            device=src.carry.device)
        base = dst.window_base
        rows = src.compiled.handoff_rows(
            src.carry, slot, edge.relabel_dev, last - base, n_windows,
            src.plan.emit.aggregation, dst.wire_rows)
        stats = self._fold(edge.spec.dst, rows, report,
                           self._device_bound(dst), edge.spec.dst_side)
        self._account_stats(edge.spec.dst, stats, report)

    @lane("driver")
    def _feed(self, edge: _EdgeState, records: list,
              report: StreamReport) -> None:
        """Host edge: one finalized window's records, materialized and fed
        through the destination's ordinary ingestion (its inter-stage maps
        and ``key_by`` apply here), side-tagged for a join destination."""
        si, side = edge.spec.dst, edge.spec.dst_side
        recs = self._stage_recs(si, [(r[0], r[1], r[2], side)
                                     for r in records],
                                report, count_in=False)
        if not recs:
            return
        if self.prog.fanout == "device":
            self._ingest_device(si, recs, report, via=edge)
        else:
            self._ingest_host(si, recs, report, via=edge)

    @lane("driver")
    def _observe(self, si: int) -> None:
        """Advance stage ``si``'s watermark to the minimum over its input
        channels — the external stream's observed event time (roots) and
        each in-edge's feed watermark.  A join over a lagging input holds
        its windows open until *every* channel has passed them; a root's
        external channel counts from the start (at -inf until its first
        batch lands)."""
        cands = [e.fed for e in self._in.get(si, ())]
        if si in self._roots:
            cands.append(self._ext_wm.get(si, _NEG_INF))
        if cands:
            self.stages[si].tracker.observe(min(cands))

    @lane("driver")
    def _observe_floor(self, si: int, seen: float,
                       via: "_EdgeState | None") -> None:
        """The mid-batch ring-full recovery's watermark advance: the
        *active* input channel (the external stream, or the in-edge
        ``via`` currently feeding) stands at ``seen``, but every OTHER
        input channel still caps the watermark at its feed position, so
        the recovery can never close a window a lagging channel could
        still feed."""
        cands = [seen]
        for e in self._in.get(si, ()):
            if e is not via:
                cands.append(e.fed)
        if via is not None and si in self._roots:
            cands.append(self._ext_wm.get(si, _NEG_INF))
        self.stages[si].tracker.observe(min(cands))

    @lane("driver")
    def _finalize_stage(self, si: int, report: StreamReport) -> set[int]:
        """Emit (terminal stage) or hand off (one delivery per out-edge)
        every window stage ``si``'s watermark has passed; returns the
        destination stages fed."""
        stage = self.stages[si]
        out = self._out.get(si, ())
        if stage.plan.is_session:
            for session in stage.tracker.ripe():
                self._emit_session(si, session, report)
                report.windows_emitted += 1
            return set()    # sessions run in single-stage pipelines only
        fed: set[int] = set()
        for window_index, slot in stage.tracker.ripe():
            if not out:
                self._emit_window(si, window_index, slot, report)
                report.windows_emitted += 1
                continue
            window = stage.assigner.window(window_index)
            host_records = None
            for edge in out:
                if edge.spec.device:
                    self._handoff_device(edge, slot, window.start, report)
                else:
                    if host_records is None:    # materialize at most once
                        host_records = self._window_records(si, slot)
                    self._feed(edge, [(window.start, key, value)
                                      for key, value in host_records],
                               report)
                edge.fed = max(edge.fed, window.start)
                fed.add(edge.spec.dst)
                report.handoffs += 1
            stage.carry = stage.compiled.clear_slot(stage.carry, slot)
            stage.tracker.release(window_index)
        if out and stage.tracker.watermark == float("inf"):
            # end of stream: no further window can ever be fed over these
            # edges, so successors may close everything they hold
            for edge in out:
                edge.fed = float("inf")
                fed.add(edge.spec.dst)
        return fed

    def _finalize_ripe(self, report: StreamReport, si: int = 0) -> None:
        """Finalize every ripe window of stage ``si`` and cascade the
        handoffs through the DAG in one forward sweep."""
        self._finalize_sweep(report, {si})

    def _finalize_sweep(self, report: StreamReport,
                        touched: set[int]) -> None:
        """One forward topological sweep, then one batched sink flush for
        everything it emitted: stages are stored in topological order and
        every edge points forward, so by the time the sweep reaches a
        stage, all of this round's feeds into it — both sides of a
        downstream join included — have landed."""
        for si in range(len(self.stages)):
            if si not in touched:
                continue
            for dst in self._finalize_stage(si, report):
                self._observe(dst)
                touched.add(dst)
        self._flush_sinks(report)

    # -- checkpoint / restore --------------------------------------------------
    @lane("barrier")
    def save_state(self) -> None:
        """Persist the full streaming state at a batch boundary: every
        stage's carry (as the reference's npz of pytree leaves) to the
        object store; trackers, key dictionaries, per-edge feed watermarks
        and the consumed *record* offset to the metadata store.  Only
        after the drain lane has emptied: staged sink writes must be
        durable before the offset advances, and deferred stats must be
        applied so the snapshot's late-drop counters match the synchronous
        loop's."""
        if self._pending_puts or self._pending_stats:
            raise RuntimeError(
                "internal: checkpoint requested with an undrained lane "
                f"({len(self._pending_puts)} staged sink writes, "
                f"{len(self._pending_stats)} deferred stats reads); "
                "checkpoints must follow the batch-boundary drain")
        leaves = [leaf.to("cpu", copy=True).numpy() for st in self.stages
                  for leaf in _carry_leaves(
                      st.compiled.checkpoint_carry(st.carry))]
        if self._writer:
            buf = io.BytesIO()
            np.savez(buf, **{f"leaf{i}": leaf
                             for i, leaf in enumerate(leaves)})
            self.store.put(_carry_key(self.prog.job_id), buf.getvalue())
        self.meta.set(_state_key(self.prog.job_id), {
            "offset": self._records_consumed,
            "carry_shapes": [list(leaf.shape) for leaf in leaves],
            "edge_fed": [e.fed for e in self.edges],
            "stages": [{
                "tracker": st.tracker.state_dict(),
                "tables": [t.state_dict() for t in self._unique_tables(st)],
            } for st in self.stages],
        })
        self._axis.barrier()    # every rank past the write before any reads

    def restore_state(self) -> int:
        """Load a prior run's checkpoint (this package's or the
        reference's); returns the record offset to resume from (0 when
        starting fresh).  Also lists the windows the prior run already
        persisted under every terminal sink, so the replay of the
        uncheckpointed tail does not re-write them."""
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
        if len(state["stages"]) != len(self.stages) \
                or len(state.get("edge_fed", [])) != len(self.edges):
            raise ValueError(
                f"checkpoint for job {self.prog.job_id} holds "
                f"{len(state['stages'])} stages but this program has "
                f"{len(self.stages)}; the pipeline changed under the job")
        shapes = [tuple(s) for s in state["carry_shapes"]]
        images = [st.compiled.checkpoint_carry(st.carry)
                  for st in self.stages]
        mine = [tuple(leaf.shape) for image in images
                for leaf in _carry_leaves(image)]
        if shapes != mine:
            raise ValueError(
                f"checkpointed carry shapes {shapes} do not match this "
                f"coordinator's {mine}; the streaming config changed under "
                f"job {self.prog.job_id}")
        blob = self.store.get(_carry_key(self.prog.job_id))
        with np.load(io.BytesIO(blob)) as loaded:
            arrays = [loaded[f"leaf{i}"] for i in range(len(mine))]
        at = 0
        for st, image in zip(self.stages, images):
            n = len(_carry_leaves(image))
            st.carry = st.compiled.restore_carry(_restore_carry(
                image, arrays[at:at + n], st.compiled.device))
            at += n
        for st, sdict in zip(self.stages, state["stages"]):
            st.tracker.load_state_dict(sdict["tracker"])
            for table, tdict in zip(self._unique_tables(st),
                                    sdict["tables"]):
                table.load_state_dict(tdict)
        # rebuild every edge's relabel table from the restored dictionaries
        # (eager registration means every label already has a destination
        # id — nothing is created here) and restore the feed watermarks
        # driving min-over-inputs observation
        for e, fed in zip(self.edges, state["edge_fed"]):
            e.fed = float(fed)
            if e.relabel is None:
                continue
            src_table = self.stages[e.spec.src].tables[0]
            dst_table = self.stages[e.spec.dst].tables[e.spec.dst_side]
            for kid, key in enumerate(src_table.dense_keys):
                e.relabel[kid] = dst_table.key_id(str(key))
            e.relabel_dev = None
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
    def _ingest_device(self, si: int, recs, report: StreamReport,
                       via: "_EdgeState | None" = None) -> None:
        """Device fan-out ingestion: one 5-column row per record; window
        *indices* are assigned host-side in float64 (bit-identical to the
        host-fan-out assigner) but the event × window expansion happens in
        the kernel.  A batch that spans more windows than the ring holds
        folds and finalizes mid-batch instead of aborting.  Each record
        folds through its side's plan; a join's two sides share the carry,
        so one pass interleaves them safely."""
        stage = self.stages[si]
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
        n_sides = len(stage.plan.sides)
        shape = (stage.wire_rows, 5)
        rows = [np.zeros(shape, np.float32) for _ in range(n_sides)]
        n = [0] * n_sides

        def fold_staged() -> None:
            for s in range(n_sides):
                if n[s]:
                    self._fold_device(si, rows[s], report, s)
                    rows[s] = np.zeros(shape, np.float32)
                    n[s] = 0

        def ship(seg_last: int, nw: int, side: int, kid: int,
                 value: float) -> None:
            rows[side][n[side]] = (seg_last - base, nw, kid, value, 1.0)
            n[side] += 1

        seen = _NEG_INF             # stream position within this round
        for i, (tsi, key, value, side) in enumerate(recs):
            seen = tsi if tsi > seen else seen
            kid = stage.tables[side].key_id(key)
            self._admit_span(si, int(first[i]), int(last[i]), seen, ship,
                             fold_staged, report, side, kid, value, via=via)
        for s in range(n_sides):
            self._fold_device(si, rows[s], report, s)

    @lane("driver")
    def _ingest_host(self, si: int, recs, report: StreamReport,
                     via: "_EdgeState | None" = None) -> None:
        """Host fan-out: expand every record into one row per containing
        window on the host (numpy).  Host-dropped pairs are counted here
        through the tracker's single accounting entry point."""
        stage = self.stages[si]
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
                        self._fold(si, rows, report)
                        report.records_expanded += n
                        rows = np.zeros_like(rows)
                        n = 0
                    self._observe_floor(si, seen, via)
                    self._finalize_ripe(report, si)
                    slot = stage.tracker.slot_for(widx)
                if slot is None:        # late: window already emitted
                    stage.tracker.note_late(1)
                    continue
                rows[n] = (slot, stage.tables[0].key_id(key), value, 1.0)
                n += 1
        report.records_expanded += n
        self._fold(si, rows, report)

    @lane("driver")
    def _ingest_session(self, si: int, recs, report: StreamReport) -> None:
        """Session ingestion: the tracker assigns each admitted event a
        carry cell (slot, bucket), merging bridged sessions; rows ship on
        the host wire with fan-out 1.  Cell merges apply *after* folding
        the rows already staged for the source cells, so the carry and the
        tracker never disagree about where a session lives."""
        stage = self.stages[si]
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
                self._fold(si, rows, report)
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
                self._finalize_ripe(report, si)
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

    @staticmethod
    def _unique_tables(st: _StageState) -> list[_KeyTable]:
        """A stage's tables deduped by identity — a hashed join aliases
        one shared table in both side slots."""
        seen: list[_KeyTable] = []
        for table in st.tables:
            if not any(table is u for u in seen):
                seen.append(table)
        return seen

    def _late_dropped(self) -> int:
        return sum(st.tracker.late_dropped for st in self.stages)

    def _total_collisions(self) -> int:
        return sum(table.collisions for st in self.stages
                   for table in self._unique_tables(st))

    @lane("prefetch")
    def _prepare_batch(self, batch: MicroBatch) -> _PreparedBatch:
        """Prepare-lane work for one micro-batch: size check, routing each
        record to its external input's root stage, and the fused map
        chains.  Reads only the immutable program, so the prefetch thread
        runs it for batch N+1 while the main thread folds batch N."""
        prog = self.prog
        if len(batch.records) > prog.batch_records:
            raise ValueError(
                f"micro-batch {batch.index} carries {len(batch.records)} "
                f"records but the coordinator was sized for batch_records="
                f"{prog.batch_records}; create the StreamSource with "
                f"batch_records <= the coordinator's")
        if len(prog.inputs) == 1:
            # single-input fast path: no per-record re-tagging (the input
            # lands at stage 0, side 0)
            groups: dict[int, list] = {0: batch.records}
        else:
            groups = {}
            for rec in batch.records:
                tag = int(rec[3]) if len(rec) > 3 else 0
                si, side = prog.inputs[tag]
                groups.setdefault(si, []).append(
                    (rec[0], rec[1], rec[2], side))
        return _PreparedBatch(
            index=batch.index, n_records=len(batch.records),
            max_event_time=batch.max_event_time,
            groups={si: self._transform_recs(si, raw)
                    for si, raw in groups.items()})

    def _process_prepared(self, prep: _PreparedBatch,
                          report: StreamReport) -> None:
        """Fold + drain lanes for one prepared micro-batch: admit → fold
        (device) → watermark → finalize, cascading finalized windows
        through the DAG in one topological sweep, then drain the deferred
        stats at the barrier and checkpoint if due."""
        prog = self.prog
        t0 = time.perf_counter()
        self.bus.poll(self.consumer_group, TOPIC_STREAM_BATCH,
                      timeout=0.01, max_records=1)
        self._autoscale(report)
        late_before = self._late_dropped()
        report.records_in += prep.n_records
        for si in sorted(prep.groups):
            recs = prep.groups[si]
            if not recs:
                continue
            self._grow_wire(si, recs)
            stage = self.stages[si]
            if stage.plan.is_session:
                self._ingest_session(si, recs, report)
            elif prog.fanout == "device":
                self._ingest_device(si, recs, report)
            else:
                self._ingest_host(si, recs, report)
        # every root shares the merged stream's event-time watermark (a
        # two-input join consumes one merged, side-tagged source)
        for si in self._roots:
            self._ext_wm[si] = max(self._ext_wm.get(si, _NEG_INF),
                                   prep.max_event_time)
            self._observe(si)
        self._finalize_sweep(report, set(self._roots))
        self._drain_stats(report)       # micro-batch barrier: lanes empty
        report.late_dropped += self._late_dropped() - late_before
        report.hash_collisions = self._total_collisions()
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
        the real watermark, not +inf), then ripple an end-of-stream
        watermark (+inf) through every stage in topological order and
        drain the lanes."""
        if report.batches and self._ckpt_interval:
            self.save_state()
        for si in range(len(self.stages)):
            if si in self._roots:
                self._ext_wm[si] = float("inf")
            self.stages[si].tracker.observe(float("inf"))
            self._finalize_ripe(report, si)
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

    # -- introspection ---------------------------------------------------------
    def checkpointed_offset(self) -> int:
        """Record offset of this job's last barrier checkpoint (0 when
        none)."""
        return saved_offset(self.meta, self.prog.job_id)

    def pool_stats(self) -> dict[str, Any]:
        """The fold pool's counters (replicas, invocations, scale events)."""
        return self.pool.stats()

    # Public seam for external drive loops (the job server's overlapped
    # multi-tenant scheduler): the prepare-lane and fold/drain-lane halves
    # of process_batch, so a driver can run many jobs' prepare lanes on
    # threads while folding each job's batches in order on its own thread.
    # Prepare is host work only; every CUDA call stays in process_prepared,
    # on the driving thread's current stream.
    def prepare_batch(self, batch: MicroBatch) -> _PreparedBatch:
        """Host-prepare one micro-batch (pure, prefetch-lane safe) — the
        first half of ``process_batch``, exposed for external drivers."""
        return self._prepare_batch(batch)

    def process_prepared(self, prep: _PreparedBatch,
                         report: StreamReport) -> None:
        """Fold/drain one prepared batch on the driver thread in batch
        order — the second half of ``process_batch``, exposed for
        external drivers."""
        return self._process_prepared(prep, report)


# Same seam: the bounded prepare-lane thread run_stream uses, exported so
# external drivers multiplex one per job instead of reinventing the
# ("batch" | "end" | "error") handoff protocol.
Prefetcher = _Prefetcher


def saved_offset(meta: MetadataStore, job_id: str) -> int:
    """Record offset of ``job_id``'s last barrier checkpoint in ``meta``
    (0 when none) — readable without constructing a coordinator.  The job
    server reports a parked/re-attached job's position from this instead
    of the pre-park live counters, which die with the coordinator."""
    state = meta.get(_state_key(job_id))
    return int(state["offset"]) if state else 0
