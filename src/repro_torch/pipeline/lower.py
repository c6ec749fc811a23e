"""Graph validation and lowering — pipeline nodes → execution plans.

``build_pipeline`` walks a ``Pipeline`` graph, validates the stage grammar
(one source; maps fuse; ``window`` before ``reduce``; ``top_k`` only over
an aggregate reduce; joins windowed and reduced on both sides, in
aggregate mode) and lowers
each stage chain onto ``repro_torch.engine``, compiled on the build's
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``):

* record chains → one ``ExecutionPlan`` per side: the fused fold over a
  flat carry slab; adjacent ``map`` nodes fuse into a single host
  transform;
* a chain that continues *past* a reduce — ``…reduce(...).map(...)
  .key_by(...).window(...).reduce(...)`` — splits at each reduce boundary
  into a **sequence of stages**, each with its own plan and carry; a
  finalized window of stage N becomes stage N+1's input batch through a
  carry *handoff* (``engine.stages.carry_handoff_rows`` — on the device
  when the boundary has no host transform, the host record path
  otherwise);
* ``tee(branch, …)`` → a stage **DAG**: the teed stage keeps one carry but
  gains several out-*edges* (``BuiltPipeline.edges``), one per branch;
  each edge picks its own transport and, at run time, its own bucket →
  next-key relabel table; a join's two inputs may be multi-stage chains,
  so a stage may also have two in-edges.  Stages are emitted in
  topological order (every edge points forward) and every terminal stage
  of a fan-out carries its own distinct sink prefix;
* stage-local ``reduce(..., num_buckets=, n_slots=)`` options override the
  build-wide defaults per ``StagePlan``;
* a windowed join → **two plans sharing one carry**: each side's plan
  folds its ``[value, 1]`` pair into a disjoint channel pair
  (``ReduceSpec.channel_base`` 0 and 2 of a 4-channel carry); per-side
  key-space sizes (``num_buckets=(left, right)``) widen the shared carry
  to the larger side (``ReduceSpec.carry_buckets``) while each side
  buckets within its own declared space;
* ``Windowing.session(gap)`` → the engine's ``WindowSpec.session``
  variant (host-wire fold, cell-addressed carry), in single-stage
  pipelines only;
* ``top_k(k)`` → ``ReduceSpec(mode="top_k")`` — the aggregate fold plus
  the fixed-capacity heavy-hitters selection at finalization;
* ``reduce(spec, mode="group", capacity=C)`` (or a callable ``spec``) →
  ``ReduceSpec(mode="group")``: on a windowed stage a
  ``CompiledStreamGroup`` (record buffers per worker and window slot,
  device fan-out wire only), whose finalized windows emit, or feed a
  successor over a host edge, as ``(label, value)`` records;
* an array pipeline (``from_source(shards=...)``) with its one ``map``
  node, the device UDF, → a batch ``ExecutionPlan`` (no window) compiled
  to a ``CompiledBatchPlan`` (``BuiltPipeline.batch_plan``), aggregate or
  group.

The result is a ``BuiltPipeline`` — the program the
``StreamingCoordinator`` drives (streaming mode) and the batch runner
drives once over the whole input (batch mode), with bit-identical
per-window output bytes on every branch; an array pipeline's program runs
once over its shards.

``backend`` picks where the workers live (``engine.compile.BACKENDS``):
the port's ``"fused"`` default, ``"vmap"`` (simulated workers in the
reference's per-worker layouts) or ``"shard_map"`` (one
``torch.distributed`` rank a worker, ``group=`` or the default group).
Under the last two an aggregate stage's ``num_buckets`` must divide by
``n_workers``, as the reference requires; a join under ``"shard_map"``
is not ported yet and raises ``NotImplementedError`` naming the
``ROADMAP.md`` item — nothing falls back.
"""

from __future__ import annotations

import dataclasses
import uuid
from dataclasses import dataclass
from typing import Any, Callable

from ..engine.plan import (BACKEND, ExecutionPlan, KeySpace, ReduceSpec,
                           WindowSpec, not_ported)
from ..engine.stages import SEGMENT_REDUCE_KINDS
from ..streaming.sessions import SessionTracker
from ..streaming.state import WindowTracker
from ..streaming.windows import SlidingWindows, TumblingWindows
from .graph import Pipeline, PipelineError, Windowing

AGGREGATE_KINDS = ("count", "sum", "mean")

#: canonical stage order within one chain (source implicit at rank 0)
_STAGE_RANK = {"source": 0, "map": 1, "key_by": 2, "window": 3,
               "reduce": 4, "top_k": 5, "join": 6, "tee": 6, "sink": 7}

_ORDER_HINT = ("stage order is source → map* → key_by → window → reduce "
               "→ top_k → join/tee → sink; a chain may continue past a "
               "reduce with another map* → key_by → window → reduce stage")

_ARRAY_ONE_SHOT = ("array pipelines are one-shot batch jobs: no window/join/"
                   "tee nodes and no continued stages")


def _default_key(rec) -> Any:
    return rec[1]


def _default_value(rec) -> float:
    return float(rec[2])


def fuse_maps(fns: list[Callable]) -> Callable | None:
    """Fuse adjacent record maps into one stage: apply in order, treating
    ``None`` as filter and an iterable of records as flat-map."""
    if not fns:
        return None
    if len(fns) == 1:
        return fns[0]

    def fused(rec):
        pending = [rec]
        for fn in fns:
            nxt = []
            for r in pending:
                out = fn(r)
                if out is None:
                    continue
                if isinstance(out, tuple):
                    nxt.append(out)
                else:
                    nxt.extend(out)
            pending = nxt
        return pending

    return fused


@dataclass(frozen=True)
class SourceSpec:
    """Where one side's records come from (bound at build or at run).
    ``kind="carry"`` marks a continued stage: its input is the previous
    stage's finalized windows, handed off through the carry."""

    kind: str           # "log" | "records" | "array" | "unbound" | "carry"
    prefix: str | None = None
    records: list | None = None
    batch_records: int = 1024
    shards: Any = None  # array pipelines: the worker shards


@dataclass(frozen=True)
class _Chain:
    """One parsed linear stage chain (a join has two; a multi-stage
    pipeline has one per reduce boundary)."""

    source: SourceSpec
    transform: Callable | None
    key_fn: Callable
    value_fn: Callable
    windowing: Windowing | None
    reduce_spec: str | Callable
    reduce_mode: str
    capacity: int = 0               # group mode: the record buffer bound
    top: dict | None = None         # this stage's top_k node, if any
    options: dict = dataclasses.field(default_factory=dict)  # stage-local


@dataclass(frozen=True)
class SidePlan:
    """One side's lowered stage chain: the fused host transform plus the
    compiled execution plan folding into its channel pair of the carry.
    ``num_buckets`` is the side's *own* key-space width — for asymmetric
    joins it can be narrower than the shared carry."""

    name: str
    source: SourceSpec
    transform: Callable | None
    key_fn: Callable
    value_fn: Callable
    compiled: Any
    channel_base: int = 0
    num_buckets: int = 0


@dataclass(frozen=True)
class EmitSpec:
    """How a finalized window turns into output records — the store
    emission of a terminal stage, or the handoff records of an
    intermediate one."""

    kind: str                       # "aggregate" | "group" | "top_k" | "join"
    aggregation: str = "count"      # aggregate / session emission kind
    reduce_fn: str | Callable = "sum"   # group: the reducer
    k: int = 0
    rank_by: str = "sum"            # top_k ranking kind
    join_aggs: tuple = ("sum", "sum")


@dataclass(frozen=True)
class StageEdge:
    """One edge of the stage DAG: finalized windows of stage ``src``
    become input batches of stage ``dst``, folding into side ``dst_side``
    of its carry (a join destination has two sides).  ``device`` picks the
    on-device handoff transport; ``eager`` marks an identity boundary
    whose destination key dictionary registers eagerly.  Each edge owns
    its own bucket → next-key relabel table at run time — a teed stage
    with several out-edges relabels independently per successor."""

    src: int
    dst: int
    dst_side: int = 0
    device: bool = False
    eager: bool = False


@dataclass(frozen=True)
class StagePlan:
    """One lowered stage of the DAG: its compiled side plan(s), window
    shape (``None`` for an array pipeline), and emission/handoff spec.  A
    plain pipeline has one stage; a windowed join has one stage with two
    sides; a multi-stage chain has one per reduce boundary; a tee'd graph
    has one per branch stage.  ``BuiltPipeline.edges`` wires them — a
    stage with no out-edges emits to the store (under ``output_prefix``
    when set, the pipeline default otherwise)."""

    index: int
    sides: tuple[SidePlan, ...]
    window: Windowing | None
    mode: str                       # fold machinery: "aggregate" | "group"
    emit: EmitSpec
    num_buckets: int                # carry bucket width (max over sides)
    n_slots: int
    allowed_lateness: float
    capacity: int = 0               # group mode: the record buffer bound
    handoff_device: bool = False    # every out-edge hands off on device
    #: every out-edge passes keys through unchanged (no host transform,
    #: default key_by, aggregate emission) — each successor's dense
    #: dictionary registers a key the moment this stage first sees it, so
    #: both handoff transports (and every checkpoint) agree on the id
    #: order
    eager_boundary: bool = False
    output_prefix: str | None = None    # terminal stages: this sink's prefix

    @property
    def is_session(self) -> bool:
        return self.window is not None and self.window.is_session

    @property
    def is_join(self) -> bool:
        return len(self.sides) == 2

    def assigner(self):
        """Fixed-window assigner (None for session windows)."""
        w = self.window
        if w is None or w.is_session:
            return None
        if w.kind == "tumbling":
            return TumblingWindows(w.size)
        return SlidingWindows(w.size, w.slide)

    def make_tracker(self):
        if self.window.is_session:
            return SessionTracker(self.window.gap, self.n_slots,
                                  self.allowed_lateness)
        return WindowTracker(self.assigner(), self.n_slots,
                             self.allowed_lateness)


@dataclass
class BuiltPipeline:
    """A validated, lowered pipeline — the program both execution modes
    drive, with its carries on ``device`` — or an array pipeline's one-shot
    ``batch_plan``.  ``stages`` is the executable DAG in topological order:
    one entry for a plain chain or join, several for a multi-stage or
    tee'd graph wired by the carry-handoff ``edges`` (every edge points
    forward).  ``inputs`` maps each external input stream to its ``(stage,
    side)`` ingestion point — one entry for a plain pipeline, two for a
    join (whether its sides are single- or multi-stage chains)."""

    stages: tuple[StagePlan, ...]
    num_buckets: int                # stage-0 carry bucket width
    n_workers: int
    n_slots: int
    batch_records: int
    key_space: str
    fanout: str
    allowed_lateness: float
    checkpoint_interval: int
    output_prefix: str
    job_id: str
    device: Any
    backend: str = BACKEND
    handoff: str = "device"
    batch_plan: Any = None          # array pipelines: CompiledBatchPlan
    edges: tuple[StageEdge, ...] = ()
    inputs: tuple[tuple[int, int], ...] = ((0, 0),)

    # -- views of the DAG -------------------------------------------------------
    @property
    def sides(self) -> tuple[SidePlan, ...]:
        """Stage 0's side plans (one, or a join's two)."""
        return self.stages[0].sides

    @property
    def is_array(self) -> bool:
        """An array (batch) pipeline: no window, one ``batch_plan`` run."""
        return self.stages[0].window is None

    @property
    def is_join(self) -> bool:
        return any(st.is_join for st in self.stages)

    @property
    def is_multistage(self) -> bool:
        return len(self.stages) > 1

    @property
    def final_stages(self) -> tuple[int, ...]:
        """Stages with no out-edge — the DAG's terminal stages, each
        emitting finalized windows to its own output prefix."""
        srcs = {e.src for e in self.edges}
        return tuple(i for i in range(len(self.stages)) if i not in srcs)

    def stage_prefix(self, si: int) -> str:
        """The output prefix stage ``si`` emits under (its own sink, or
        the pipeline default)."""
        return self.stages[si].output_prefix or self.output_prefix

    def output_prefixes(self) -> tuple[str, ...]:
        """One normalized ``<sink>/<job_id>/`` key prefix per terminal
        stage — everywhere this program's windows land in the store."""
        return tuple(dict.fromkeys(
            f"{self.stage_prefix(si).rstrip('/')}/{self.job_id}/"
            for si in self.final_stages))

    def collect_outputs(self, store) -> dict:
        """Every window this program has persisted, across all of its
        terminal sinks, keyed by object key."""
        return {m.key: store.get(m.key)
                for prefix in self.output_prefixes()
                for m in store.list_objects(prefix)}

    def one_shot(self, total_records: int) -> "BuiltPipeline":
        """The same program re-sized to fold the whole input as one batch
        with checkpointing off — how batch mode drives it."""
        return dataclasses.replace(self, batch_records=max(total_records, 1),
                                   checkpoint_interval=0)

    # -- static analysis -------------------------------------------------------
    def check(self, *, source_prefixes=()) -> list:
        """Run planlint over the lowered program: a list of ``Diagnostic``
        records, empty when clean.  ``Pipeline.build`` warns on these;
        ``JobServer.submit`` rejects error-level findings."""
        from ..analysis.planlint import check_plan
        return check_plan(self, source_prefixes=source_prefixes)

    def explain(self, *, source_prefixes=()) -> str:
        """Human-readable program summary — every stage's window/ring/
        bucket geometry, every edge's transport — plus the full planlint
        report."""
        from ..analysis.planlint import explain_plan
        return explain_plan(self, source_prefixes=source_prefixes)

    # -- execution -------------------------------------------------------------
    def run(self, source_or_data=None, *, options=None, store=None,
            meta=None, sources=None, bus=None, autoscaler=None, pool=None,
            announce: bool = True, flush: bool = True,
            mode: str | None = None):
        """The one front door for executing the program: a
        ``StreamSource``/``JoinSource`` (or a pair with a live side)
        streams through the pipelined coordinator, an in-memory record
        list (or a join's pair of lists, or an array pipeline's shards)
        runs as one batch, and ``None`` falls back to the graph's bound
        source.  Returns a ``StreamReport`` (streaming), ``(outputs,
        report)`` (windowed batch) or ``(result, stats)`` (array)."""
        from .runtime import run
        return run(self, source_or_data, options=options, store=store,
                   meta=meta, sources=sources, bus=bus,
                   autoscaler=autoscaler, pool=pool, announce=announce,
                   flush=flush, mode=mode)

    def run_batch(self, store=None, *, data=None, source=None, sources=None,
                  options=None):
        """One-shot pinned explicitly — :meth:`run` with ``mode="batch"``:
        an array pipeline runs its batch plan over ``data`` (or the bound
        shards) and returns ``(result, stats)``; a windowed pipeline folds
        ``source`` (``sources=(left, right)`` for a join) in one pass and
        returns ``(outputs, report)``."""
        from .runtime import run_batch
        return run_batch(self, store, data=data, source=source,
                         sources=sources, options=options)


def assert_no_prefix_collision(prefixes: "tuple[str, ...] | list[str]",
                               claimed: dict[str, str]) -> None:
    """Cross-job twin of the build-time distinctness check: reject a new
    job whose normalized output prefixes collide with — equal, contain, or
    fall under — a prefix another job already claimed on the *same* shared
    ObjectStore.  ``claimed`` maps normalized prefix → owning job id.
    Overlap (not just equality) is the collision condition because
    ``collect_outputs`` and resume scans are prefix listings: a job whose
    prefix nests inside another's would see — and count — its neighbor's
    windows.
    """
    for pfx in prefixes:
        p_norm = pfx.rstrip("/") + "/"
        for other, owner in claimed.items():
            if p_norm.startswith(other) or other.startswith(p_norm):
                raise PipelineError(
                    f"output prefix {p_norm!r} collides with {other!r} "
                    f"already claimed by job {owner!r} on this store — "
                    f"jobs sharing one ObjectStore need disjoint sink "
                    f"prefixes (distinct sinks, job ids, or tenant "
                    f"namespaces)")


# ---------------------------------------------------------------------------
# Parsing + validation
# ---------------------------------------------------------------------------

def _parse_chain(p: Pipeline, *, side: str, allow_join: bool,
                 allow_stages: bool = False, on: Callable | None = None,
                 allow_tee: bool = False):
    """Walk one pipeline's nodes into stage chains (split at each reduce
    boundary when ``allow_stages``); returns ``(chains, join_node,
    tee_node, sink_prefix)`` where ``chains[i].top`` carries stage i's
    top_k node and ``tee_node`` is the trailing fan-out, if any."""
    if not p.nodes or p.nodes[0].op != "source":
        raise PipelineError(f"{side}: a pipeline starts at "
                            f"Pipeline.from_source(...)")
    src = p.nodes[0].params
    is_array = src["kind"] == "array"
    source = SourceSpec(
        kind="carry" if src["kind"] == "carry-stub" else src["kind"],
        prefix=src["prefix"], records=src["records"],
        batch_records=src["batch_records"], shards=src["shards"])
    chains: list[_Chain] = []
    join_node = None
    tee_node = None
    sink_prefix = None

    def _fresh():
        return {"maps": [], "key_fn": None, "windowing": None,
                "reduce": None, "top": None}

    def _close(stage: dict) -> None:
        n = len(chains)
        if stage["reduce"] is None:
            what = "a pipeline" if n == 0 else f"stage {n + 1} of the chain"
            raise PipelineError(
                f"{side}: {what} needs a reduce node ({_ORDER_HINT})")
        if is_array and len(stage["maps"]) != 1:
            raise PipelineError("array pipelines need exactly one map node "
                                "(the device UDF)")
        chains.append(_Chain(
            source=source if n == 0 else SourceSpec(kind="carry"),
            transform=fuse_maps(stage["maps"]),
            key_fn=stage["key_fn"] or _default_key,
            value_fn=_default_value,
            windowing=stage["windowing"],
            reduce_spec=stage["reduce"]["spec"],
            reduce_mode=stage["reduce"]["mode"],
            capacity=stage["reduce"]["capacity"],
            top=stage["top"],
            options={k: stage["reduce"][k]
                     for k in ("num_buckets", "n_slots")
                     if stage["reduce"].get(k) is not None}))

    stage = _fresh()
    rank = 0
    for node in p.nodes[1:]:
        r = _STAGE_RANK.get(node.op)
        if r is None:
            raise PipelineError(f"unknown node op {node.op!r}")
        if node.op == "source":
            raise PipelineError(f"{side}: more than one source")
        if is_array and (node.op in ("window", "join", "tee") or (
                stage["reduce"] is not None
                and r <= _STAGE_RANK["reduce"])):
            raise PipelineError(_ARRAY_ONE_SHOT)
        if sink_prefix is not None:
            raise PipelineError(f"{side}: sink must be the last node")
        if tee_node is not None:
            raise PipelineError(f"{side}: tee is a terminal node — the "
                                f"branches carry their own sinks and "
                                f"continuations")
        if node.op == "tee" and join_node is not None:
            raise PipelineError("tee and join cannot combine in one "
                                "pipeline (tee a downstream pipeline over "
                                "the join output instead)")
        if r < rank or (r == rank and node.op not in ("map",)):
            # past this stage's reduce the chain may continue with a new
            # stage; anything else is an ordering error
            if stage["reduce"] is not None and node.op in (
                    "map", "key_by", "window", "reduce"):
                if not allow_stages:
                    raise PipelineError(
                        f"{side}: this chain ends at its reduce node")
                if join_node is not None:
                    raise PipelineError(
                        "the chain cannot continue past a join (rank the "
                        "join output in a downstream pipeline instead)")
                _close(stage)
                stage = _fresh()
                rank = 0
                r = _STAGE_RANK[node.op]
            else:
                raise PipelineError(
                    f"{side}: {node.op!r} cannot follow a "
                    f"{[k for k, v in _STAGE_RANK.items() if v == rank][0]!r}"
                    f" node — {_ORDER_HINT}")
        rank = r
        if node.op == "map":
            stage["maps"].append(node.params["fn"])
        elif node.op == "key_by":
            stage["key_fn"] = node.params["fn"]
        elif node.op == "window":
            stage["windowing"] = node.params["windowing"]
        elif node.op == "reduce":
            stage["reduce"] = node.params
        elif node.op == "top_k":
            stage["top"] = node.params
        elif node.op == "join":
            if not allow_join:
                raise PipelineError(f"{side}: nested joins are not "
                                    f"supported")
            join_node = node
        elif node.op == "tee":
            if not allow_tee:
                raise PipelineError(f"{side}: tee is not allowed here")
            if stage["reduce"] is None:
                raise PipelineError(f"{side}: tee fans out a *reduced* "
                                    f"stage ({_ORDER_HINT})")
            tee_node = node
        elif node.op == "sink":
            sink_prefix = node.params["prefix"]
    if stage["top"] is not None and join_node is not None:
        raise PipelineError("top_k and join cannot combine (rank the join "
                            "output downstream instead)")
    _close(stage)
    if on is not None:
        chains[-1] = dataclasses.replace(chains[-1], key_fn=on)
    return chains, (join_node if allow_join else None), tee_node, sink_prefix


def _check_windowing(w: Windowing, n_slots: int, lateness: float) -> None:
    if w.kind == "tumbling":
        if w.size <= 0:
            raise PipelineError("tumbling windows need a positive size")
    elif w.kind == "sliding":
        if w.size <= 0 or not w.slide or w.slide <= 0:
            raise PipelineError("sliding windows need positive size and "
                                "slide")
        if w.slide > w.size:
            raise PipelineError("slide > size leaves event-time gaps")
    elif w.kind == "session":
        if w.gap <= 0:
            raise PipelineError("session windows need a positive gap")
        return
    else:
        raise PipelineError(f"unknown windowing kind {w.kind!r}")
    # the ring must hold every window open at one instant — the bound
    # planlint's PL001 reports and WindowTracker enforces at construction
    from ..analysis.planlint import min_slots_required
    need = min_slots_required(w.size, w.slide, lateness)
    if need > n_slots:
        step = w.slide or w.size
        raise PipelineError(
            f"n_slots={n_slots} cannot hold the window span; need >= "
            f"{need} for size={w.size}, slide={step}, lateness={lateness}")


def _check_reduce(chain: _Chain, *, in_join: bool) -> None:
    spec, mode = chain.reduce_spec, chain.reduce_mode
    if mode == "aggregate":
        if not isinstance(spec, str) or spec not in AGGREGATE_KINDS:
            raise PipelineError(f"aggregate reduce must be one of "
                                f"{AGGREGATE_KINDS}, got {spec!r}")
    elif mode == "group":
        if in_join:
            raise PipelineError("join sides must reduce in aggregate mode")
        if chain.capacity < 1:
            raise PipelineError("group mode needs capacity >= 1")
        if isinstance(spec, str) and spec not in SEGMENT_REDUCE_KINDS:
            raise PipelineError(f"group reduce kind must be a callable or "
                                f"one of {SEGMENT_REDUCE_KINDS}")
    else:
        raise PipelineError(f"unknown reduce mode {mode!r}")


def _check_channels_disjoint(sides: "tuple[tuple[int, int], ...]",
                             channels: int) -> None:
    """Plans sharing one carry must claim non-overlapping [base, base+2)
    channel pairs inside the carry's channel count."""
    claimed: set[int] = set()
    for base, width in sides:
        span = set(range(base, base + width))
        if base < 0 or base + width > channels:
            raise PipelineError(
                f"channel window [{base}, {base + width}) exceeds the "
                f"carry's {channels} channels")
        if claimed & span:
            raise PipelineError(
                f"channel window [{base}, {base + width}) overlaps another "
                f"side's channels — plans sharing a carry must stay "
                f"disjoint")
        claimed |= span


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

def _key_space_obj(key_space, num_buckets: int) -> KeySpace:
    """A ``KeySpace`` instance passes through verbatim (the caller
    controls collision tracking); a kind string builds one."""
    if isinstance(key_space, KeySpace):
        return key_space
    if key_space == "hashed":
        return KeySpace.hashed(num_buckets)
    return KeySpace.dense(num_buckets)


def _lower_side(chain: _Chain, name: str, *, num_buckets: int,
                n_workers: int, n_slots: int, key_space, fanout: str,
                backend: str, device, channels: int, channel_base: int,
                carry_buckets: int = 0, top_k: int = 0,
                rank_by: str = "sum", group=None) -> SidePlan:
    """One record chain → its streaming plan on ``device``, folding into
    channels ``[channel_base, channel_base + 2)`` of a ``channels``-wide
    carry ``carry_buckets`` wide (0: the side's own key space)."""
    ks = _key_space_obj(key_space, num_buckets)
    w = chain.windowing
    if w.is_session:
        window = WindowSpec.session(w.gap, n_slots=n_slots)
    else:
        window = WindowSpec(size=w.size, slide=w.slide, n_slots=n_slots,
                            fanout_on_device=fanout == "device")
    carry = 0 if carry_buckets == ks.num_buckets else carry_buckets
    if chain.reduce_mode == "group":
        reduce = ReduceSpec("group", reduce_fn=chain.reduce_spec,
                            capacity=chain.capacity)
    elif top_k:
        reduce = ReduceSpec(mode="top_k", reduce_fn=rank_by, k=top_k,
                            channels=channels, channel_base=channel_base,
                            carry_buckets=carry)
    else:
        reduce = ReduceSpec("aggregate", channels=channels,
                            channel_base=channel_base, carry_buckets=carry)
    plan = ExecutionPlan(key_space=ks, reduce=reduce, n_workers=n_workers,
                         window=window)
    compiled = plan.compile(backend=backend, device=device, group=group)
    return SidePlan(name=name, source=chain.source,
                    transform=chain.transform, key_fn=chain.key_fn,
                    value_fn=chain.value_fn, compiled=compiled,
                    channel_base=channel_base, num_buckets=ks.num_buckets)


def _lower_array(chain: _Chain, *, num_buckets: int, n_workers: int,
                 n_slots: int, key_space, lateness: float, backend: str,
                 finalize: bool, combine_fn, device, group=None):
    """An array chain → its batch plan, compiled with the UDF, and the
    stage (no window) that carries it."""
    if chain.options:
        raise PipelineError("array pipelines take build-wide options only "
                            "(stage-local num_buckets / n_slots size "
                            "windowed record-stage carries)")
    if num_buckets < 1:
        raise PipelineError("num_buckets must be >= 1")
    ks = _key_space_obj(key_space, num_buckets)
    top = chain.top
    if top is not None:
        rank_by = top["by"] or "sum"
        reduce = ReduceSpec(mode="top_k", reduce_fn=rank_by, k=top["k"],
                            combine_fn=combine_fn)
        emit = EmitSpec("top_k", k=top["k"], rank_by=rank_by)
    elif chain.reduce_mode == "group":
        reduce = ReduceSpec("group", reduce_fn=chain.reduce_spec,
                            capacity=chain.capacity)
        emit = EmitSpec("group", reduce_fn=chain.reduce_spec)
    else:
        reduce = ReduceSpec("aggregate", combine_fn=combine_fn)
        emit = EmitSpec("aggregate", aggregation=chain.reduce_spec)
    plan = ExecutionPlan(key_space=ks, reduce=reduce, n_workers=n_workers)
    compiled = plan.compile(chain.transform, backend=backend, device=device,
                            finalize=finalize, group=group)
    side = SidePlan(name="main", source=chain.source,
                    transform=chain.transform, key_fn=chain.key_fn,
                    value_fn=chain.value_fn, compiled=compiled,
                    num_buckets=num_buckets)
    stage = StagePlan(0, (side,), None, chain.reduce_mode, emit,
                      num_buckets, n_slots, lateness, chain.capacity)
    return compiled, stage


def _stage_emit(chain: _Chain, num_buckets: int) -> tuple[EmitSpec, int, str]:
    """One record stage's emission spec + validated top-k parameters."""
    top_k, rank_by = 0, "sum"
    if chain.top is not None:
        if chain.reduce_mode != "aggregate":
            raise PipelineError("top_k ranks an aggregate reduce")
        if chain.top["k"] > num_buckets:
            raise PipelineError("top_k k exceeds the bucket space")
        top_k = chain.top["k"]
        rank_by = chain.top["by"] or chain.reduce_spec
        if rank_by not in AGGREGATE_KINDS:
            raise PipelineError(f"top_k ranks by one of {AGGREGATE_KINDS}")
        emit = EmitSpec("top_k", aggregation=chain.reduce_spec,
                        k=top_k, rank_by=rank_by)
    elif chain.reduce_mode == "group":
        emit = EmitSpec("group", reduce_fn=chain.reduce_spec)
    else:
        emit = EmitSpec("aggregate", aggregation=chain.reduce_spec)
    return emit, top_k, rank_by


def _check_record_stage(chain: _Chain, *, name: str, n_slots: int,
                        lateness: float, fanout: str, num_buckets: int,
                        n_workers: int, backend: str) -> None:
    """The per-stage validation shared by every record stage of the DAG —
    run with the stage's *resolved* (possibly stage-local) options.  The
    worker backends split an aggregate carry into ``n_workers`` owner
    slices, so there ``num_buckets`` must divide by ``n_workers`` (the
    reference's rule); the fused fold has no worker axis and does not
    need it."""
    where = f"{name}: " if name else ""
    if chain.windowing is None:
        raise PipelineError(where + "record pipelines need a window node "
                            "before reduce (use Windowing.tumbling(...) "
                            "with a large size for a single global window)")
    _check_windowing(chain.windowing, n_slots, lateness)
    _check_reduce(chain, in_join=False)
    if chain.windowing.is_session:
        if chain.reduce_mode != "aggregate":
            raise PipelineError("session windows reduce in aggregate mode "
                                "only")
        if chain.top is not None:
            raise PipelineError("top_k over session windows is meaningless "
                                "(a session holds one key)")
    if chain.reduce_mode == "group" and fanout != "device":
        raise PipelineError(where + "group mode runs with fanout='device'")
    if backend != BACKEND and chain.reduce_mode == "aggregate" \
            and num_buckets % n_workers != 0:
        raise PipelineError(where + "num_buckets must divide by n_workers "
                            "so window slices stay aligned to the "
                            "scattered carry")


def _stage_options(chain: _Chain, *, name: str, num_buckets: int,
                   n_slots: int) -> tuple[int, int]:
    """Resolve one stage's carry sizing: stage-local ``reduce(...,
    num_buckets=, n_slots=)`` overrides win over the build-wide defaults;
    both are validated here, per stage."""
    nb = chain.options.get("num_buckets", num_buckets)
    ns = chain.options.get("n_slots", n_slots)
    where = f"{name}: " if name else ""
    if nb < 1:
        raise PipelineError(where + "num_buckets must be >= 1")
    if ns < 2:
        raise PipelineError(where + "need >= 2 window slots (one closing, "
                            "one open)")
    return int(nb), int(ns)


def _identity_boundary(src: _Chain, src_emit: EmitSpec, dst: _Chain) -> bool:
    """True when the src → dst boundary passes every emitted key through
    unchanged: an aggregate source stage with fixed windows feeding a
    destination with no host transform and the default key.  On such a
    boundary the destination's dictionary can register keys *eagerly*
    (the moment the source first sees them), which keeps the id order
    identical across handoff transports and closed in every checkpoint."""
    return (src_emit.kind == "aggregate"
            and not src.windowing.is_session
            and dst.transform is None
            and dst.key_fn is _default_key
            and not dst.windowing.is_session)


def _handoff_on_device(src: _Chain, src_emit: EmitSpec, dst: _Chain, *,
                       key_space_str: str, fanout: str,
                       handoff: str) -> bool:
    """True when the src → dst boundary can re-key/re-window finalized
    aggregates entirely on the device: a dense identity boundary under
    the device fan-out wire.  Any host map/key_by between the stages takes
    the host record path — the same records, materialized."""
    return (handoff == "device" and fanout == "device"
            and key_space_str == "dense"
            and _identity_boundary(src, src_emit, dst))


def build_pipeline(p: Pipeline, *, num_buckets=128, n_workers: int = 8,
                   n_slots: int = 8,
                   key_space: "str | KeySpace" = "dense",
                   fanout: str = "device", allowed_lateness: float = 0.0,
                   backend: str = BACKEND, checkpoint_interval: int = 1,
                   batch_records: int | None = None,
                   job_id: str | None = None,
                   output_prefix: str | None = None,
                   device="cuda", finalize: bool = True,
                   combine_fn=None, handoff: str = "device",
                   group=None) -> BuiltPipeline:
    """Validate ``p`` and lower it to a runnable ``BuiltPipeline`` whose
    carries live on ``device`` — ``"cuda"`` by default, which must exist
    (pass ``device="cpu"`` to run the plain PyTorch versions on the CPU).
    ``key_space`` is ``"dense"`` / ``"hashed"`` or a ``KeySpace``
    instance (passed to the plans verbatim); ``fanout`` picks the device
    (one row per record) or host (one row per record × window) wire.
    ``num_buckets`` takes a ``(left, right)`` pair on a join to size the
    two key spaces independently (dense only); the shared carry widens to
    the larger side.  ``handoff`` picks the multi-stage boundary
    transport: ``"device"`` re-keys/re-windows finalized aggregates on the
    device where the boundary allows it, ``"host"`` always materializes
    the records.  ``backend`` (``"fused"``, ``"vmap"``, ``"shard_map"``;
    ``group`` is the last one's process group) picks where the
    ``n_workers`` workers live: under ``"fused"`` a windowed aggregate's
    fold has no worker axis and ``n_workers`` only caps a private pool's
    scale and sizes group buffers.  An array pipeline takes ``n_workers``
    shards; ``finalize`` and ``combine_fn`` (``None``/``"pallas"``: the
    hash_combine kernel, or a callable) shape its batch plan."""
    side_buckets: tuple[int, int] | None = None
    if isinstance(num_buckets, (tuple, list)):
        if len(num_buckets) != 2:
            raise PipelineError("num_buckets takes an int or a "
                                "(left, right) pair")
        side_buckets = (int(num_buckets[0]), int(num_buckets[1]))
        if min(side_buckets) < 1:
            raise PipelineError("per-side num_buckets must be >= 1")
        num_buckets = max(side_buckets)
    if isinstance(key_space, KeySpace):
        if side_buckets is not None:
            raise PipelineError("per-side num_buckets cannot combine with "
                                "a KeySpace instance")
        num_buckets = key_space.num_buckets
        key_space_str = key_space.mode
    elif key_space in ("dense", "hashed"):
        key_space_str = key_space
    else:
        raise PipelineError("key_space must be 'dense', 'hashed', or a "
                            "KeySpace")
    if fanout not in ("device", "host"):
        raise PipelineError("fanout must be 'device' or 'host'")
    if handoff not in ("device", "host"):
        raise PipelineError("handoff must be 'device' or 'host'")
    if checkpoint_interval < 1:
        raise PipelineError("checkpoint_interval must be >= 1")
    chains, join_node, tee_node, sink_prefix = _parse_chain(
        p, side="pipeline", allow_join=True, allow_stages=True,
        allow_tee=True)
    chain = chains[0]
    job_id = job_id or "p" + uuid.uuid4().hex[:11]
    output_prefix = output_prefix or sink_prefix or "stream-output/"
    batch_records = batch_records or chain.source.batch_records
    if side_buckets is not None and join_node is None:
        raise PipelineError("per-side num_buckets only applies to joins")
    common = dict(n_workers=n_workers, n_slots=n_slots,
                  batch_records=batch_records, key_space=key_space_str,
                  fanout=fanout, allowed_lateness=allowed_lateness,
                  checkpoint_interval=checkpoint_interval,
                  output_prefix=output_prefix, job_id=job_id,
                  backend=backend, handoff=handoff)

    # -- array (pure batch) pipelines ----------------------------------------
    if chain.source.kind == "array":
        compiled, stage = _lower_array(
            chain, num_buckets=num_buckets, n_workers=n_workers,
            n_slots=n_slots, key_space=key_space, lateness=allowed_lateness,
            backend=backend, finalize=finalize, combine_fn=combine_fn,
            device=device, group=group)
        built = BuiltPipeline(stages=(stage,), num_buckets=num_buckets,
                              device=compiled.device, batch_plan=compiled,
                              **common)
        from ..analysis.diagnostics import warn_diagnostics
        warn_diagnostics(built.check())
        return built
    if combine_fn is not None:
        raise PipelineError("combine_fn shapes an array pipeline's batch "
                            "plan; the streaming fold is its own combiner")

    # -- record pipelines: assemble the stage DAG -----------------------------
    stages: list[StagePlan] = []
    side_chains: list[tuple[_Chain, ...]] = []   # per stage, its side chains
    raw_edges: list[tuple[int, int, int]] = []   # (src, dst, dst_side)

    def _add_stage(ch: _Chain, *, name: str, lateness: float,
                   prefix: str | None) -> int:
        idx = len(stages)
        nb, ns = _stage_options(ch, name=name, num_buckets=num_buckets,
                                n_slots=n_slots)
        if ch.options and isinstance(key_space, KeySpace):
            raise PipelineError("stage-local options cannot combine with a "
                                "KeySpace instance (it fixes one bucket "
                                "width for the whole graph)")
        _check_record_stage(ch, name=name, n_slots=ns, lateness=lateness,
                            fanout=fanout, num_buckets=nb,
                            n_workers=n_workers, backend=backend)
        emit, top_k, rank_by = _stage_emit(ch, nb)
        side = _lower_side(ch, name or "main", num_buckets=nb,
                           n_workers=n_workers, n_slots=ns,
                           key_space=key_space, fanout=fanout,
                           backend=backend, device=device, channels=2,
                           channel_base=0, top_k=top_k, rank_by=rank_by,
                           group=group)
        stages.append(StagePlan(idx, (side,), ch.windowing, ch.reduce_mode,
                                emit, nb, ns, lateness, ch.capacity,
                                output_prefix=prefix))
        side_chains.append((ch,))
        return idx

    def _lower_seq(seq, tee, sink, *, upstream: int | None,
                   label: str) -> tuple[int, int]:
        """Lower one linear chain sequence — fed by stage ``upstream``
        through the carry, or by an external source when ``upstream`` is
        None — plus its trailing tee fan-out (each branch recursing here).
        Returns the (first, last) stage indices of the linear part."""
        prev = upstream
        first = last = None
        for j, ch in enumerate(seq):
            terminal = j == len(seq) - 1 and tee is None
            name = f"{label}stage {j + 1}" if (label or len(seq) > 1) else ""
            # stages fed through the carry see finalized windows in
            # watermark order — no out-of-order slack needed
            lateness = allowed_lateness if prev is None else 0.0
            idx = _add_stage(ch, name=name, lateness=lateness,
                             prefix=sink if terminal else None)
            if prev is not None:
                raw_edges.append((prev, idx, 0))
            prev = idx
            last = idx
            if first is None:
                first = idx
        if tee is not None:
            for bi, bp in enumerate(tee.params["branches"]):
                blabel = f"{label}branch {bi + 1}"
                bchains, _, btee, bsink = _parse_chain(
                    bp, side=blabel, allow_join=False, allow_stages=True,
                    allow_tee=True)
                _lower_seq(bchains, btee, bsink, upstream=prev,
                           label=blabel + " ")
        return first, last

    def _finish(inputs: tuple[tuple[int, int], ...],
                carry_width: int) -> BuiltPipeline:
        """Shared tail of every record lowering: derive each edge's
        transport, validate terminal sinks and session placement, and
        assemble the built program."""
        edges = []
        for src, dst, dst_side in raw_edges:
            src_ch = side_chains[src][0]
            dst_ch = side_chains[dst][dst_side]
            eager = _identity_boundary(src_ch, stages[src].emit, dst_ch)
            dev = eager and _handoff_on_device(
                src_ch, stages[src].emit, dst_ch,
                key_space_str=key_space_str, fanout=fanout, handoff=handoff)
            edges.append(StageEdge(src, dst, dst_side, dev, eager))
        srcs: dict[int, list[StageEdge]] = {}
        for e in edges:
            srcs.setdefault(e.src, []).append(e)
        for si, es in srcs.items():
            # the stage counts as eager/device when every out-edge is
            # (per-edge truth lives on the edges)
            stages[si] = dataclasses.replace(
                stages[si], eager_boundary=all(x.eager for x in es),
                handoff_device=all(x.device for x in es))
        if len(stages) > 1:
            for st in stages:
                if st.is_session:
                    raise PipelineError(
                        "session windows run in a single-stage pipeline "
                        "only: sessions finalize out of start order, so "
                        "wiring them into a stage DAG would break the "
                        "deterministic batch ↔ streaming replay")
        finals = [i for i in range(len(stages)) if i not in srcs]
        if len(finals) > 1:
            prefixes = [stages[i].output_prefix for i in finals]
            if any(not pfx for pfx in prefixes):
                raise PipelineError(
                    "a fan-out pipeline writes several output streams: "
                    "every terminal branch needs its own .sink(prefix)")
            # output keys normalize the trailing slash away, so the
            # distinctness check must too ("out" and "out/" collide)
            normed = [pfx.rstrip("/") for pfx in prefixes]
            if len(set(normed)) != len(normed):
                raise PipelineError("terminal branches must sink to "
                                    "distinct prefixes (two branches share "
                                    "one, so their windows would collide)")
        else:
            # single output stream: the pipeline-level prefix (which the
            # build option may override) stays authoritative
            stages[finals[0]] = dataclasses.replace(
                stages[finals[0]], output_prefix=None)
        built = BuiltPipeline(
            stages=tuple(stages), num_buckets=carry_width,
            device=stages[0].sides[0].compiled.device, edges=tuple(edges),
            inputs=inputs, **common)
        from ..analysis.diagnostics import warn_diagnostics
        warn_diagnostics(built.check())
        return built

    # -- joins (either side may be a multi-stage chain) -----------------------
    if join_node is not None:
        on = join_node.params["on"]
        lchain = chains[-1]
        if on is not None:
            lchain = dataclasses.replace(lchain, key_fn=on)
        rchains, _, rtee, rsink = _parse_chain(
            join_node.right, side="right", allow_join=False,
            allow_stages=True, on=on)
        rchain = rchains[-1]
        if rsink is not None or rtee is not None or rchain.top is not None:
            raise PipelineError("the join's right side ends at its reduce "
                                "node")
        if rchains[0].source.kind == "array":
            raise PipelineError("join sides are record pipelines")
        if lchain.windowing is None or rchain.windowing is None:
            raise PipelineError("record pipelines need a window node before "
                                "reduce (use Windowing.tumbling(...) with a "
                                "large size for a single global window)")
        if rchain.windowing != lchain.windowing:
            raise PipelineError("join sides must share one window "
                                f"({lchain.windowing} != {rchain.windowing})")
        if lchain.windowing.is_session:
            raise PipelineError("session windows cannot join (window "
                                "bounds are per-key)")
        if fanout != "device":
            raise PipelineError("joins run with fanout='device'")
        _check_reduce(lchain, in_join=True)
        _check_reduce(rchain, in_join=True)
        if lchain.options or rchain.options:
            raise PipelineError("stage-local options cannot size a join's "
                                "final stage — size its key spaces with "
                                "build(num_buckets=(left, right))")
        lb, rb = side_buckets or (num_buckets, num_buckets)
        if key_space_str == "hashed" and lb != rb:
            raise PipelineError(
                "hashed joins need symmetric num_buckets: both sides must "
                "hash keys into the same bucket space to match")
        if backend == "shard_map":
            raise not_ported("a windowed join under backend='shard_map'",
                             "Queue A #11")
        if backend != BACKEND and num_buckets % n_workers != 0:
            raise PipelineError("num_buckets must divide by n_workers so "
                                "window slices stay aligned to the "
                                "scattered carry (asymmetric joins: the "
                                "larger side)")
        # the join stage itself still sees raw external events on any
        # single-stage side, so it keeps the out-of-order slack; a side fed
        # through the carry arrives in watermark order
        jlat = allowed_lateness if (len(chains) == 1 or len(rchains) == 1) \
            else 0.0
        _check_windowing(lchain.windowing, n_slots, jlat)
        lfirst = llast = rfirst = rlast = None
        if len(chains) > 1:
            lfirst, llast = _lower_seq(chains[:-1], None, None,
                                       upstream=None, label="left ")
        if len(rchains) > 1:
            rfirst, rlast = _lower_seq(rchains[:-1], None, None,
                                       upstream=None, label="right ")
        jidx = len(stages)
        layout = ((0, 2), (2, 2))       # per-side [sum, count] channel pairs
        _check_channels_disjoint(layout, channels=4)
        shared = dict(n_workers=n_workers, n_slots=n_slots,
                      key_space=key_space, fanout=fanout, backend=backend,
                      device=device, channels=4, carry_buckets=num_buckets,
                      group=group)
        sides = (_lower_side(lchain, "left", num_buckets=lb,
                             channel_base=layout[0][0], **shared),
                 _lower_side(rchain, "right", num_buckets=rb,
                             channel_base=layout[1][0], **shared))
        emit = EmitSpec("join", join_aggs=(lchain.reduce_spec,
                                           rchain.reduce_spec))
        stages.append(StagePlan(jidx, sides, lchain.windowing, "aggregate",
                                emit, num_buckets, n_slots, jlat,
                                output_prefix=sink_prefix))
        side_chains.append((lchain, rchain))
        if llast is not None:
            raw_edges.append((llast, jidx, 0))
        if rlast is not None:
            raw_edges.append((rlast, jidx, 1))
        inputs = ((jidx, 0) if lfirst is None else (lfirst, 0),
                  (jidx, 1) if rfirst is None else (rfirst, 0))
        return _finish(inputs, num_buckets)

    # -- a linear chain (split at each reduce boundary) + optional tee --------
    first, _last = _lower_seq(chains, tee_node, sink_prefix, upstream=None,
                              label="")
    return _finish(((first, 0),), stages[0].num_buckets)
