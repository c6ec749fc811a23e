"""The declarative dataflow graph — the one front door for batch + streaming.

A ``Pipeline`` is an immutable chain of nodes::

    Pipeline.from_source(prefix="streams/gps")
        .map(fn)                       # host record transform (fused)
        .key_by(lambda r: r[1])
        .window(Windowing.tumbling(60.0))
        .reduce("mean")
        .top_k(8)                      # optional: heavy hitters per window
        .sink("stream-output/")
        .build(num_buckets=64, n_workers=8)

Each method returns a *new* pipeline (graphs are values, shareable and
re-buildable), following the declarative-chain style of Bauplan-like FaaS
pipelines rather than per-invocation job configs.  ``build()`` validates
the graph and lowers every stage chain to ``repro_torch.engine``
execution plans (``repro_torch.pipeline.lower``); the built artifact then
runs the *same* graph in batch mode (one drive over an object-store
prefix) or streaming mode (micro-batches through the
``StreamingCoordinator``) with bit-identical per-window results.  This
port lowers single-stage record chains; the other shapes below raise
``NotImplementedError`` at ``build()`` and are queued in ``ROADMAP.md``.

Two source families share the grammar:

* **record pipelines** — events ``(event_time, key, value)`` from an
  object-store event log (``prefix=``) or memory (``records=``); maps are
  host record transforms (return a record, ``None`` to filter, or an
  iterable to flat-map) and adjacent maps fuse into one stage; ``window``
  is required before ``reduce``.
* **array pipelines** — device shards (``shards=``); the single ``map`` is
  the device UDF ``shard -> (keys, values, valid)`` and the chain lowers
  to one batch ``ExecutionPlan`` (no window) — ``core.mapreduce`` is now a
  two-node pipeline of this family.

``a.join(b, on=...)`` makes a two-input node: both sides must be windowed
identically and reduced with aggregate kinds; the join lowers to two plans
sharing one carry (disjoint channel pairs) and emits, per window, every
key present on both sides with ``[left_aggregate, right_aggregate]``.
``build(num_buckets=(left, right))`` sizes the two key spaces
independently (dense joins), widening the shared carry to the larger
side.

A chain may continue **past a reduce**: ``….reduce(...).map(...)
.key_by(...).window(...).reduce(...)`` splits at each reduce boundary
into a sequence of stages — each stage's finalized windows become the
next stage's input records ``(window_start, key, aggregate)``, handed
off through the carry (on-device when the boundary has no host
transform).  Two-phase jobs — count-then-top-k, average-of-averages —
are one graph, and batch and streaming runs of it stay bit-identical
per window.

A chain may also **fan out**: ``….reduce(...).tee(branch, branch, …)``
feeds the finalized windows of one stage to *several* downstream
branches — the graph is a DAG, not just a chain.  Each branch is rooted
at ``Pipeline.branch()`` (or built by a callable receiving that stub)
and continues the grammar — ``map/key_by/window/reduce``, more stages,
``top_k``, its own ``sink`` — so one ingested stream feeds many
concurrent consumers off a single shared intermediate, the Kafka-ML
fan-out shape::

    counts = (Pipeline.from_source(prefix="streams/gps")
              .key_by().window(60.0).reduce("count"))
    dag = counts.tee(
        Pipeline.branch().window(300.0).reduce("sum").top_k(8)
                .sink("gps-top/"),
        Pipeline.branch().map(to_region).key_by().window(300.0)
                .reduce("sum").sink("gps-region/"))

Each fan-out edge picks its own handoff transport (on-device for
identity boundaries, host records otherwise), and a join's two inputs
may themselves be multi-stage chains.  Stage-local build options ride
on ``reduce(..., num_buckets=, n_slots=)`` when one branch needs a
different carry width or ring depth than the rest of the graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

__all__ = ["Pipeline", "Windowing", "PipelineError"]


class PipelineError(ValueError):
    """A malformed pipeline graph, rejected at ``build()``."""


@dataclass(frozen=True)
class Windowing:
    """Declarative window description — the graph-level twin of the
    engine's ``WindowSpec``."""

    kind: str                      # "tumbling" | "sliding" | "session"
    size: float = 0.0
    slide: float | None = None
    gap: float = 0.0

    @classmethod
    def tumbling(cls, size: float) -> "Windowing":
        return cls("tumbling", size=size)

    @classmethod
    def sliding(cls, size: float, slide: float) -> "Windowing":
        return cls("sliding", size=size, slide=slide)

    @classmethod
    def session(cls, gap: float) -> "Windowing":
        return cls("session", gap=gap)

    @property
    def is_session(self) -> bool:
        return self.kind == "session"


@dataclass(frozen=True)
class Node:
    """One graph node.  ``right`` holds the other input of a join."""

    op: str
    params: dict = field(default_factory=dict)
    right: "Pipeline | None" = None


@dataclass(frozen=True)
class Pipeline:
    """An immutable dataflow graph under construction."""

    nodes: tuple[Node, ...] = ()

    # -- sources ---------------------------------------------------------------
    @classmethod
    def from_source(cls, *, prefix: str | None = None,
                    records: Iterable | None = None,
                    shards: Any = None,
                    batch_records: int = 1024) -> "Pipeline":
        """Root a pipeline at a source: an event-log ``prefix`` in the
        object store, in-memory ``records``, device ``shards`` (array
        pipelines), or nothing — an *unbound* source whose data arrives at
        run time."""
        given = [x is not None for x in (prefix, records, shards)]
        if sum(given) > 1:
            raise PipelineError("pass at most one of prefix/records/shards")
        if batch_records < 1:
            raise PipelineError("batch_records must be >= 1")
        kind = ("log" if prefix is not None else
                "records" if records is not None else
                "array" if shards is not None else "unbound")
        params = {"kind": kind, "prefix": prefix, "shards": shards,
                  "records": list(records) if records is not None else None,
                  "batch_records": batch_records}
        return cls((Node("source", params),))

    @classmethod
    def branch(cls) -> "Pipeline":
        """Root a tee branch: a pipeline whose input is the finalized
        windows of the stage it is teed from — records
        ``(window_start, key, aggregate)`` delivered through the carry
        handoff.  Only valid as an argument to ``tee``."""
        return cls((Node("source", {"kind": "carry-stub", "prefix": None,
                                    "shards": None, "records": None,
                                    "batch_records": 1024}),))

    # -- chaining --------------------------------------------------------------
    def _append(self, node: Node) -> "Pipeline":
        return Pipeline(self.nodes + (node,))

    def _has(self, op: str) -> bool:
        return any(n.op == op for n in self.nodes)

    def map(self, fn: Callable) -> "Pipeline":
        """Record pipelines: ``fn(record) -> record | None | iterable`` —
        a transform, filter, or flat-map over ``(ts, key, value)`` tuples;
        adjacent maps fuse into one stage at build.  Array pipelines: the
        device UDF ``shard -> (keys, values, valid)``."""
        return self._append(Node("map", {"fn": fn}))

    def key_by(self, fn: Callable | None = None) -> "Pipeline":
        """Declare the shuffle key: ``fn(record) -> raw key`` (default:
        the record's second field)."""
        return self._append(Node("key_by", {"fn": fn}))

    def window(self, w: "Windowing | float") -> "Pipeline":
        """Event-time windows; a bare float means tumbling windows of that
        size."""
        if not isinstance(w, Windowing):
            w = Windowing.tumbling(float(w))
        return self._append(Node("window", {"windowing": w}))

    def reduce(self, spec: str | Callable = "count", *, mode: str | None = None,
               capacity: int = 0, num_buckets: int | None = None,
               n_slots: int | None = None) -> "Pipeline":
        """How each (window ×) key group reduces.

        ``spec`` is an aggregate kind (``count | sum | mean``), a group
        segment-reducer kind name, or a callable group reducer (the
        ``(keys, values, starts) -> (gk, gv, gvalid)`` contract).  A
        callable implies ``mode="group"``; group mode needs ``capacity``
        (records buffered per worker per window slot).

        ``num_buckets`` / ``n_slots`` are *stage-local* build options: the
        stage this reduce closes sizes its own carry (key-bucket width ×
        window-ring depth) instead of inheriting the ``build()``-wide
        defaults — a fan-out branch over few keys need not carry the
        ingest stage's wide bucket space, and a long-window stage can
        deepen only its own ring.  Validated at lower time."""
        if mode is None:
            mode = "group" if callable(spec) else "aggregate"
        return self._append(Node("reduce", {"spec": spec, "mode": mode,
                                            "capacity": capacity,
                                            "num_buckets": num_buckets,
                                            "n_slots": n_slots}))

    def top_k(self, k: int, by: str | None = None) -> "Pipeline":
        """Keep only the k heaviest keys per window, ranked ``by`` an
        aggregate kind (default: the reduce node's kind) — exact on closed
        (dense) key domains, heavy-hitters-up-to-collisions on hashed."""
        if k < 1:
            raise PipelineError("top_k needs k >= 1")
        return self._append(Node("top_k", {"k": k, "by": by}))

    def tee(self, *branches: "Callable[[Pipeline], Pipeline] | Pipeline"
            ) -> "Pipeline":
        """Fan this stage out: every finalized window of the reduce that
        closes the current stage feeds *each* branch as input records
        ``(window_start, key, aggregate)`` — one intermediate stream,
        several concurrent consumers.

        Each branch is a pipeline rooted at ``Pipeline.branch()`` (pass it
        pre-built, or pass a callable that receives the branch stub and
        returns the extended pipeline) and follows the normal grammar:
        ``map/key_by/window/reduce``, further stages, ``top_k``, nested
        ``tee``, and its own ``sink`` — every terminal branch needs a
        distinct sink, since each is a separate output stream.  ``tee`` is
        a terminal node of this pipeline."""
        if len(branches) < 2:
            raise PipelineError("tee needs at least two branches (a single "
                                "continuation is just a longer chain)")
        resolved = []
        for i, b in enumerate(branches):
            bp = b if isinstance(b, Pipeline) else b(Pipeline.branch())
            if not isinstance(bp, Pipeline):
                raise PipelineError(f"tee branch {i} must be (or return) a "
                                    f"Pipeline")
            if not bp.nodes or bp.nodes[0].op != "source" \
                    or bp.nodes[0].params.get("kind") != "carry-stub":
                raise PipelineError(
                    f"tee branch {i} must be rooted at Pipeline.branch() — "
                    f"its input is the teed stage's finalized windows, not "
                    f"an external source")
            resolved.append(bp)
        return self._append(Node("tee", {"branches": tuple(resolved)}))

    def join(self, other: "Pipeline", on: Callable | None = None
             ) -> "Pipeline":
        """Windowed equi-join: per window, emit every key present on both
        sides with both sides' aggregates.  Both sides must be reduced
        record pipelines over the same *final* window; either side may be
        a multi-stage chain (its earlier stages lower to upstream DAG
        stages feeding the join through carry handoffs).  ``on`` overrides
        both sides' final ``key_by``."""
        if not isinstance(other, Pipeline):
            raise PipelineError("join expects another Pipeline")
        return self._append(Node("join", {"on": on}, right=other))

    def sink(self, prefix: str) -> "Pipeline":
        """Where finalized windows land in the object store."""
        return self._append(Node("sink", {"prefix": prefix}))

    # -- building --------------------------------------------------------------
    def build(self, **opts):
        """Validate the graph and lower it to execution plans.  Returns a
        ``BuiltPipeline`` that runs in batch or streaming mode — see
        ``repro_torch.pipeline.lower.build_pipeline`` for the options."""
        from .lower import build_pipeline
        return build_pipeline(self, **opts)
