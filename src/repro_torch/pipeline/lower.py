"""Graph validation and lowering — pipeline nodes → execution plans.

``build_pipeline`` walks a ``Pipeline`` graph, validates the stage grammar
(one source; maps fuse; ``window`` before ``reduce``; ``top_k`` only over
an aggregate reduce) and lowers the chain onto ``repro_torch.engine``:

* adjacent ``map`` nodes fuse into a single host transform;
* the chain's window and reduce become one ``ExecutionPlan`` compiled on
  the build's ``device`` (``"cuda"`` unless the caller asks for
  ``"cpu"``): the fused fold over a flat carry slab;
* ``Windowing.session(gap)`` → the engine's ``WindowSpec.session``
  variant (host-wire fold, cell-addressed carry);
* ``top_k(k)`` → ``ReduceSpec(mode="top_k")`` — the aggregate fold plus
  the fixed-capacity heavy-hitters selection at finalization.

The result is a ``BuiltPipeline`` — the program the
``StreamingCoordinator`` drives (streaming mode) and the batch runner
drives once over the whole input (batch mode), with bit-identical
per-window output bytes.

The reference also lowers multi-stage chains, ``tee`` fan-out, windowed
joins, group-mode reduction and array (batch) pipelines, and compiles to
simulated-worker and multi-process backends.  None of these is ported
yet: each raises ``NotImplementedError`` at build naming the
``ROADMAP.md`` item that queues it — nothing falls back.
"""

from __future__ import annotations

import dataclasses
import uuid
from dataclasses import dataclass
from typing import Any, Callable

from ..engine.plan import (BACKEND, ExecutionPlan, KeySpace, ReduceSpec,
                           WindowSpec, not_ported)
from ..streaming.sessions import SessionTracker
from ..streaming.state import WindowTracker
from ..streaming.windows import SlidingWindows, TumblingWindows
from .graph import Pipeline, PipelineError, Windowing

AGGREGATE_KINDS = ("count", "sum", "mean")

#: canonical stage order within one chain (source implicit at rank 0)
_STAGE_RANK = {"source": 0, "map": 1, "key_by": 2, "window": 3,
               "reduce": 4, "top_k": 5, "join": 6, "tee": 6, "sink": 7}

_ORDER_HINT = ("stage order is source → map* → key_by → window → reduce "
               "→ top_k → sink")


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
    """Where the chain's records come from (bound at build or at run)."""

    kind: str           # "log" | "records" | "unbound"
    prefix: str | None = None
    records: list | None = None
    batch_records: int = 1024


@dataclass(frozen=True)
class _Chain:
    """The parsed linear stage chain."""

    source: SourceSpec
    transform: Callable | None
    key_fn: Callable
    value_fn: Callable
    windowing: Windowing | None
    reduce_spec: str | Callable
    reduce_mode: str
    top: dict | None = None         # the chain's top_k node, if any
    options: dict = dataclasses.field(default_factory=dict)  # stage-local


@dataclass(frozen=True)
class SidePlan:
    """The chain's lowered form: the fused host transform plus the
    compiled execution plan folding into the carry."""

    name: str
    source: SourceSpec
    transform: Callable | None
    key_fn: Callable
    value_fn: Callable
    compiled: Any
    num_buckets: int = 0


@dataclass(frozen=True)
class EmitSpec:
    """How a finalized window turns into output records."""

    kind: str                       # "aggregate" | "top_k"
    aggregation: str = "count"      # aggregate / session emission kind
    k: int = 0
    rank_by: str = "sum"            # top_k ranking kind


@dataclass(frozen=True)
class StagePlan:
    """The lowered stage: its compiled side plan, window shape, and
    emission spec."""

    index: int
    sides: tuple[SidePlan, ...]
    window: Windowing
    mode: str                       # fold machinery: "aggregate"
    emit: EmitSpec
    num_buckets: int                # carry bucket width
    n_slots: int
    allowed_lateness: float

    @property
    def is_session(self) -> bool:
        return self.window.is_session

    def assigner(self):
        """Fixed-window assigner (None for session windows)."""
        w = self.window
        if w.is_session:
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
    """A validated, lowered single-stage pipeline — the program both
    execution modes drive, with its carry on ``device``."""

    stages: tuple[StagePlan, ...]
    num_buckets: int
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

    # -- single-stage views (what planlint and the runtime read) --------------
    @property
    def sides(self) -> tuple[SidePlan, ...]:
        return self.stages[0].sides

    @property
    def final_stages(self) -> tuple[int, ...]:
        return (0,)

    def stage_prefix(self, si: int) -> str:
        """The output prefix stage ``si`` emits under (one sink here)."""
        return self.output_prefix

    def output_prefixes(self) -> tuple[str, ...]:
        """The normalized ``<sink>/<job_id>/`` key prefix this program's
        windows land under."""
        return (f"{self.stage_prefix(0).rstrip('/')}/{self.job_id}/",)

    def collect_outputs(self, store) -> dict:
        """Every window this program has persisted, keyed by object key."""
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
        records, empty when clean."""
        from ..analysis.planlint import check_plan
        return check_plan(self, source_prefixes=source_prefixes)

    def explain(self, *, source_prefixes=()) -> str:
        """Human-readable program summary plus the full planlint report."""
        from ..analysis.planlint import explain_plan
        return explain_plan(self, source_prefixes=source_prefixes)

    # -- execution -------------------------------------------------------------
    def run(self, source_or_data=None, *, options=None, store=None,
            meta=None, bus=None, autoscaler=None, pool=None,
            announce: bool = True, flush: bool = True,
            mode: str | None = None):
        """The one front door for executing the program: a
        ``StreamSource`` streams through the pipelined coordinator, an
        in-memory record list runs as one batch, and ``None`` falls back
        to the graph's bound source.  Returns a ``StreamReport``
        (streaming) or ``(outputs, report)`` (batch)."""
        from .runtime import run
        return run(self, source_or_data, options=options, store=store,
                   meta=meta, bus=bus, autoscaler=autoscaler, pool=pool,
                   announce=announce, flush=flush, mode=mode)


# ---------------------------------------------------------------------------
# Parsing + validation
# ---------------------------------------------------------------------------

def _parse_chain(p: Pipeline) -> tuple[_Chain, str | None]:
    """Walk the pipeline's nodes into one stage chain; returns ``(chain,
    sink_prefix)``.  Shapes the port does not lower yet raise
    ``NotImplementedError``."""
    if not p.nodes or p.nodes[0].op != "source":
        raise PipelineError("a pipeline starts at Pipeline.from_source(...)")
    src = p.nodes[0].params
    if src["kind"] == "array":
        raise not_ported("array (batch) pipelines",
                         "Queue A #9 (batch plans + hash_combine)")
    if src["kind"] == "carry-stub":
        raise not_ported("tee branches", "Queue A #6 (multi-stage chains and "
                                         "tee)")
    source = SourceSpec(kind=src["kind"], prefix=src["prefix"],
                        records=src["records"],
                        batch_records=src["batch_records"])
    st = {"maps": [], "key_fn": None, "windowing": None, "reduce": None,
          "top": None}
    sink_prefix = None
    rank = 0
    for node in p.nodes[1:]:
        r = _STAGE_RANK.get(node.op)
        if r is None:
            raise PipelineError(f"unknown node op {node.op!r}")
        if node.op == "source":
            raise PipelineError("more than one source")
        if node.op == "join":
            raise not_ported("windowed joins", "Queue A #7 (joins)")
        if node.op == "tee":
            raise not_ported("tee fan-out", "Queue A #6 (multi-stage chains "
                                            "and tee)")
        if sink_prefix is not None:
            raise PipelineError("sink must be the last node")
        if r < rank or (r == rank and node.op != "map"):
            if st["reduce"] is not None and node.op in (
                    "map", "key_by", "window", "reduce"):
                raise not_ported("chains that continue past a reduce",
                                 "Queue A #6 (multi-stage chains and tee)")
            prev = [k for k, v in _STAGE_RANK.items() if v == rank][0]
            raise PipelineError(f"{node.op!r} cannot follow a {prev!r} node "
                                f"— {_ORDER_HINT}")
        rank = r
        if node.op == "map":
            st["maps"].append(node.params["fn"])
        elif node.op == "key_by":
            st["key_fn"] = node.params["fn"]
        elif node.op == "window":
            st["windowing"] = node.params["windowing"]
        elif node.op == "reduce":
            st["reduce"] = node.params
        elif node.op == "top_k":
            st["top"] = node.params
        elif node.op == "sink":
            sink_prefix = node.params["prefix"]
    red = st["reduce"]
    if red is None:
        raise PipelineError(f"a pipeline needs a reduce node ({_ORDER_HINT})")
    chain = _Chain(
        source=source, transform=fuse_maps(st["maps"]),
        key_fn=st["key_fn"] or _default_key, value_fn=_default_value,
        windowing=st["windowing"], reduce_spec=red["spec"],
        reduce_mode=red["mode"], top=st["top"],
        options={k: red[k] for k in ("num_buckets", "n_slots")
                 if red.get(k) is not None})
    return chain, sink_prefix


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


def _check_chain(chain: _Chain, *, n_slots: int, lateness: float) -> None:
    if chain.windowing is None:
        raise PipelineError("record pipelines need a window node before "
                            "reduce (use Windowing.tumbling(...) with a "
                            "large size for a single global window)")
    if chain.reduce_mode == "group":
        raise not_ported("group-mode reduction", "Queue A #8 (group mode)")
    if chain.reduce_mode != "aggregate":
        raise PipelineError(f"unknown reduce mode {chain.reduce_mode!r}")
    spec = chain.reduce_spec
    if not isinstance(spec, str) or spec not in AGGREGATE_KINDS:
        raise PipelineError(f"aggregate reduce must be one of "
                            f"{AGGREGATE_KINDS}, got {spec!r}")
    _check_windowing(chain.windowing, n_slots, lateness)
    if chain.windowing.is_session and chain.top is not None:
        raise PipelineError("top_k over session windows is meaningless "
                            "(a session holds one key)")


def _stage_emit(chain: _Chain, num_buckets: int) -> tuple[EmitSpec, int, str]:
    """The stage's emission spec + validated top-k parameters."""
    if chain.top is None:
        return EmitSpec("aggregate", aggregation=chain.reduce_spec), 0, "sum"
    if chain.top["k"] > num_buckets:
        raise PipelineError("top_k k exceeds the bucket space")
    top_k = chain.top["k"]
    rank_by = chain.top["by"] or chain.reduce_spec
    if rank_by not in AGGREGATE_KINDS:
        raise PipelineError(f"top_k ranks by one of {AGGREGATE_KINDS}")
    return (EmitSpec("top_k", aggregation=chain.reduce_spec, k=top_k,
                     rank_by=rank_by), top_k, rank_by)


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------

def _key_space_obj(key_space, num_buckets: int) -> KeySpace:
    """A ``KeySpace`` instance passes through; a kind string builds one."""
    if isinstance(key_space, KeySpace):
        return key_space
    if key_space == "hashed":
        return KeySpace.hashed(num_buckets)
    return KeySpace.dense(num_buckets)


def build_pipeline(p: Pipeline, *, num_buckets: int = 128,
                   n_workers: int = 8, n_slots: int = 8,
                   key_space: "str | KeySpace" = "dense",
                   fanout: str = "device", allowed_lateness: float = 0.0,
                   backend: str = BACKEND, checkpoint_interval: int = 1,
                   batch_records: int | None = None,
                   job_id: str | None = None,
                   output_prefix: str | None = None,
                   device="cuda") -> BuiltPipeline:
    """Validate ``p`` and lower it to a runnable ``BuiltPipeline`` whose
    carry lives on ``device`` — ``"cuda"`` by default, which must exist
    (pass ``device="cpu"`` to run the plain PyTorch fold on the CPU).
    ``key_space`` is ``"dense"`` / ``"hashed"`` or a ``KeySpace``
    instance; ``fanout`` picks the device (one row per record) or host
    (one row per record × window) wire.  ``n_workers`` only caps a private
    pool's scale, as in the reference: the flat fold has no worker axis
    (ROADMAP Queue A #11), so it changes nothing the fold computes."""
    if isinstance(num_buckets, (tuple, list)):
        raise not_ported("per-side num_buckets (joins)", "Queue A #7 (joins)")
    if isinstance(key_space, KeySpace):
        num_buckets = key_space.num_buckets
        key_space_str = key_space.mode
    elif key_space in ("dense", "hashed"):
        key_space_str = key_space
    else:
        raise PipelineError("key_space must be 'dense', 'hashed', or a "
                            "KeySpace")
    if fanout not in ("device", "host"):
        raise PipelineError("fanout must be 'device' or 'host'")
    if checkpoint_interval < 1:
        raise PipelineError("checkpoint_interval must be >= 1")
    chain, sink_prefix = _parse_chain(p)
    nb = chain.options.get("num_buckets", num_buckets)
    ns = chain.options.get("n_slots", n_slots)
    if chain.options and isinstance(key_space, KeySpace):
        raise PipelineError("stage-local options cannot combine with a "
                            "KeySpace instance")
    if nb < 1:
        raise PipelineError("num_buckets must be >= 1")
    if ns < 2:
        raise PipelineError("need >= 2 window slots (one closing, one open)")
    _check_chain(chain, n_slots=ns, lateness=allowed_lateness)
    emit, top_k, rank_by = _stage_emit(chain, nb)

    ks = _key_space_obj(key_space, nb)
    w = chain.windowing
    if w.is_session:
        window = WindowSpec.session(w.gap, n_slots=ns)
    else:
        window = WindowSpec(size=w.size, slide=w.slide, n_slots=ns,
                            fanout_on_device=fanout == "device")
    reduce = (ReduceSpec(mode="top_k", reduce_fn=rank_by, k=top_k)
              if top_k else ReduceSpec("aggregate"))
    plan = ExecutionPlan(key_space=ks, reduce=reduce, n_workers=n_workers,
                         window=window)
    compiled = plan.compile(backend=backend, device=device)
    side = SidePlan(name="main", source=chain.source,
                    transform=chain.transform, key_fn=chain.key_fn,
                    value_fn=chain.value_fn, compiled=compiled,
                    num_buckets=ks.num_buckets)
    stage = StagePlan(0, (side,), w, "aggregate", emit, ks.num_buckets, ns,
                      allowed_lateness)
    built = BuiltPipeline(
        stages=(stage,), num_buckets=ks.num_buckets, n_workers=n_workers,
        n_slots=n_slots, batch_records=batch_records or
        chain.source.batch_records, key_space=key_space_str, fanout=fanout,
        allowed_lateness=allowed_lateness,
        checkpoint_interval=checkpoint_interval,
        output_prefix=output_prefix or sink_prefix or "stream-output/",
        job_id=job_id or "p" + uuid.uuid4().hex[:11],
        device=compiled.device)
    from ..analysis.diagnostics import warn_diagnostics
    warn_diagnostics(built.check())
    return built
