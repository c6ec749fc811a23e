"""planlint — semantic checks over lowered ``BuiltPipeline`` programs.

The build validator (``pipeline.lower``) rejects grammar violations; this
pass goes after the failure modes that today only surface **mid-stream**,
after a job already holds pool replicas: ring-slot exhaustion, silent
hashed-key merging, and sinks that collide with sources or the checkpoint
namespace.  Each rule emits structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic` records;
``Pipeline.build`` surfaces warnings.

Rules (stable ids, shared with the JAX package's planlint):

======  ====================================================================
PL001   the window ring must hold the full span: ``n_slots >=``
        ``min_slots_required(size, slide, lateness)``; below it, a
        sustained stream MUST raise ``streaming.state``'s "window ring
        full" at runtime
PL002   hashed key spaces fold labels to 24-bit raw ids; the birthday
        bound on ``num_buckets`` expected keys estimates the odds two
        distinct keys silently merge — warn above 1%
PL005   sink prefixes must not overlap each other, any source log prefix
        (the pipeline would re-ingest its own output), or the reserved
        ``jobs/`` checkpoint namespace (restore scans would list the
        carry blob as a persisted window)
======  ====================================================================

The port lowers single-stage, single-side programs only, so the
reference's PL003 (group-mode capacity), PL004 (watermark wiring across
edges and join sides) and PL006 (carry donation; the port updates its
carry in place) cannot fire here; each arrives with the slice that ports
what it checks (ROADMAP Queue A #6-#8).
"""

from __future__ import annotations

import math

from .diagnostics import ERROR, INFO, WARNING, Diagnostic

#: width of the hashed wire key ids (``engine.stages.fold_key24``) — kept
#: in sync by a test against ``engine.stages.RAW_KEY_BITS`` rather than an
#: import, so this module stays free of the engine's torch imports
RAW_KEY_BITS = 24

#: PL002 threshold: warn when the birthday bound crosses 1%
COLLISION_WARN_P = 0.01

#: PL005: store namespaces the runtime owns (``_carry_key`` writes
#: ``jobs/<job_id>/stream/carry`` through the same store as the sinks)
RESERVED_PREFIXES = ("jobs/",)

RULES = {
    "PL001": "window ring too small for the window span (+ lateness)",
    "PL002": "hashed fold_key24 collision probability above threshold",
    "PL005": "sink prefix overlaps a sink, a source, or a reserved namespace",
}

__all__ = ["RULES", "check_plan", "explain_plan", "min_slots_required",
           "collision_probability", "RAW_KEY_BITS", "COLLISION_WARN_P",
           "RESERVED_PREFIXES"]


def min_slots_required(size: float, slide: float | None = None,
                       lateness: float = 0.0) -> int:
    """Minimum ring depth for fixed windows: every window whose span
    ``[start, end + lateness)`` can contain one event time must be
    admissible at one instant, plus one slot for the window the next event
    opens while the oldest is still closing.  The single source of truth —
    ``pipeline.lower`` validates builds with it, ``streaming.state``
    validates direct tracker construction, PL001 re-derives it for
    hand-assembled plans."""
    step = slide or size
    return math.ceil((size + lateness) / step) + 1


def collision_probability(n_keys: int, bits: int = RAW_KEY_BITS) -> float:
    """Birthday bound: odds that ``n_keys`` uniform draws from a
    ``2**bits`` id space contain at least one collision."""
    if n_keys < 2:
        return 0.0
    return -math.expm1(-n_keys * (n_keys - 1) / 2.0 / float(1 << bits))


def _check_ring_slots(built, out: list) -> None:
    """PL001 — a config below the slot floor cannot survive a sustained
    stream: the watermark trails the newest window by the full span, so
    eventually two live windows share a modular slot and ``slot_for``
    raises mid-batch with the job already admitted."""
    for st in built.stages:
        w = st.window
        if w.is_session:
            if st.n_slots < 2:
                out.append(Diagnostic(
                    "PL001", ERROR,
                    f"session ring n_slots={st.n_slots}: one slot cannot "
                    f"hold a closing session and an opening one — need "
                    f">= 2", loc=f"stage {st.index}"))
            continue
        need = min_slots_required(w.size, w.slide, st.allowed_lateness)
        step = w.slide or w.size
        if st.n_slots < need:
            out.append(Diagnostic(
                "PL001", ERROR,
                f"n_slots={st.n_slots} cannot hold the window span; need "
                f">= {need} for size={w.size}, slide={step}, "
                f"lateness={st.allowed_lateness} — a sustained stream "
                f"must raise \"window ring full\" mid-batch",
                loc=f"stage {st.index}"))


def _check_hash_collisions(built, out: list) -> None:
    """PL002 — hashed mode folds arbitrary labels into 24-bit raw ids;
    two keys sharing a raw id merge silently (bucket collisions are
    counted, raw-id collisions are not observable).  ``num_buckets`` is
    the declared key-cardinality budget, so it bounds the estimate."""
    if built.key_space != "hashed":
        return
    seen: set[int] = set()
    for st in built.stages:
        n = st.num_buckets
        if n in seen:
            continue
        seen.add(n)
        p = collision_probability(n)
        level = WARNING if p >= COLLISION_WARN_P else INFO
        out.append(Diagnostic(
            "PL002", level,
            f"hashed key space: ~{p:.2%} odds that {n} distinct keys "
            f"collide in the {RAW_KEY_BITS}-bit raw-id space (silent "
            f"merge)" + (" — use key_space='dense' or fewer expected keys"
                         if level == WARNING else ""),
            loc=f"stage {st.index}"))


def _check_sink_prefixes(built, out: list,
                         source_prefixes=()) -> None:
    """PL005 — ``collect_outputs`` and restore scans are prefix
    *listings*, so overlap (not just equality) is the collision
    condition; the build-time distinctness check only catches exact
    duplicates.  Also rejected: sinks under a source log (the pipeline
    would ingest its own output on replay) and sinks under the reserved
    checkpoint namespace."""
    prefixes = built.output_prefixes()
    for i, a in enumerate(prefixes):
        for b in prefixes[i + 1:]:
            if a.startswith(b) or b.startswith(a):
                out.append(Diagnostic(
                    "PL005", ERROR,
                    f"sink prefixes {a!r} and {b!r} overlap — a prefix "
                    f"listing of one would see the other's windows",
                    loc="program"))
    srcs = {sp.source.prefix for st in built.stages for sp in st.sides
            if sp.source.kind == "log" and sp.source.prefix}
    srcs.update(p for p in source_prefixes if p)
    for pfx in prefixes:
        for src in sorted(srcs):
            s_norm = src.rstrip("/") + "/"
            if pfx.startswith(s_norm) or s_norm.startswith(pfx):
                out.append(Diagnostic(
                    "PL005", ERROR,
                    f"sink prefix {pfx!r} overlaps source log prefix "
                    f"{s_norm!r}: the job would ingest its own output "
                    f"on replay", loc="program"))
        for reserved in RESERVED_PREFIXES:
            if pfx.startswith(reserved) or reserved.startswith(pfx):
                out.append(Diagnostic(
                    "PL005", ERROR,
                    f"sink prefix {pfx!r} falls under the reserved "
                    f"{reserved!r} namespace — the carry checkpoint "
                    f"lives at jobs/<job_id>/stream/carry on the same "
                    f"store, so restore scans would list it as a "
                    f"persisted window", loc="program"))


def check_plan(built, *, source_prefixes=()) -> list:
    """Run every planlint rule over a lowered program.  ``source_prefixes``
    adds run-time source bindings to the PL005 overlap set.  Returns
    ``Diagnostic`` records — empty means clean."""
    out: list = []
    _check_ring_slots(built, out)
    _check_hash_collisions(built, out)
    _check_sink_prefixes(built, out, source_prefixes)
    return out


def _describe_stage(built, st) -> str:
    w = st.window
    if w.is_session:
        shape = f"session(gap={w.gap})"
    elif w.slide:
        shape = f"sliding({w.size}/{w.slide})"
    else:
        shape = f"tumbling({w.size})"
    need = ""
    if not w.is_session:
        need = (f" (min "
                f"{min_slots_required(w.size, w.slide, st.allowed_lateness)})")
    sides = "+".join(sp.name for sp in st.sides)
    sink = ""
    if st.index in built.final_stages:
        sink = f" → sink {built.stage_prefix(st.index)!r}"
    return (f"stage {st.index} [{sides}]: {shape} mode={st.mode} "
            f"buckets={st.num_buckets} slots={st.n_slots}{need} "
            f"lateness={st.allowed_lateness}{sink}")


def explain_plan(built, *, source_prefixes=()) -> str:
    """Human-readable program summary + the full diagnostic report (all
    levels, info included) — ``BuiltPipeline.explain()``."""
    lines = [f"BuiltPipeline job_id={built.job_id} "
             f"key_space={built.key_space} n_workers={built.n_workers} "
             f"batch_records={built.batch_records} backend={built.backend}"]
    for st in built.stages:
        lines.append("  " + _describe_stage(built, st))
    diags = check_plan(built, source_prefixes=source_prefixes)
    if not diags:
        lines.append("planlint: clean")
    else:
        lines.append("planlint:")
        lines.extend("  " + d.format() for d in diags)
    return "\n".join(lines)
