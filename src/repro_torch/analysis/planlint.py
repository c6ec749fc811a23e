"""planlint — semantic checks over lowered ``BuiltPipeline`` programs.

The build validator (``pipeline.lower``) rejects grammar violations; this
pass goes after the failure modes that today only surface **mid-stream**,
after a job already holds pool replicas: ring-slot exhaustion, silent
hashed-key merging, group-buffer overflow, stalled watermarks across the
stage DAG, and sinks that collide with sources or the checkpoint
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
PL003   group-mode ``capacity`` bounds one partition's record buffer; a
        single skewed micro-batch can stage ``ceil(batch_records /
        n_workers)`` rows into one (slot, partition) cell — warn when
        capacity is below that floor (overflow counts, then drops)
PL004   watermark wiring: every stage side needs an input channel
        (external stream or in-edge) or its watermark pins at -inf and no
        window ever finalizes; carry-fed stages receive finalized windows
        in watermark order, so lateness slack there is dead config; a
        join over sides with different upstream window sizes holds
        windows open to the slower side (min-over-inputs)
PL005   sink prefixes must not overlap each other, any source log prefix
        (the pipeline would re-ingest its own output), or the reserved
        ``jobs/`` checkpoint namespace (restore scans would list the
        carry blob as a persisted window)
======  ====================================================================

PL001, PL002 and PL003 read windowed record stages; an array (batch)
program has none, so only PL005 applies to it, as in the reference.

PL006 (carry donation) has no counterpart: the port updates its carry in
place, so there is no donation to misuse.

CLI (the reference's ``main``)::

    PYTHONPATH=src python -m repro_torch.analysis.planlint my_jobs.py dir/

builds the programs of every module named (or every ``*.py`` in a
directory named) that exposes ``build_pipelines() -> {name:
BuiltPipeline}`` — port pipelines, built with the device the module
chooses — and checks each; error-level findings fail the run.  It has no
default path: the reference's ``examples/`` build reference pipelines.
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
    "PL003": "group-mode capacity below one micro-batch's worst-case load",
    "PL004": "watermark wiring: unfed side / dead lateness / lagging join",
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


def _record_stages(built) -> list:
    """Windowed record stages — the ones with a carry ring (array
    pipelines have no window)."""
    return [st for st in built.stages if st.window is not None]


def _check_ring_slots(built, out: list) -> None:
    """PL001 — a config below the slot floor cannot survive a sustained
    stream: the watermark trails the newest window by the full span, so
    eventually two live windows share a modular slot and ``slot_for``
    raises mid-batch with the job already admitted."""
    for st in _record_stages(built):
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
    for st in _record_stages(built):
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


def _check_group_capacity(built, out: list) -> None:
    """PL003 — group mode buffers each partition's records per window
    slot up to ``capacity`` and **drops** the overflow (counted in
    ``capacity_dropped``).  The static floor: one micro-batch can stage
    ``ceil(batch_records / n_workers)`` rows into a single partition
    (every key hashing together), and a window spanning several batches
    accumulates further — capacity must at least clear the single-batch
    floor."""
    for st in _record_stages(built):
        if st.mode != "group" or st.window.is_session:
            continue
        floor = math.ceil(built.batch_records / built.n_workers)
        if st.capacity < floor:
            out.append(Diagnostic(
                "PL003", WARNING,
                f"group capacity={st.capacity} is below the "
                f"{floor} records one micro-batch can stage into a "
                f"single partition (batch_records={built.batch_records} "
                f"/ n_workers={built.n_workers}); a skewed batch "
                f"overflows the buffer (dropped, counted in "
                f"capacity_dropped) — size capacity for window span × "
                f"per-partition rate", loc=f"stage {st.index}"))


def _check_watermarks(built, out: list) -> None:
    """PL004 — watermark monotonicity is wired, not assumed: a stage
    side's watermark is the min over its input channels, so a side with
    no channel pins the stage at -inf forever, and lateness slack on a
    carry-only stage can never admit anything (finalized windows arrive
    in watermark order)."""
    ext: dict[int, set[int]] = {}
    for si, side in built.inputs:
        ext.setdefault(si, set()).add(side)
    in_edges: dict[int, list] = {}
    for e in built.edges:
        in_edges.setdefault(e.dst, []).append(e)
    for st in _record_stages(built):
        fed_sides = set(ext.get(st.index, ()))
        for e in in_edges.get(st.index, ()):
            fed_sides.add(e.dst_side)
        for side in range(len(st.sides)):
            if side not in fed_sides:
                name = st.sides[side].name
                out.append(Diagnostic(
                    "PL004", ERROR,
                    f"side {side} ({name}) has no input channel — no "
                    f"external stream and no in-edge feeds it, so the "
                    f"stage watermark (min over inputs) stays at -inf "
                    f"and no window ever finalizes",
                    loc=f"stage {st.index}"))
        carry_only = st.index not in ext and in_edges.get(st.index)
        if carry_only and st.allowed_lateness > 0:
            out.append(Diagnostic(
                "PL004", WARNING,
                f"allowed_lateness={st.allowed_lateness} on a stage fed "
                f"only through the carry: finalized windows arrive in "
                f"watermark order, so the slack admits nothing and only "
                f"delays finalization", loc=f"stage {st.index}"))
        if st.is_join and len(in_edges.get(st.index, ())) == 2:
            sizes = {built.stages[e.src].window.size
                     for e in in_edges[st.index]
                     if built.stages[e.src].window is not None}
            if len(sizes) > 1:
                out.append(Diagnostic(
                    "PL004", INFO,
                    f"join over upstream window sizes {sorted(sizes)}: "
                    f"the min-over-inputs watermark holds windows open "
                    f"until the slower side catches up — size n_slots "
                    f"for the skew", loc=f"stage {st.index}"))


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
    _check_group_capacity(built, out)
    _check_watermarks(built, out)
    _check_sink_prefixes(built, out, source_prefixes)
    return out


def _describe_stage(built, st) -> str:
    w = st.window
    if w is None:
        shape = "array"
    elif w.is_session:
        shape = f"session(gap={w.gap})"
    elif w.slide:
        shape = f"sliding({w.size}/{w.slide})"
    else:
        shape = f"tumbling({w.size})"
    need = ""
    if w is not None and not w.is_session:
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
    """Human-readable program summary — every stage's window/ring/bucket
    geometry and every edge's transport — plus the full diagnostic report
    (all levels, info included): ``BuiltPipeline.explain()``."""
    lines = [f"BuiltPipeline job_id={built.job_id} "
             f"key_space={built.key_space} n_workers={built.n_workers} "
             f"batch_records={built.batch_records} backend={built.backend}"]
    for st in built.stages:
        lines.append("  " + _describe_stage(built, st))
    for e in built.edges:
        transport = "device" if e.device else "host"
        eager = " eager" if e.eager else ""
        lines.append(f"  edge {e.src}→{e.dst} side={e.dst_side} "
                     f"[{transport}{eager}]")
    diags = check_plan(built, source_prefixes=source_prefixes)
    if not diags:
        lines.append("planlint: clean")
    else:
        lines.append("planlint:")
        lines.extend("  " + d.format() for d in diags)
    return "\n".join(lines)


def _load_module(path):
    import importlib.util
    import pathlib
    p = pathlib.Path(path)
    name = f"_planlint_{p.stem}"
    spec = importlib.util.spec_from_file_location(name, p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    """``python -m repro_torch.analysis.planlint <files-or-dirs>`` — build
    every named module's pipelines (the ``build_pipelines()`` convention)
    and check them; 1 when any error-level finding remains, else 0."""
    import argparse
    import pathlib

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.planlint",
        description="planlint over pipeline modules of the port")
    ap.add_argument("paths", nargs="+",
                    help="modules (or directories of modules) exposing "
                         "build_pipelines() -> {name: BuiltPipeline}")
    args = ap.parse_args(argv)
    files: list = []
    for raw in args.paths:
        p = pathlib.Path(raw)
        if p.is_dir():
            files.extend(sorted(p.glob("*.py")))
        else:
            files.append(p)
    failed = 0
    checked = 0
    for f in files:
        mod = _load_module(f)
        build = getattr(mod, "build_pipelines", None)
        if build is None:
            print(f"{f}: skipped (no build_pipelines())")
            continue
        programs = build()
        if not isinstance(programs, dict):
            programs = {getattr(p, "job_id", str(i)): p
                        for i, p in enumerate(programs)}
        for name, prog in programs.items():
            diags = check_plan(prog)
            errs = [d for d in diags if d.level == ERROR]
            warns = [d for d in diags if d.level == WARNING]
            checked += 1
            status = "clean" if not (errs or warns) else \
                f"{len(errs)} error(s), {len(warns)} warning(s)"
            print(f"{f}:{name}: {status}")
            for d in errs + warns:
                print(f"  {d.format()}")
            failed += len(errs)
    print(f"planlint: {checked} program(s) checked, {failed} error(s)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
