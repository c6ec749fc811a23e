"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Drives ``repro_torch`` (never JAX, never the ``repro`` package) on the
card, phase by phase; any mismatch raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   fused-fold kernel built from ``src/repro_torch/kernels/fused_fold/csrc``
   with ``nvcc`` for ``sm_90a``.
2. Kernel vs plain: the kernel's wrapper against its plain PyTorch version
   on the same card tensors, bit for bit (integer-valued data: float32
   sums below 2**24 are exact in any order, so the tolerance is zero), at
   N = 2**22 rows, fan-out 5, 8 slots × 2**20 buckets (a 64 MiB carry, 80
   MiB of rows — bigger than the 50 MB L2) across {device wire, host wire}
   × {sum, count, min, max} × {dense, hashed} plus ``channel_base=2`` in a
   4-channel carry, with late pairs and negative window indices; then at
   the main path's own shape (one 65,536-record Linear Road micro-batch).
   Times are CUDA-event medians of 20 launches after warm-up.
3. Main path: ``linear-road-lav`` (see
   ``src/repro_torch/workloads/linear_road.py``: 50 expressways, 10,000
   segment keys, 50,000 vehicles, 1,000,000 position reports over 10
   minutes, sliding 5-minute windows every minute, mean speed) through
   ``Pipeline.from_source(prefix=...)`` → ``build(device="cuda")`` →
   ``run(...)`` with ``RunOptions(overlap=True)`` on an in-memory event
   log.  Every sink object must equal a numpy oracle exactly, and the
   kernel's launch count must equal the fold steps the run made.
   ``reduced`` (from Linear Road): 10 minutes instead of 3 hours; about
   30x fewer vehicles per expressway than the benchmark (1,000 against
   the order of 10^4), so finalization weighs more per report; LAV as
   the count-weighted mean of the window's reports, not the mean of
   per-minute averages; no tolls, accidents or historical queries.
4. Sessions on the host wire: a per-vehicle ``Windowing.session(30.0)``
   job on the card, byte-identical to the same job with ``device="cpu"``.

Before the last line it prints one JSON object ``{"kernels": [...]}``
(launches on the main path, error, kernel / plain / bound / library
times at the main path's shape); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a result when torch sees no CUDA device or when the
repository's sources are missing.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
REPS = 20
BIG_N = 1 << 22
BIG_BUCKETS = 1 << 20
FANOUT = 5
N_SLOTS = 8


def _median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_device_us(torch, fn, reps: int = REPS) -> str:
    """Device time of the fused_fold kernels per ``fn()`` call, from
    torch.profiler's CUDA trace; "not measured" when the trace holds no
    device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if "fold_rows" in ev.key or "combine_extrema" in ev.key:
            total += getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
    return f"{total / reps:.2f} us" if total > 0 else "not measured"


def _wire_rows(rng, n, *, host_wire, keymax):
    """Integer-valued wire rows: device wire ``[last, n_windows, key,
    value, valid]`` with negative window indices near the stream start, or
    host wire ``[slot, key, value, valid]``; about 10% invalid."""
    if host_wire:
        cols = [rng.integers(0, N_SLOTS, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.1]
    else:
        cols = [rng.integers(-6, 3 * N_SLOTS, n),
                rng.integers(1, FANOUT + 1, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.1]
    return np.stack(cols, axis=1).astype(np.float32)


def _carry(rng, size, channels, kind):
    carry = rng.integers(0, 5, (size, channels)).astype(np.float32)
    if kind in ("min", "max"):      # the carry contract: count 0 -> value 0
        for b in range(0, channels, 2):
            carry[:, b] = np.where(carry[:, b + 1] > 0, carry[:, b], 0.0)
    return carry


def _expanded_pairs(rows, *, host_wire, min_window, num_buckets,
                    carry_buckets, hashed):
    """The live (flat id, value) pairs of a batch, pre-expanded — the input
    of the one-call "scatter only" yardstick (not used by the port)."""
    import torch
    from repro_torch.kernels.fused_fold.ref import murmur_bucket
    if host_wire:
        bucket = murmur_bucket(rows[:, 1], num_buckets, hashed)
        live = rows[:, 3] > 0
        flat = rows[:, 0].to(torch.int64) * carry_buckets + bucket
        return flat[live], rows[:, 2][live]
    j = torch.arange(FANOUT, device=rows.device)
    widx = rows[:, 0].to(torch.int64)[:, None] - j[None, :]
    live = (rows[:, 4] > 0)[:, None] & (j[None, :] < rows[:, 1][:, None]) \
        & (widx >= min_window)
    bucket = murmur_bucket(rows[:, 2], num_buckets, hashed).to(torch.int64)
    flat = torch.remainder(widx, N_SLOTS) * carry_buckets + bucket[:, None]
    vals = rows[:, 3][:, None].expand(flat.shape)
    return flat[live], vals[live]


def _library_call(carry, flat, vals, kind, base):
    """One PyTorch call computing the scatter part of the fold: index_add_
    of [value-or-1, 1] pairs, or scatter_reduce_ of the extremum."""
    import torch
    if kind in ("sum", "count"):
        pair = torch.stack([torch.ones_like(vals) if kind == "count"
                            else vals, torch.ones_like(vals)], dim=1)
        return lambda: carry[:, base:base + 2].index_add_(0, flat, pair)
    reduce = "amin" if kind == "min" else "amax"
    col = carry[:, base].contiguous()
    return lambda: col.scatter_reduce_(0, flat, vals, reduce=reduce)


def _cells_hit(flat) -> int:
    """Number of distinct carry cells among the live pairs' flat ids."""
    import torch
    return int(torch.unique(flat).numel())


def _bound_ms(rows, flat) -> tuple[float, str]:
    """Least time for the fold on this batch's data: every row read once,
    and only the carry cells its live pairs hit (the distinct ``flat``
    ids) read and written once in their two channels, plus the 12-byte
    stats, over HBM bandwidth; against two float32 adds per live pair over
    the float32 peak."""
    cells = _cells_hit(flat)
    nbytes = rows.numel() * 4 + 2 * cells * 2 * 4 + 12
    ops = flat.numel() * 2
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def phase_kernel(torch, ops, ref, device) -> float:
    """Phase 2, large shape: bit-identity over the whole sweep and the
    per-kind times.  Returns the largest absolute error seen."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    cases = [(hw, kind, hashed, 0, 2) for hw in (False, True)
             for kind in ("sum", "count", "min", "max")
             for hashed in (False, True)]
    cases.append((False, "sum", False, 2, 4))
    for host_wire, kind, hashed, base, channels in cases:
        keymax = (1 << 24) if hashed else BIG_BUCKETS
        rows = torch.from_numpy(_wire_rows(rng, BIG_N, host_wire=host_wire,
                                           keymax=keymax)).to(device)
        carry0 = torch.from_numpy(_carry(rng, N_SLOTS * BIG_BUCKETS,
                                         channels, kind)).to(device)
        kw = dict(fanout=1 if host_wire else FANOUT, n_slots=N_SLOTS,
                  num_buckets=BIG_BUCKETS, carry_buckets=BIG_BUCKETS,
                  channel_base=base, hashed=hashed, host_wire=host_wire,
                  kind=kind)
        minw = 2
        want_c, want_s = ref(rows, carry0, minw, **kw)
        got_c, got_s = ops.fold(rows, carry0.clone(), minw, **kw)
        torch.cuda.synchronize()
        err = float((got_c - want_c).abs().max())
        worst = max(worst, err)
        label = (f"{'host' if host_wire else 'device'}-wire {kind} "
                 f"{'hashed' if hashed else 'dense'} base={base}/C={channels}")
        if not (torch.equal(got_c, want_c) and torch.equal(got_s, want_s)):
            raise AssertionError(f"fused_fold != plain version: {label}: "
                                 f"stats {got_s.tolist()} vs "
                                 f"{want_s.tolist()}, max |err| {err}")
        if not host_wire and int(want_s[0]) == 0:
            raise AssertionError(f"{label}: no late pairs exercised")
        if base:
            untouched = [c for c in range(channels) if c not in (base,
                                                                 base + 1)]
            if not torch.equal(got_c[:, untouched], carry0[:, untouched]):
                raise AssertionError(f"{label}: touched other channels")
        if hashed or base:
            print(f"kernel-check {label}: bit-identical, stats "
                  f"{got_s.tolist()}")
            continue
        scratch = carry0.clone()
        ms = _median_ms(lambda: ops.fold(rows, scratch, minw, **kw))
        plain_ms = _median_ms(lambda: ref(rows, carry0, minw, **kw))
        flat, vals = _expanded_pairs(rows, host_wire=host_wire,
                                     min_window=minw,
                                     num_buckets=BIG_BUCKETS,
                                     carry_buckets=BIG_BUCKETS,
                                     hashed=hashed)
        lib_ms = _median_ms(_library_call(carry0.clone(), flat, vals, kind,
                                          base))
        bound, by = _bound_ms(rows, flat)
        device_us = _kernel_device_us(
            torch, lambda: ops.fold(rows, scratch, minw, **kw))
        print(f"kernel-check {label}: bit-identical, stats "
              f"{got_s.tolist()}; N={BIG_N} carry="
              f"{N_SLOTS * BIG_BUCKETS}x{channels}: kernel {ms:.4f} ms "
              f"(device time {device_us}), plain {plain_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}; {_cells_hit(flat)} "
              f"cells hit by {flat.numel()} live pairs), scatter only "
              f"{lib_ms:.4f} ms")
    return worst


def lr_batch(torch, lr, device):
    """One main-path-shaped fold input: the first 65,536 Linear Road
    reports as device-wire rows, as the coordinator ships them."""
    ts, seg, speed = lr.position_reports(SEED, **lr.FULL)
    n = lr.BATCH_RECORDS
    ts, seg, speed = ts[:n], seg[:n], speed[:n]
    last = np.floor(ts / lr.WINDOW_SLIDE).astype(np.int64)
    first = np.floor((ts - lr.WINDOW_SIZE) / lr.WINDOW_SLIDE) \
        .astype(np.int64) + 1
    base = (int(first.min()) // lr.N_SLOTS) * lr.N_SLOTS
    rows = np.stack([last - base, last - first + 1, seg, speed,
                     np.ones(n)], axis=1).astype(np.float32)
    nb = lr.num_segments(lr.FULL["n_xways"])
    carry = torch.zeros((lr.N_SLOTS * nb, 2), dtype=torch.float32,
                        device=device)
    return torch.from_numpy(rows).to(device), carry, nb


def phase_kernel_main_shape(torch, ops, ref, lr, device) -> dict:
    """Phase 2, main-path shape: bit-identity and the times the kernels
    line reports."""
    rows, carry, nb = lr_batch(torch, lr, device)
    kw = dict(fanout=FANOUT, n_slots=lr.N_SLOTS, num_buckets=nb,
              carry_buckets=nb, hashed=False, host_wire=False, kind="sum")
    minw = -(2 ** 31)
    want_c, want_s = ref(rows, carry, minw, **kw)
    got_c, got_s = ops.fold(rows, carry.clone(), minw, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got_c, want_c) and torch.equal(got_s, want_s)):
        raise AssertionError("fused_fold != plain version at the main "
                             "path's shape")
    scratch = carry.clone()
    ms = _median_ms(lambda: ops.fold(rows, scratch, minw, **kw))
    plain_ms = _median_ms(lambda: ref(rows, carry, minw, **kw))
    flat, vals = _expanded_pairs(rows, host_wire=False, min_window=minw,
                                 num_buckets=nb, carry_buckets=nb,
                                 hashed=False)
    lib_ms = _median_ms(_library_call(carry.clone(), flat, vals, "sum", 0))
    bound, by = _bound_ms(rows, flat)
    device_us = _kernel_device_us(
        torch, lambda: ops.fold(rows, scratch, minw, **kw))
    print(f"kernel-check main-path shape rows={tuple(rows.shape)} carry="
          f"{tuple(carry.shape)} pairs={int(got_s[1])}: bit-identical; "
          f"kernel {ms:.4f} ms per wrapper call (device time "
          f"{device_us}, torch.profiler), plain "
          f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
          f"{_cells_hit(flat)} of {carry.shape[0]} cells hit by "
          f"{flat.numel()} live pairs), scatter only "
          f"{lib_ms:.4f} ms")
    return {"max_abs_err": float((got_c - want_c).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms}


def phase_main_path(torch, ops, lr) -> int:
    """Phase 3: linear-road-lav end to end on the card.  Returns the fused
    fold's launches during the run."""
    from repro_torch.core import (AutoscalerConfig, MemoryStore,
                                  MetadataStore, MeteredPool, ServerlessPool)
    from repro_torch.pipeline import RunOptions
    from repro_torch.streaming import write_event_log

    t0 = time.perf_counter()
    ts, seg, speed = lr.position_reports(SEED, **lr.FULL)
    store = MemoryStore()
    n = write_event_log(store, "linear-road/reports",
                        lr.records(ts, seg, speed), segment_records=65536)
    print(f"main-path: {n} position reports, "
          f"{lr.num_segments(lr.FULL['n_xways'])} segments, event log "
          f"written in {time.perf_counter() - t0:.1f} s")
    built = lr.lav_pipeline("linear-road/reports").build(
        device="cuda", job_id="linear-road-lav",
        **lr.build_options(lr.FULL["n_xways"]))
    pool = MeteredPool(ServerlessPool("stream-mapper",
                                      AutoscalerConfig(max_scale=8)))
    ops.fold.launches = 0
    report = built.run(store=store, meta=MetadataStore(), pool=pool,
                       options=RunOptions(overlap=True))
    launches = ops.fold.launches
    if report.error is not None:
        raise AssertionError(f"main path failed: {report.error}")
    if launches != report.folds or report.folds < report.batches:
        raise AssertionError(f"fused_fold launched {launches} times for "
                             f"{report.folds} fold steps over "
                             f"{report.batches} micro-batches")
    if report.late_dropped:
        raise AssertionError(f"{report.late_dropped} late pairs dropped; the "
                             f"oracle assumes none")
    oracle = lr.lav_oracle(ts, seg, speed)
    outputs = built.collect_outputs(store)
    want = {f"lav/linear-road-lav/window-{start:.3f}-"
            f"{start + lr.WINDOW_SIZE:.3f}": means
            for start, means in oracle.items()}
    if set(outputs) != set(want):
        raise AssertionError(f"sink windows differ from the oracle's: "
                             f"{sorted(set(outputs) ^ set(want))[:4]}")
    n_values = 0
    for key, blob in outputs.items():
        got = dict(json.loads(line) for line in blob.splitlines())
        if got != want[key]:
            bad = [k for k in want[key] if got.get(k) != want[key][k]][:3]
            raise AssertionError(f"{key}: LAV differs from the oracle at "
                                 f"{bad}")
        n_values += len(got)
    share = pool.meter.pool_seconds / report.wall_time
    print(f"main-path linear-road-lav: {report.records_in} records in "
          f"{report.wall_time:.3f} s = {report.records_per_sec:.0f} "
          f"records/s; {report.batches} micro-batches, {report.folds} "
          f"folds, {launches} fused_fold launches; {report.windows_emitted} "
          f"windows emitted ({n_values} segment means == oracle), "
          f"{report.late_dropped} late dropped; fold launches took "
          f"{pool.meter.pool_seconds:.3f} s = {100 * share:.2f}% of wall "
          f"time; p50/p99 close-to-emit {report.p50_emit_latency * 1e3:.2f}/"
          f"{report.p99_emit_latency * 1e3:.2f} ms")
    return launches


def phase_sessions(ops) -> None:
    """Phase 4: a per-vehicle session job on the host wire, card vs CPU,
    byte for byte."""
    from repro_torch.core import MemoryStore
    from repro_torch.pipeline import Pipeline, Windowing

    rng = np.random.default_rng(SEED + 1)
    pings = []
    for v in range(200):
        t = float(rng.uniform(0, 30.0))
        while t < 1800.0:
            for _ in range(int(rng.integers(5, 20))):        # one trip
                pings.append((t, f"vehicle-{v}", float(rng.integers(0, 101))))
                t += float(rng.uniform(0.5, 8.0))
            t += float(rng.uniform(60.0, 180.0))             # parked > gap
    pings.sort()
    pipe = (Pipeline.from_source(records=pings, batch_records=4096)
            .key_by().window(Windowing.session(30.0)).reduce("mean")
            .sink("trips/"))
    out = {}
    for device in ("cuda", "cpu"):
        before = ops.fold.launches
        built = pipe.build(num_buckets=256, n_workers=4, n_slots=4,
                           job_id="trips", device=device)
        outputs, report = built.run(store=MemoryStore())
        out[device] = outputs
        print(f"sessions on {device}: {len(pings)} pings, "
              f"{report.windows_emitted} sessions, "
              f"{ops.fold.launches - before} fused_fold launches")
    if not out["cuda"] or out["cuda"] != out["cpu"]:
        raise AssertionError("session sinks differ between cuda and cpu")
    print(f"sessions: {len(out['cuda'])} session objects byte-identical "
          f"between device='cuda' and device='cpu'")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.fused_fold import ops
    from repro_torch.kernels.fused_fold.ref import fused_streaming_fold_ref
    from repro_torch.workloads import linear_road as lr

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ops.library()
    print(f"fused_fold built (nvcc, sm_90a) in "
          f"{time.perf_counter() - t0:.1f} s")

    worst = phase_kernel(torch, ops, fused_streaming_fold_ref, device)
    main_shape = phase_kernel_main_shape(torch, ops, fused_streaming_fold_ref,
                                         lr, device)
    launches = phase_main_path(torch, ops, lr)
    phase_sessions(ops)

    kernel = {"name": "fused_fold", "route": "cuda",
              "source": "src/repro_torch/kernels/fused_fold/csrc/"
                        "fused_fold.cu",
              "replaces": "src/repro/kernels/fused_fold/kernel.py:64",
              "launches": launches}
    kernel.update(main_shape)
    kernel["max_abs_err"] = max(worst, main_shape["max_abs_err"])
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
