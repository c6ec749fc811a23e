"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Drives ``repro_torch`` (never JAX, never the ``repro`` package) on the
card, phase by phase; any mismatch raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``), then every
   kernel built from its ``src/repro_torch/kernels/<name>/csrc`` source
   with ``nvcc`` for ``sm_90a``, all builds started together.
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
5. hash_combine vs plain: the kernel's wrapper against its plain PyTorch
   version on the same card tensors over N in {2**16, 2**24}, B in {32,
   1000, 4096, 65536}, D in {1, 4, 16}, with about 20% invalid rows and
   keys below 0 and at or above B.  Integer-valued float32 must be
   bit-identical (float32 sums below 2**24 are exact in any order).
   Real-valued float32 in [0, 1) must agree within rtol 1e-4 (atol
   1e-4): both versions sum in float32 in an unordered (atomic) order,
   whose rounding error grows like sqrt(m / 12) ulp over m terms — under
   2e-5 of the sum at the largest m here (4.2e5 terms in one bucket).
   bfloat16 within rtol 2e-2 (atol 1e-2), the reference's own bfloat16
   kernel tolerance: both sum in float32 and round once, so they differ
   by at most one bfloat16 step where the float32 sums straddle a
   rounding boundary.  Per shape it prints the wrapper's time (CUDA
   events), the kernel's device time (torch.profiler), the byte bound,
   the plain version's time and one PyTorch call's (``bincount`` with
   weights for D = 1, ``index_add_`` for D > 1, over the kept rows).
6. Main path of the batch plane: ``wordcount-hibench-large`` (see
   ``src/repro_torch/workloads/wordcount.py``: 2**28 token ids uniform
   over 1,000 words, 8 worker shards, HiBench's wordcount ``large``
   profile) through ``Pipeline.from_source(shards=...)`` →
   ``build(device="cuda")`` → ``run()``: equal to the ``np.bincount``
   oracle exactly, one hash_combine launch per run; tokens/s over three
   runs from the host's shards, the host-to-device copy of the shards
   alone, three runs from shards already on the card, and one of those
   under torch.profiler for the kernel's and all device work's share.
   Before it, the kernel alone at that shape (the UDF's outputs),
   bit-identical to the plain version.
7. Hashed key space: 2**20 tokens over a 2**16-id vocabulary into 1,024
   hashed buckets, ``device="cuda"`` against ``device="cpu"``: equal
   results, ``sent`` and per-bucket collision counts.

Before the last line it prints one JSON object ``{"kernels": [...]}``
(per kernel: launches on its main path, error, kernel / plain / bound /
library times at its main path's shape); the last line is
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
HC_NS = (1 << 16, 1 << 24)
HC_BUCKETS = (32, 1000, 4096, 65536)
HC_DS = (1, 4, 16)
HC_KERNELS = ("combine_shared", "combine_global", "round_to_bf16")
HASHED = {"n_tokens": 1 << 20, "vocab": 1 << 16, "buckets": 1024}


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


def _device_us(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0))


def _kernel_device_us(torch, fn, reps: int = REPS,
                      names=("fold_rows", "combine_extrema")) -> str:
    """Device time of the named kernels per ``fn()`` call, from
    torch.profiler's CUDA trace; "not measured" when the trace holds no
    device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(ev) for ev in prof.key_averages()
                if any(n in ev.key for n in names))
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


def _hc_inputs(torch, rng, n, buckets, d, device):
    """Sweep inputs: keys over ``[-B/10, 1.1 B)`` (some outside the bucket
    range), about 20% invalid rows, integer values 0-8 (``(n,)`` for
    ``d == 1``)."""
    spill = max(buckets // 10, 1)
    keys = torch.from_numpy(rng.integers(-spill, buckets + spill, n,
                                         dtype=np.int32)).to(device)
    ints = rng.integers(0, 9, (n, d) if d > 1 else n, dtype=np.int8)
    vals = torch.from_numpy(ints).to(device).to(torch.float32)
    valid = torch.from_numpy(rng.random(n, dtype=np.float32) > 0.2).to(device)
    return keys, vals, valid


def _hc_bound_ms(keys, vals, valid, buckets) -> tuple[float, str]:
    """Least time for the combine on these inputs: keys (4 B) and valid
    flags (1 B) of every row read once, the values of the rows it keeps
    (valid, key in range) read once, and the (B, D) output written once,
    over HBM bandwidth; against one float32 add per kept value over the
    float32 peak."""
    d = 1 if vals.dim() == 1 else vals.shape[1]
    kept = int((valid & (keys >= 0) & (keys < buckets)).sum())
    esize = vals.element_size()
    nbytes = keys.numel() * 4 + valid.numel() + kept * d * esize \
        + buckets * d * esize
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = kept * d / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                         else "operations")


def _hc_library_call(torch, keys, vals, valid, buckets):
    """One PyTorch call computing the combine over the kept rows (kept
    beforehand): ``bincount`` with weights for D = 1, ``index_add_`` into
    a zeroed (B, D) for D > 1."""
    kept = valid & (keys >= 0) & (keys < buckets)
    k, v = keys[kept].long(), vals[kept]
    if v.dim() == 1:
        return lambda: torch.bincount(k, weights=v, minlength=buckets)
    out = torch.zeros((buckets, v.shape[1]), dtype=v.dtype, device=v.device)
    return lambda: out.index_add_(0, k, v)


def _hc_times(torch, hc, hc_ref, keys, vals, valid, buckets) -> dict:
    """Wrapper, device, plain, library and bound times of one shape."""
    ms = _median_ms(lambda: hc.combine(keys, vals, buckets, valid))
    plain_ms = _median_ms(lambda: hc_ref(keys, vals, buckets, valid))
    lib_ms = _median_ms(_hc_library_call(torch, keys, vals, valid, buckets))
    device_us = _kernel_device_us(
        torch, lambda: hc.combine(keys, vals, buckets, valid),
        names=HC_KERNELS)
    bound, by = _hc_bound_ms(keys, vals, valid, buckets)
    return {"ms": ms, "device": device_us, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by}


def phase_hash_combine(torch, hc, hc_ref, device) -> float:
    """Phase 5: kernel vs plain over the sweep, with per-shape times.
    Returns the largest absolute error of the integer-valued checks."""
    rng = np.random.default_rng(SEED + 5)
    worst = 0.0
    for n in HC_NS:
        for buckets in HC_BUCKETS:
            for d in HC_DS:
                keys, vals, valid = _hc_inputs(torch, rng, n, buckets, d,
                                               device)
                label = f"N={n} B={buckets} D={d}"
                got = hc.combine(keys, vals, buckets, valid)
                want = hc_ref(keys, vals, buckets, valid)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst = max(worst, err)
                if not torch.equal(got, want):
                    raise AssertionError(f"hash_combine != plain version "
                                         f"(integer values): {label}, max "
                                         f"|err| {err}")
                real = torch.rand(vals.shape, device=device)
                got_r = hc.combine(keys, real, buckets, valid)
                want_r = hc_ref(keys, real, buckets, valid)
                torch.testing.assert_close(got_r, want_r, rtol=1e-4,
                                           atol=1e-4)
                err_r = float((got_r - want_r).abs().max())
                rel_r = float(((got_r - want_r).abs()
                               / want_r.abs().clamp(min=1.0)).max())
                half = real.to(torch.bfloat16)
                got_h = hc.combine(keys, half, buckets, valid)
                want_h = hc_ref(keys, half, buckets, valid)
                if got_h.dtype != torch.bfloat16:
                    raise AssertionError(f"{label}: bf16 in, "
                                         f"{got_h.dtype} out")
                torch.testing.assert_close(got_h.float(), want_h.float(),
                                           rtol=2e-2, atol=1e-2)
                err_h = float((got_h.float() - want_h.float()).abs().max())
                t = _hc_times(torch, hc, hc_ref, keys, vals, valid, buckets)
                print(f"hash_combine {label}: integer bit-identical; real "
                      f"max |err| {err_r:.3g} (rel {rel_r:.3g}); bf16 max "
                      f"|err| {err_h:.3g}; kernel {t['ms']:.4f} ms per "
                      f"wrapper call (device time {t['device']}), plain "
                      f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
                      f"ms ({t['bound_by']}), library "
                      f"{t['library_ms']:.4f} ms", flush=True)
                del keys, vals, valid, real, half
    return worst


def phase_hash_combine_main_shape(torch, hc, hc_ref, wc, shards_dev) -> dict:
    """Phase 6a: the kernel at the main path's shape (2**28 records,
    D = 1, B = 1000), bit-identical to the plain version, with the times
    the kernels line reports."""
    from repro_torch.core.mapreduce import wordcount_map_factory
    from repro_torch.engine.plan import map_shards
    keys, vals, valid = map_shards(shards_dev,
                                   wordcount_map_factory(wc.VOCAB),
                                   shards_dev.shape[0])
    got = hc.combine(keys, vals, wc.VOCAB, valid)
    want = hc_ref(keys, vals, wc.VOCAB, valid)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("hash_combine != plain version at the main "
                             "path's shape")
    t = _hc_times(torch, hc, hc_ref, keys, vals, valid, wc.VOCAB)
    print(f"hash_combine main-path shape N={keys.numel()} B={wc.VOCAB} "
          f"D=1: bit-identical; kernel {t['ms']:.4f} ms per wrapper call "
          f"(device time {t['device']}, torch.profiler), plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}), bincount {t['library_ms']:.4f} ms",
          flush=True)
    return {"max_abs_err": float((got - want).abs().max()), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def _timed_run(torch, built, data) -> tuple[float, object]:
    """Host wall time of one ``built.run(data)``, ending in a
    synchronise, and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = built.run(data)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def phase_wordcount(torch, hc, wc, shards) -> int:
    """Phase 6b: wordcount-hibench-large end to end on the card.  Returns
    hash_combine's launches during the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = shards.shape[0] * shards.shape[1]
    t0 = time.perf_counter()
    oracle = wc.oracle(shards)
    print(f"wordcount: oracle (np.bincount over {n} tokens) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    built = wc.pipeline(shards).build(num_buckets=wc.VOCAB,
                                      n_workers=shards.shape[0],
                                      device="cuda", job_id=wc.NAME)
    hc.combine.launches = 0
    wall, (counts, stats) = _timed_run(torch, built, None)
    launches = hc.combine.launches
    if launches != 1:
        raise AssertionError(f"hash_combine launched {launches} times in "
                             f"one batch run; the design launches it once")
    got = counts.cpu().numpy()
    if got.shape != (wc.VOCAB,) or not np.array_equal(got, oracle):
        bad = np.flatnonzero(got[:wc.VOCAB] != oracle)[:4]
        raise AssertionError(f"word counts differ from the oracle at "
                             f"{bad.tolist()} (shape {got.shape})")
    if int(stats.sent) != n or int(stats.dropped) != 0:
        raise AssertionError(f"stats sent={int(stats.sent)} "
                             f"dropped={int(stats.dropped)} for {n} tokens")
    print(f"main-path {wc.NAME}: {n} tokens in {wall:.4f} s = "
          f"{n / wall:.0f} tokens/s (first run, shards handed over from the "
          f"host); {launches} hash_combine launch; counts == np.bincount "
          f"oracle for all {wc.VOCAB} words (min {int(oracle.min())}, max "
          f"{int(oracle.max())})", flush=True)
    walls = [wall] + [_timed_run(torch, built, None)[0] for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards_dev = torch.from_numpy(shards).to(built.device)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    dev_walls = []
    for _ in range(3):
        dwall, (counts2, _) = _timed_run(torch, built, shards_dev)
        dev_walls.append(dwall)
        if not torch.equal(counts2, counts):
            raise AssertionError("a run on device-resident shards gave "
                                 "other counts")
    med = statistics.median(walls)
    print(f"main-path {wc.NAME} walls from host shards "
          f"{[round(w, 4) for w in walls]} s (median {med:.4f} s = "
          f"{n / med:.0f} tokens/s); the {shards.nbytes} B host-to-device "
          f"copy alone {copy_s:.4f} s = {100 * copy_s / med:.1f}% of the "
          f"median; walls from device-resident shards "
          f"{[round(w, 4) for w in dev_walls]} s", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall2, _ = _timed_run(torch, built, shards_dev)
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA]
    kernel_us = sum(_device_us(ev) for ev in events
                    if any(k in ev.key for k in HC_KERNELS))
    device_us = sum(_device_us(ev) for ev in events)
    print(f"main-path {wc.NAME} profiled run on device-resident shards: "
          f"wall {wall2:.4f} s; hash_combine kernels {kernel_us / 1e3:.3f} "
          f"ms = {100 * kernel_us / 1e6 / med:.2f}% of the median wall "
          f"from host shards; all device work {device_us / 1e3:.3f} ms = "
          f"{100 * device_us / 1e6 / wall2:.1f}% of this run's wall",
          flush=True)
    for ev in sorted(events, key=_device_us, reverse=True)[:8]:
        print(f"  device {_device_us(ev) / 1e3:9.3f} ms  {ev.key[:90]}")
    return launches


def phase_hashed(torch, hc, wc) -> None:
    """Phase 7: hashed key space with exact collision accounting, card
    against CPU."""
    shards = wc.token_shards(SEED + 7, n_tokens=HASHED["n_tokens"],
                             vocab=HASHED["vocab"])
    out = {}
    for device in ("cuda", "cpu"):
        before = hc.combine.launches
        built = wc.pipeline(shards, vocab=HASHED["vocab"]).build(
            num_buckets=HASHED["buckets"], n_workers=shards.shape[0],
            key_space="hashed", device=device)
        counts, stats = built.run()
        out[device] = (counts.cpu(), int(stats.sent),
                       stats.bucket_collisions.cpu())
        print(f"hashed on {device}: {HASHED['n_tokens']} tokens over "
              f"{HASHED['vocab']} ids into {HASHED['buckets']} buckets, "
              f"{int(stats.collisions)} colliding ids, "
              f"{hc.combine.launches - before} hash_combine launches",
              flush=True)
    (gc, gs, gcol), (cc, cs, ccol) = out["cuda"], out["cpu"]
    if not (torch.equal(gc, cc) and gs == cs and torch.equal(gcol, ccol)):
        raise AssertionError("hashed word count differs between cuda and "
                             "cpu")
    if int(gcol.sum()) == 0:
        raise AssertionError("hashed phase exercised no collisions")
    print("hashed: counts, sent and per-bucket collisions equal between "
          "device='cuda' and device='cpu'")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_fold import ops
    from repro_torch.kernels.fused_fold.ref import fused_streaming_fold_ref
    from repro_torch.kernels.hash_combine import ops as hc
    from repro_torch.kernels.hash_combine.ref import hash_combine_ref
    from repro_torch.workloads import linear_road as lr
    from repro_torch.workloads import wordcount as wc

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all(["fused_fold", "hash_combine"])
    print(f"fused_fold and hash_combine built together (nvcc, sm_90a, one "
          f"process each) in {time.perf_counter() - t0:.1f} s")
    ops.library()
    hc.library()

    worst = phase_kernel(torch, ops, fused_streaming_fold_ref, device)
    main_shape = phase_kernel_main_shape(torch, ops, fused_streaming_fold_ref,
                                         lr, device)
    launches = phase_main_path(torch, ops, lr)
    phase_sessions(ops)

    hc_worst = phase_hash_combine(torch, hc, hash_combine_ref, device)
    t0 = time.perf_counter()
    shards = wc.token_shards(SEED, **wc.FULL)
    print(f"wordcount: {shards.shape} int32 shards generated on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    hc_shape = phase_hash_combine_main_shape(
        torch, hc, hash_combine_ref, wc, torch.from_numpy(shards).to(device))
    torch.cuda.empty_cache()
    hc_launches = phase_wordcount(torch, hc, wc, shards)
    del shards
    phase_hashed(torch, hc, wc)

    kernel = {"name": "fused_fold", "route": "cuda",
              "source": "src/repro_torch/kernels/fused_fold/csrc/"
                        "fused_fold.cu",
              "replaces": "src/repro/kernels/fused_fold/kernel.py:64",
              "launches": launches}
    kernel.update(main_shape)
    kernel["max_abs_err"] = max(worst, main_shape["max_abs_err"])
    combine = {"name": "hash_combine", "route": "cuda",
               "source": "src/repro_torch/kernels/hash_combine/csrc/"
                         "hash_combine.cu",
               "replaces": "src/repro/kernels/hash_combine/kernel.py:36",
               "launches": hc_launches}
    combine.update(hc_shape)
    combine["max_abs_err"] = max(hc_worst, hc_shape["max_abs_err"])
    print(json.dumps({"kernels": [kernel, combine]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
