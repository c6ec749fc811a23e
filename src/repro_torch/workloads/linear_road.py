"""``linear-road-lav`` — Linear Road's segment statistics as a streaming job.

Source: Linear Road (Arasu et al., "Linear Road: A Stream Data Management
Benchmark", VLDB 2004).  Every vehicle on an expressway sends a position
report every 30 s; an expressway has 100 one-mile segments in each of 2
directions; the segment statistics (LAV, the latest average velocity) are
taken over the previous 5 minutes and updated every minute.

The job: records ``(ts, "xway:dir:seg", speed)`` keyed by segment over a
dense key space of ``L * 200`` keys, ``Windowing.sliding(300.0, 60.0)``
(fan-out 5, on the device wire), ``reduce("mean")``, with
``allowed_lateness=5.0`` and ``n_slots=8`` (>= ``min_slots_required(300,
60, 5) = 7``), ``batch_records=65536``.  The full configuration is
``L = 50`` expressways (10,000 segment keys), 50,000 vehicles (100,000
reports per minute of event time) and 10 minutes (1,000,000 reports).
Speeds are integers 0-100 mph; upload jitter is Gaussian with σ = 0.5 s,
so the log (in upload order) is mildly out of event-time order.

``reduced`` — what this configuration cuts from Linear Road:

* 10 minutes of event time instead of 3 hours;
* vehicle density: 1,000 vehicles per expressway (about 33 reports/s),
  about 30x below Linear Road's, whose one-expressway stream carries on
  the order of 10^4 vehicles (roughly 12M reports over 3 hours).  So one
  65,536-report micro-batch spans about 39 s of event time here instead
  of about 1.2 s, and the run finalizes a window (10,000 segment means)
  every 1.5 micro-batches instead of about every 50: window finalization
  weighs about 30x more per report than at the benchmark's density, and
  the fold and per-record admission correspondingly less;
* LAV is the count-weighted mean of every report in the window, not the
  benchmark's mean of per-minute averages;
* no tolls, accident detection or historical queries.

The device state is the carry, 8 slots × 10,000 segments × 2 channels ×
4 B ≈ 0.64 MB — small by nature, as segment statistics are; what is at
full size is the stream (about 330,000 live (report, window) pairs per
micro-batch).

Two more programs read the same reports, with numpy oracles:

* ``congestion_chain`` — a stage DAG.  Stage 1 counts reports per segment
  per minute (``tumbling(60)``, ``count``) and tees into (a) a device
  edge: the ``sliding(300, 60)`` ``mean`` of the per-minute counts, then
  ``top_k(100)`` — the most congested segments of the last 5 minutes —
  and (b) a host edge: ``key_by`` the expressway of the segment label,
  ``tumbling(300)`` ``sum`` — vehicles reported per expressway.
* ``toll_inputs_join`` — a windowed join, per segment and minute
  (``tumbling(60)``), of the mean speed from one log with the report
  count from a second log (the same reports under another prefix): the
  pair a Linear Road-style toll check reads.  Not the benchmark's toll
  rule, whose LAV spans 5 minutes while its vehicle count spans 1 (one
  join has one window).
* ``segment_median_pipeline`` — the median speed per segment over LAV's
  window (``sliding(300, 60)``), in group mode: a median is the reduce a
  combiner cannot fuse, so every report of a window is buffered on the
  device (``capacity`` records per worker and window slot) and
  ``median_reduce`` runs over each segment's full list when the window
  finalizes.  Linear Road's statistic is the mean (LAV); the median is
  the robust variant of it, over the same reports and windows.

Every value they fold is integer-valued (counts, integer speeds), so the
card's sinks equal the plain fold's byte for byte in any atomic order,
and a median of integer speeds is exact in float32.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..engine.stages import INT32_MAX, sorted_runs
from ..pipeline.graph import Pipeline, Windowing

WINDOW_SIZE = 300.0         # LAV covers the previous 5 minutes ...
WINDOW_SLIDE = 60.0         # ... updated every minute
REPORT_INTERVAL = 30.0      # one position report per vehicle every 30 s
SEGMENTS_PER_DIRECTION = 100
ALLOWED_LATENESS = 5.0
N_SLOTS = 8
BATCH_RECORDS = 65536
JITTER_SIGMA = 0.5

#: the full configuration the chip smoke drives
FULL = {"n_xways": 50, "n_vehicles": 50_000, "minutes": 10}

MINUTE = 60.0               # per-minute statistics (counts, toll inputs)
#: segment_median_pipeline's records a (worker, window slot) buffer holds:
#: a window holds about 500,000 reports at the full density, about 62,500
#: for each of 8 workers — 2**17 leaves room for the hash partition's skew
MEDIAN_CAPACITY = 1 << 17
TOP_K = 100                 # congestion_chain: most congested segments
XWAY_BUCKETS = 64           # congestion_chain branch (b): >= 50 xways


def num_segments(n_xways: int) -> int:
    """Dense key-space width: 2 directions × 100 segments per expressway."""
    return n_xways * 2 * SEGMENTS_PER_DIRECTION


def position_reports(seed: int, *, n_xways: int, n_vehicles: int,
                     minutes: float) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """Synthetic position reports in upload order: ``(ts, segment_id,
    speed)`` arrays, with ``segment_id`` in ``[0, num_segments)``.

    Each vehicle drives one direction of one expressway from a random
    segment at a cruising speed with per-report noise (integer mph,
    clipped to 0-100), reporting every 30 s from a random phase; the
    event time carries the upload jitter, the log order does not."""
    rng = np.random.default_rng(seed)
    per = int(minutes * 60.0 / REPORT_INTERVAL)
    xway = rng.integers(0, n_xways, n_vehicles)
    direction = rng.integers(0, 2, n_vehicles)
    start_seg = rng.integers(0, SEGMENTS_PER_DIRECTION, n_vehicles)
    cruise = rng.integers(30, 80, n_vehicles)
    phase = rng.uniform(0.0, REPORT_INTERVAL, n_vehicles)
    k = np.arange(per)
    nominal = phase[:, None] + REPORT_INTERVAL * k[None, :]      # (V, per)
    speed = np.clip(cruise[:, None] + rng.integers(-15, 16, (n_vehicles, per)),
                    0, 100)
    miles = np.cumsum(speed * (REPORT_INTERVAL / 3600.0), axis=1) \
        - speed * (REPORT_INTERVAL / 3600.0)
    seg = (start_seg[:, None] + np.floor(miles).astype(np.int64)) \
        % SEGMENTS_PER_DIRECTION
    seg_id = (xway[:, None] * 2 + direction[:, None]) \
        * SEGMENTS_PER_DIRECTION + seg
    event_ts = np.clip(nominal + rng.normal(0.0, JITTER_SIGMA, nominal.shape),
                       0.0, None)
    order = np.argsort(nominal, axis=None, kind="stable")
    return (event_ts.reshape(-1)[order], seg_id.reshape(-1)[order],
            speed.reshape(-1)[order].astype(np.float64))


def segment_label(seg_id: int) -> str:
    """``"xway:dir:seg"`` for a dense segment id."""
    xd, seg = divmod(int(seg_id), SEGMENTS_PER_DIRECTION)
    xway, direction = divmod(xd, 2)
    return f"{xway}:{direction}:{seg}"


def records(ts: np.ndarray, seg_id: np.ndarray,
            speed: np.ndarray) -> list[tuple[float, str, float]]:
    """The reports as event-log records ``(ts, "xway:dir:seg", speed)``."""
    labels = [segment_label(s) for s in range(int(seg_id.max()) + 1)]
    return [(float(t), labels[s], float(v))
            for t, s, v in zip(ts.tolist(), seg_id.tolist(), speed.tolist())]


def lav_pipeline(prefix: str, sink: str = "lav/") -> Pipeline:
    """The job: LAV per segment over sliding 5-minute windows."""
    return (Pipeline.from_source(prefix=prefix, batch_records=BATCH_RECORDS)
            .key_by()
            .window(Windowing.sliding(WINDOW_SIZE, WINDOW_SLIDE))
            .reduce("mean")
            .sink(sink))


def build_options(n_xways: int) -> dict:
    """``Pipeline.build`` options of the configuration (minus ``device``
    and ``job_id``)."""
    return dict(num_buckets=num_segments(n_xways), n_workers=8,
                n_slots=N_SLOTS, allowed_lateness=ALLOWED_LATENESS)


def lav_oracle(ts: np.ndarray, seg_id: np.ndarray, speed: np.ndarray
               ) -> dict[float, dict[str, float]]:
    """Vectorised numpy oracle: window start → {segment label: mean speed},
    for every report folded into every sliding window that contains it
    (assumes no report arrives later than the allowed lateness).  The mean
    is ``np.float32(sum) / np.float32(count)``, the float32 quotient the
    coordinator emits; sums of integer speeds are exact."""
    last = np.floor(ts / WINDOW_SLIDE).astype(np.int64)
    first = np.floor((ts - WINDOW_SIZE) / WINDOW_SLIDE).astype(np.int64) + 1
    n_keys = int(seg_id.max()) + 1
    fanout = int(np.ceil(WINDOW_SIZE / WINDOW_SLIDE))
    w_all, k_all, v_all = [], [], []
    for j in range(fanout):
        w = last - j
        keep = w >= first
        w_all.append(w[keep])
        k_all.append(seg_id[keep])
        v_all.append(speed[keep])
    w = np.concatenate(w_all)
    k = np.concatenate(k_all)
    v = np.concatenate(v_all)
    w0 = int(w.min())
    flat = (w - w0) * n_keys + k
    n = int(flat.max()) + 1
    sums = np.bincount(flat, weights=v, minlength=n)
    counts = np.bincount(flat, minlength=n)
    out: dict[float, dict[str, float]] = defaultdict(dict)
    for f in np.nonzero(counts)[0]:
        widx, key = divmod(int(f), n_keys)
        mean = np.float32(sums[f]) / np.float32(counts[f])
        out[(widx + w0) * WINDOW_SLIDE][segment_label(key)] = float(mean)
    return dict(out)


# ---------------------------------------------------------------------------
# congestion_chain: a tee'd stage DAG over the reports
# ---------------------------------------------------------------------------

def xway_of(rec) -> str:
    """The expressway of a ``(ts, "xway:dir:seg", value)`` record."""
    return rec[1].split(":", 1)[0]


def congestion_chain(prefix: str, top_sink: str = "congested/",
                     xway_sink: str = "xway-volume/") -> Pipeline:
    """Reports per segment per minute, teed into (a) the ``TOP_K``
    segments by mean per-minute count over sliding 5-minute windows (an
    identity boundary: a device edge) and (b) reports per expressway per
    5 minutes (a ``key_by`` boundary: a host edge)."""
    counts = (Pipeline.from_source(prefix=prefix,
                                   batch_records=BATCH_RECORDS)
              .key_by().window(Windowing.tumbling(MINUTE)).reduce("count"))
    return counts.tee(
        Pipeline.branch()
        .window(Windowing.sliding(WINDOW_SIZE, WINDOW_SLIDE))
        .reduce("mean").top_k(TOP_K).sink(top_sink),
        Pipeline.branch().key_by(xway_of)
        .window(Windowing.tumbling(WINDOW_SIZE))
        .reduce("sum", num_buckets=XWAY_BUCKETS).sink(xway_sink))


def congestion_oracle(ts: np.ndarray, seg_id: np.ndarray
                      ) -> tuple[dict[float, list], dict[float, dict]]:
    """numpy oracle of ``congestion_chain``: ``(top, volume)`` with
    ``top`` window start → ``[(label, mean), ...]`` (rank order) and
    ``volume`` window start → {xway label: reports}.

    A segment's value in a sliding window is the float32 mean of its
    per-minute report counts over the minutes of the window in which it
    reported.  Ties rank by the segment's first appearance in the log:
    the ranking stage's key ids are assigned in that order (its
    dictionary registers a key when the first stage first sees it), and
    ``stages.top_k_buckets`` breaks ties toward the lower id.  Assumes no
    report arrives later than the allowed lateness."""
    n_keys = int(seg_id.max()) + 1
    minute = np.floor(ts / MINUTE).astype(np.int64)
    m0 = int(minute.min())
    per_min = np.bincount((minute - m0) * n_keys + seg_id,
                          minlength=(int(minute.max()) - m0 + 1) * n_keys
                          ).reshape(-1, n_keys).astype(np.float64)
    first = np.full(n_keys, len(seg_id))
    uniq, idx = np.unique(seg_id, return_index=True)
    first[uniq] = idx
    fanout = int(np.ceil(WINDOW_SIZE / WINDOW_SLIDE))
    per = int(WINDOW_SLIDE // MINUTE)       # minutes a slide (1)
    top: dict[float, list] = {}
    n_min = per_min.shape[0]
    for w in range(m0 // per - fanout + 1, (m0 + n_min - 1) // per + 1):
        lo, hi = w * per - m0, w * per - m0 + fanout * per
        block = per_min[max(lo, 0):max(min(hi, n_min), 0)]
        if block.size == 0 or not block.any():
            continue
        sums = block.sum(axis=0).astype(np.float32)
        cnt = (block > 0).sum(axis=0).astype(np.float32)
        keys = np.nonzero(cnt)[0]
        means = sums[keys] / cnt[keys]
        order = np.lexsort((first[keys], -means))[:TOP_K]
        top[w * WINDOW_SLIDE] = [(segment_label(keys[i]), float(means[i]))
                                 for i in order]
    xway = seg_id // (2 * SEGMENTS_PER_DIRECTION)
    win = np.floor(minute * MINUTE / WINDOW_SIZE).astype(np.int64)
    volume: dict[float, dict] = defaultdict(dict)
    n_x = int(xway.max()) + 1
    w0 = int(win.min())
    flat = np.bincount((win - w0) * n_x + xway)
    for f in np.nonzero(flat)[0]:
        w, x = divmod(int(f), n_x)
        volume[(w + w0) * WINDOW_SIZE][str(x)] = float(flat[f])
    return top, dict(volume)


# ---------------------------------------------------------------------------
# toll_inputs_join: mean speed ⋈ report count per segment per minute
# ---------------------------------------------------------------------------

def toll_inputs_join(speed_prefix: str, count_prefix: str,
                     sink: str = "toll-inputs/") -> Pipeline:
    """Per segment and minute, the mean speed (from ``speed_prefix``)
    joined with the report count (from ``count_prefix``)."""
    speeds = (Pipeline.from_source(prefix=speed_prefix,
                                   batch_records=BATCH_RECORDS)
              .key_by().window(Windowing.tumbling(MINUTE)).reduce("mean"))
    volume = (Pipeline.from_source(prefix=count_prefix,
                                   batch_records=BATCH_RECORDS)
              .key_by().window(Windowing.tumbling(MINUTE)).reduce("count"))
    return speeds.join(volume).sink(sink)


def toll_inputs_oracle(ts: np.ndarray, seg_id: np.ndarray,
                       speed: np.ndarray) -> dict[float, dict[str, list]]:
    """numpy oracle of ``toll_inputs_join`` over one log written under
    both prefixes: window start → {segment label: [mean speed, reports]},
    the mean as the float32 quotient the coordinator emits."""
    n_keys = int(seg_id.max()) + 1
    minute = np.floor(ts / MINUTE).astype(np.int64)
    m0 = int(minute.min())
    flat = (minute - m0) * n_keys + seg_id
    sums = np.bincount(flat, weights=speed)
    counts = np.bincount(flat)
    out: dict[float, dict[str, list]] = defaultdict(dict)
    for f in np.nonzero(counts)[0]:
        m, key = divmod(int(f), n_keys)
        mean = np.float32(sums[f]) / np.float32(counts[f])
        out[(m + m0) * MINUTE][segment_label(key)] = [float(mean),
                                                      int(counts[f])]
    return dict(out)


# ---------------------------------------------------------------------------
# segment_median_pipeline: the median speed per segment, in group mode
# ---------------------------------------------------------------------------

def median_reduce(keys: torch.Tensor, values: torch.Tensor,
                  starts: torch.Tensor):
    """Group reducer: the median of each key group's values over a
    key-sorted, group-marked stream (the ``(keys, values, starts) -> (gk,
    gv, gvalid)`` contract of ``engine.stages``), the mean of the two
    middle values for an even count.  Values sort within their group by
    two stable sorts (by value, then by group); everything stays on the
    stream's device."""
    n = keys.shape[0]
    valid = keys != INT32_MAX
    seg = torch.cumsum(starts, 0, dtype=torch.int64) - 1
    seg = torch.where(valid, seg, n)
    by_value = torch.argsort(values, stable=True)
    order = by_value[torch.argsort(seg[by_value], stable=True)]
    v = values[order]
    s = seg[order]
    counts, offsets = sorted_runs(s, n)
    lo = torch.clamp(offsets + torch.div(counts - 1, 2,
                                         rounding_mode="floor"), 0, n - 1)
    hi = torch.clamp(offsets + torch.div(counts, 2, rounding_mode="floor"),
                     0, n - 1)
    med = (v[lo] + v[hi]) / 2.0
    group_keys = torch.where(counts > 0,
                             keys.to(torch.int32)[offsets.clamp(max=n - 1)],
                             -1)
    group_valid = (group_keys >= 0) & (counts > 0)
    return group_keys, torch.where(group_valid, med, 0.0), group_valid


def segment_median_pipeline(prefix: str, capacity: int = MEDIAN_CAPACITY,
                            sink: str = "median-speed/") -> Pipeline:
    """The median speed per segment over sliding 5-minute windows, as a
    group-mode job (build it with ``build_options``)."""
    return (Pipeline.from_source(prefix=prefix, batch_records=BATCH_RECORDS)
            .key_by()
            .window(Windowing.sliding(WINDOW_SIZE, WINDOW_SLIDE))
            .reduce(median_reduce, mode="group", capacity=capacity)
            .sink(sink))


def median_oracle(ts: np.ndarray, seg_id: np.ndarray, speed: np.ndarray
                  ) -> dict[float, dict[str, float]]:
    """numpy oracle of ``segment_median_pipeline``: window start →
    {segment label: median speed} over every report of every sliding
    window containing it (assumes no report arrives later than the
    allowed lateness).  Medians of integer speeds are halves of integers
    at most 100, exact in float32."""
    last = np.floor(ts / WINDOW_SLIDE).astype(np.int64)
    first = np.floor((ts - WINDOW_SIZE) / WINDOW_SLIDE).astype(np.int64) + 1
    n_keys = int(seg_id.max()) + 1
    fanout = int(np.ceil(WINDOW_SIZE / WINDOW_SLIDE))
    w = np.concatenate([last - j for j in range(fanout)])
    k = np.tile(seg_id, fanout)
    v = np.tile(speed, fanout)
    keep = w >= np.tile(first, fanout)
    w, k, v = w[keep], k[keep], v[keep]
    w0 = int(w.min())
    flat = (w - w0) * n_keys + k
    order = np.lexsort((v, flat))
    flat, v = flat[order], v[order]
    groups, starts, counts = np.unique(flat, return_index=True,
                                       return_counts=True)
    med = (v[starts + (counts - 1) // 2] + v[starts + counts // 2]) / 2.0
    out: dict[float, dict[str, float]] = defaultdict(dict)
    for f, m in zip(groups.tolist(), med.tolist()):
        widx, key = divmod(f, n_keys)
        out[(widx + w0) * WINDOW_SLIDE][segment_label(key)] = m
    return dict(out)
