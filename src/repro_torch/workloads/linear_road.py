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
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

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
