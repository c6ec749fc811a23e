"""Key hashing, the shuffles, window fan-out and heavy-hitter selection.

The reference's stage library, on torch tensors: host and device key
folding (``fold_key24`` → ``device_hash`` / ``host_bucket``,
bit-identical to one another and to the reference); the batch plans'
aggregating shuffle — the Mapper's combiner (``local_combine_dense``, the
``hash_combine`` kernel) with exact per-bucket collision accounting for
hashed key spaces (``distinct_keys_per_bucket``); the grouping shuffle
of group mode (``build_send_buffers`` → ``exchange`` →
``sort_and_group`` → ``segment_reduce`` / a user reducer); the on-device
window fan-out and the windowed group-mode record buffers
(``window_fanout``, ``append_window_records``, ``gather_window_group``,
``clear_window_group``); the fixed-capacity top-k over a dense
aggregate; and the carry handoff (``carry_handoff_rows``), which turns
one finalized window of a stage into the next stage's wire rows on the
device.  The streaming aggregate fold (fan-out plus scatter-accumulate)
is the fused fold kernel (``kernels/fused_fold``); group mode has no
kernel of its own in either package — its stages are plain tensor ops
(sorts, scans, scatters), on the device of the tensors they are given.

The reference runs these stages once per worker under ``vmap`` or
``shard_map`` and finishes with a collective.  Here the stages that end in
one take a worker axis (``engine.compile``): ``SimulatedAxis`` holds every
worker on one device, ``DistributedAxis`` is this rank of a
``torch.distributed`` group, and each stage is written once over the
axis's four collectives.  A tensor held per worker carries a leading axis
of the process's local workers (all of them when simulated, one on a
rank).  The aggregating shuffle combines the process's records in one
``hash_combine`` launch and reduce-scatters the sum (``psum_scatter``: on
the simulated axis the one combine over every worker's records already is
the sum over senders, so the scatter only cuts out each owner's slice);
the grouping shuffle routes records to their owners with ``all_to_all``,
so capacity drops and the order of a key's values follow from which
worker sent what, as in the reference; the distinct-key count and a
windowed group stage's finalization gather over ``all_gather``.

**A user's group reducer** has the reference's contract: ``reduce_fn(keys,
values, starts) -> (group_keys, group_values, group_valid)`` over one
worker's key-sorted, group-marked stream of length ``n`` (the output of
``sort_and_group``: int32 ``keys`` with ``INT32_MAX`` on the invalid
tail, ``values`` ``(n,)`` or ``(n, D)``, int32 ``starts`` with 1 where a
key group begins), all torch tensors on the carry's device.  It returns
three tensors of length ``n`` on that device — the group's key (``-1``
where invalid), its reduced value and a bool validity mask — and must
not read them back to the host (``workloads.linear_road.median_reduce``
is one).  The built-in kinds are ``SEGMENT_REDUCE_KINDS``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.fused_fold.ref import murmur32
from ..kernels.hash_combine import ops as hash_combine
from .compile import SimulatedAxis

#: raw hashed-key ids must survive the float32 wire exactly
RAW_KEY_BITS = 24
#: the reference's sentinel for an empty key slot (send buffers, window
#: record buffers)
INVALID = -1
#: the sort sentinel of invalid records (``sort_and_group``, the
#: distinct-key exchange)
INT32_MAX = 2 ** 31 - 1


def device_hash(keys: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over int32 keys, as int64 values in
    ``[0, 2**32)`` — the bits the reference's uint32 hash gives."""
    return murmur32(keys)


def hash_partition(keys: torch.Tensor, n_partitions: int) -> torch.Tensor:
    """``hash(key) % R`` → int32 destination partition (reducer) per
    record."""
    return (device_hash(keys) % n_partitions).to(torch.int32)


def bucketize(keys: torch.Tensor, num_buckets: int, *,
              hashed: bool) -> torch.Tensor:
    """Raw int32 keys → int32 bucket ids in ``[0, num_buckets)``: dense
    keys pass through, hashed keys fold through ``device_hash``."""
    keys = keys.to(torch.int32)
    if hashed:
        return (device_hash(keys) % num_buckets).to(torch.int32)
    return keys


# ---------------------------------------------------------------------------
# Local combine (the Mapper's sort+combiner, §III-A.3) and the shuffle
# ---------------------------------------------------------------------------

def local_combine_dense(keys: torch.Tensor, values: torch.Tensor,
                        num_buckets: int,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Combine records into a dense per-bucket sum (``(num_buckets,)`` or
    ``(num_buckets, D)``), born sorted by bucket id: the ``hash_combine``
    kernel on CUDA tensors, its plain version on CPU tensors.  Keys
    outside ``[0, num_buckets)`` and invalid rows are dropped."""
    return hash_combine.combine(keys, values, num_buckets, valid)


def resolve_combine_fn(combine_fn):
    """Resolve a combiner spec to a callable: ``None`` and ``"pallas"``
    (the reference's name for its kernel) both name the ``hash_combine``
    kernel here; a callable ``combine_fn(keys, values, num_buckets,
    valid)`` passes through."""
    if combine_fn is None or combine_fn == "pallas":
        return local_combine_dense
    if callable(combine_fn):
        return combine_fn
    raise ValueError(f"combine_fn must be None, 'pallas' or a callable, "
                     f"got {combine_fn!r}")


def shuffle_aggregate(keys: torch.Tensor, values: torch.Tensor, axis,
                      num_buckets: int, valid: torch.Tensor | None = None,
                      combine_fn=None) -> torch.Tensor:
    """Aggregating shuffle: the combiner's dense ``(num_buckets, ...)`` sum
    of this process's records (every worker's on the simulated axis), then
    the reduce-scatter over ``axis``.  Returns ``(local workers,
    num_buckets / W, ...)``: worker ``w`` owns the contiguous slice ``[w *
    per, (w + 1) * per)`` of the sum over every worker, which is what the
    reference's ``psum_scatter`` hands out."""
    local = resolve_combine_fn(combine_fn)(keys, values, num_buckets, valid)
    return axis.psum_scatter(local)


def shuffle_aggregate_windowed(window_slots: torch.Tensor, keys: torch.Tensor,
                               values: torch.Tensor, axis, n_slots: int,
                               num_buckets: int,
                               valid: torch.Tensor | None = None,
                               combine_fn=None) -> torch.Tensor:
    """Windowed aggregating shuffle: each record's (window slot, bucket)
    pair flattened into one dense id space of ``n_slots * num_buckets``
    and folded through ``shuffle_aggregate``.  Returns each local worker's
    contiguous slice of the flattened ``(n_slots * num_buckets, ...)``
    update, as the reference's does.  The port's streaming plans fold
    through ``fused_fold`` instead; this keeps the reference's surface
    (``core.shuffle``)."""
    flat = window_slots.to(torch.int32) * num_buckets + keys.to(torch.int32)
    return shuffle_aggregate(flat, values, axis, n_slots * num_buckets,
                             valid=valid, combine_fn=combine_fn)


def bucket_owner(num_buckets: int, n_partitions: int) -> np.ndarray:
    """Host helper: which partition owns each bucket id under the
    aggregating shuffle's tiled scatter (contiguous ranges over the padded
    bucket space — see ``KeySpace.padded``)."""
    per = -(-num_buckets // n_partitions)
    return np.minimum(np.arange(num_buckets) // per, n_partitions - 1)


@dataclass(frozen=True)
class ShuffleStats:
    """Accounting of one batch run, the analogue of the paper's
    bytes_in/bytes_out: ``sent`` valid records, ``dropped`` records (0 for
    the aggregating shuffle, which never drops; the grouping shuffle drops
    past its per-partition ``capacity``), and for hashed key spaces with
    collision tracking ``bucket_collisions`` — per bucket, how many
    *extra* distinct raw keys share it (``distinct - 1``, at least 0).
    Tensors on the run's device."""

    sent: torch.Tensor
    dropped: torch.Tensor
    bucket_collisions: torch.Tensor | None = None

    @property
    def collisions(self):
        """Total colliding-key count over all buckets (0 when
        untracked)."""
        if self.bucket_collisions is None:
            return 0
        return torch.sum(self.bucket_collisions)


def sorted_runs(ids: torch.Tensor, length: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(counts, offsets)`` of each value ``v`` in ``[0, length)`` in the
    non-decreasing int64 ``ids``: how many there are and where the first
    stands.  A binary search a value — no atomics, which would pile up on
    the few addresses of a skewed key set, and nothing read back to the
    host (``torch.bincount`` on a card reads the maximum back)."""
    bounds = torch.searchsorted(
        ids, torch.arange(length + 1, dtype=ids.dtype, device=ids.device))
    return bounds[1:] - bounds[:-1], bounds[:-1]


def sort_and_group(keys: torch.Tensor, values: torch.Tensor,
                   valid: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Key-sort records (invalid to the end, as ``INT32_MAX``) — the
    merged, grouped stream the Reducer consumes.  A stable sort, so a
    key's values keep their arrival order.  Returns ``(sorted_keys,
    sorted_values, group_starts)`` with int32 ``group_starts[i] = 1``
    where a new key group begins at ``i``."""
    if valid is None:
        valid = torch.ones_like(keys, dtype=torch.bool)
    sort_keys = torch.where(valid, keys.to(torch.int32), INT32_MAX)
    order = torch.argsort(sort_keys, stable=True)
    sk = sort_keys[order]
    sv = values[order]
    starts = torch.cat([torch.ones(1, dtype=torch.int32, device=sk.device),
                        (sk[1:] != sk[:-1]).to(torch.int32)])
    starts = torch.where(sk == INT32_MAX, 0, starts)
    return sk, sv, starts


def build_send_buffers(keys: torch.Tensor, values: torch.Tensor,
                       n_partitions: int, capacity: int,
                       valid: torch.Tensor | None = None):
    """Pack one worker's records into fixed ``(n_partitions, capacity)``
    send buffers — one spill file per reducer.  Records are stably sorted
    by destination partition (``hash_partition``), so each partition's
    slice keeps arrival order, then truncated to ``capacity``: the rest
    are dropped and counted.  Returns ``(send_keys, send_values,
    send_valid, ShuffleStats)`` with ``INVALID`` / zero / False in empty
    places and int32 scalar ``sent`` / ``dropped``."""
    n = keys.shape[0]
    dev = keys.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    dest = torch.where(valid, hash_partition(keys, n_partitions),
                       n_partitions)    # invalid → virtual partition R
    order = torch.argsort(dest, stable=True)
    d_sorted = dest[order].to(torch.int64)
    k_sorted = keys[order]
    v_sorted = values[order]
    counts, offsets = sorted_runs(d_sorted, n_partitions + 1)
    pos = torch.arange(n, dtype=torch.int64, device=dev) - offsets[d_sorted]
    in_cap = (pos < capacity) & (d_sorted < n_partitions)
    size = n_partitions * capacity
    slot = torch.where(in_cap, d_sorted * capacity + pos, size)
    vshape = tuple(values.shape[1:])
    vmask = in_cap.reshape((-1,) + (1,) * len(vshape))
    send_keys = torch.full((size + 1,), INVALID, dtype=keys.dtype,
                           device=dev)
    send_keys[slot] = torch.where(in_cap, k_sorted, INVALID).to(keys.dtype)
    send_vals = torch.zeros((size + 1,) + vshape, dtype=values.dtype,
                            device=dev)
    send_vals[slot] = torch.where(vmask, v_sorted,
                                  torch.zeros_like(v_sorted))
    send_valid = torch.zeros(size + 1, dtype=torch.bool, device=dev)
    send_valid[slot] = in_cap
    sent = torch.sum(counts[:n_partitions], dtype=torch.int32)
    kept = torch.sum(send_valid[:-1], dtype=torch.int32)
    return (send_keys[:-1].reshape(n_partitions, capacity),
            send_vals[:-1].reshape((n_partitions, capacity) + vshape),
            send_valid[:-1].reshape(n_partitions, capacity),
            ShuffleStats(sent=sent, dropped=sent - kept))


def exchange(send_keys: torch.Tensor, send_values: torch.Tensor,
             send_valid: torch.Tensor, axis=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shuffle proper: the local workers' stacked send buffers
    ``(local, W_dst, cap, ...)`` become their receive buffers ``(local,
    W_src, cap, ...)`` through ``axis.all_to_all`` — row ``q`` of worker
    ``p``'s result came from worker ``q``, as the reference's tiled
    ``all_to_all`` delivers it.  ``axis`` defaults to every worker
    simulated here (a transpose)."""
    axis = axis or SimulatedAxis(send_keys.shape[0])
    return tuple(axis.all_to_all(t)
                 for t in (send_keys, send_values, send_valid))


def shuffle_group(keys: torch.Tensor, values: torch.Tensor,
                  n_partitions: int, capacity: int,
                  valid: torch.Tensor | None = None, axis=None):
    """Grouping shuffle over the worker axis: per-worker send buffers, the
    exchange, and the merge.  ``keys`` / ``valid`` are ``(local, n)`` and
    ``values`` ``(local, n, ...)``, local worker ``w``'s records in row
    ``w``; ``n_partitions`` must be the axis size (one partition a
    worker).  Returns each local worker's key-sorted, group-marked stream
    of its partition as ``(local, W * capacity)`` keys and starts and
    ``(local, W * capacity, ...)`` values, and per-worker ``ShuffleStats``
    (int32 ``(local,)`` ``sent`` / ``dropped``) — what the reference's
    ``vmap`` gives, a rank's row of it under ``shard_map``.  ``axis``
    defaults to every worker simulated here."""
    axis = axis or SimulatedAxis(keys.shape[0])
    if n_partitions != axis.size:
        raise ValueError(f"the grouping exchange gives each of {axis.size} "
                         f"workers one partition; got n_partitions="
                         f"{n_partitions}")
    sends = [build_send_buffers(keys[w], values[w], n_partitions, capacity,
                                None if valid is None else valid[w])
             for w in range(axis.local)]
    rk, rv, rok = exchange(torch.stack([s[0] for s in sends]),
                           torch.stack([s[1] for s in sends]),
                           torch.stack([s[2] for s in sends]), axis)
    vshape = tuple(rv.shape[3:])
    merged = [sort_and_group(rk[w].reshape(-1),
                             rv[w].reshape((-1,) + vshape),
                             rok[w].reshape(-1)) for w in range(axis.local)]
    stats = ShuffleStats(torch.stack([s[3].sent for s in sends]),
                         torch.stack([s[3].dropped for s in sends]))
    return (torch.stack([m[0] for m in merged]),
            torch.stack([m[1] for m in merged]),
            torch.stack([m[2] for m in merged]), stats)


def distinct_keys_per_bucket(raw_keys: torch.Tensor,
                             valid: torch.Tensor | None, axis,
                             num_buckets: int) -> torch.Tensor:
    """Exact global per-bucket distinct-raw-key counts over the valid
    records of every worker, as int32 ``(num_buckets,)``, the same on
    every worker.

    ``raw_keys`` / ``valid`` are ``(local, n)``.  Every worker's keys, the
    invalid ones masked to ``INT32_MAX``, are gathered over ``axis`` (one
    ``all_gather``: a reshape on the simulated axis), then one global
    ``torch.unique`` and one ``bincount`` of the distinct keys' buckets.
    The reference counts the same keys with a dedupe-and-route exchange
    that cannot drop.  ``INT32_MAX`` is the reference's invalid sentinel,
    so a raw key of that value is not counted there either."""
    raw = raw_keys.to(torch.int32)
    keep = raw != INT32_MAX
    if valid is not None:
        keep = keep & valid.to(torch.bool)
    every = axis.all_gather(torch.where(keep, raw, INT32_MAX))
    uniq = torch.unique(every)
    uniq = uniq[uniq != INT32_MAX]
    buckets = bucketize(uniq, num_buckets, hashed=True).to(torch.int64)
    return torch.bincount(buckets, minlength=num_buckets).to(torch.int32)


def fold_key24(key) -> int:
    """Stable host-side key → 24-bit raw id (FNV-1a 64, xor-folded).

    Small enough to ride the float32 wire exactly; the device hashes the
    raw id into buckets with ``device_hash``.  The single host entry point
    for open key domains, so labels and device buckets cannot drift.
    """
    h = 0xCBF29CE484222325
    for b in str(key).encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return (h ^ (h >> 24) ^ (h >> 48)) & ((1 << RAW_KEY_BITS) - 1)


def host_bucket(raw: int, num_buckets: int) -> int:
    """Host mirror of ``device_hash(raw) % num_buckets`` — bit-exact, so
    host-side bookkeeping (bucket labels, session cells) addresses the same
    bucket the device folds the record into."""
    h = raw & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h % num_buckets


def bucket_rank_values(agg: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-bucket ranking value from a ``(buckets, >=2)`` [sum, count]
    aggregate (or a 1-D sum vector): what ``top_k_buckets`` orders by.
    ``kind`` ∈ count | sum | mean (1-D input ranks by the vector)."""
    if agg.dim() == 1:
        return agg
    sums, counts = agg[..., 0], agg[..., 1]
    if kind == "count":
        return counts
    if kind == "sum":
        return sums
    if kind == "mean":
        return sums / torch.clamp(counts, min=1.0)
    raise ValueError(f"unknown top-k ranking kind {kind!r}")


def top_k_buckets(agg: torch.Tensor, k: int, kind: str = "sum"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-k over a dense per-bucket aggregate.

    Empty buckets (count 0, or value 0 for 1-D aggregates) never outrank
    occupied ones and come back invalid.  Ties break toward the lower
    bucket id — a stable descending sort, the order the reference's
    ``lax.top_k`` gives.  Returns ``(bucket_ids, values, valid)`` of
    length ``k``.
    """
    values = bucket_rank_values(agg, kind)
    occupied = (agg[..., 1] > 0) if agg.dim() > 1 else (values != 0)
    masked = torch.where(occupied, values, float("-inf"))
    top_vals, top_ids = torch.sort(masked, descending=True, stable=True)
    top_vals, top_ids = top_vals[:k], top_ids[:k]
    valid = top_vals > float("-inf")
    return (top_ids.to(torch.int32), torch.where(valid, top_vals, 0.0),
            valid)


# ---------------------------------------------------------------------------
# Built-in segment reducers for grouping mode
# ---------------------------------------------------------------------------

#: built-in grouping reducer kinds — the single source of truth for
#: ``segment_reduce`` dispatch and config validation
SEGMENT_REDUCE_KINDS = ("sum", "max", "min", "count", "mean")


def _segment_fold(values: torch.Tensor, seg: torch.Tensor,
                  lengths: torch.Tensor, reduce: str) -> torch.Tensor:
    """Per-segment ``sum`` / ``max`` / ``min`` of contiguous segments
    (``lengths`` of them, in order).  Floating values go through
    ``torch.segment_reduce``, whose order per segment is fixed (a left
    fold on the CPU, the order the reference's scatter gives); integer
    values are exact in any order, so a scatter does."""
    if values.is_floating_point():
        return torch.segment_reduce(values, reduce, lengths=lengths, axis=0,
                                    unsafe=True)
    n_seg = lengths.shape[0]
    out = torch.zeros((n_seg,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    index = seg.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    if reduce == "sum":
        return out.scatter_add_(0, index, values)
    return out.scatter_reduce_(0, index, values,
                               "amax" if reduce == "max" else "amin",
                               include_self=False)


def segment_reduce(kind: str, keys: torch.Tensor, values: torch.Tensor,
                   starts: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reduce a key-sorted, group-marked stream (``sort_and_group``'s
    output: each key group contiguous, invalid records last).

    Returns dense ``(group_keys, group_values, group_valid)`` of the same
    length as the input stream, padded with invalid groups (key ``-1``,
    value 0) — the reference's static shapes.  ``kind`` ∈
    ``SEGMENT_REDUCE_KINDS``; ``count`` of ``(n, D)`` values is ``(n,
    1)``, ``mean`` is the quotient ``sum / max(count, 1)``."""
    if kind not in SEGMENT_REDUCE_KINDS:
        raise ValueError(f"unknown segment reducer {kind!r}")
    n = keys.shape[0]
    valid = keys != INT32_MAX
    seg = torch.cumsum(starts, 0, dtype=torch.int64) - 1
    seg = torch.where(valid, seg, n)    # park invalid records on row n
    lengths, first = sorted_runs(seg, n + 1)
    tail = (1,) * (values.dim() - 1)
    if kind in ("sum", "mean", "count"):
        counts = lengths.to(values.dtype)
        if kind == "count":
            out_v = counts.reshape((n + 1,) + tail) if values.dim() > 1 \
                else counts
        else:
            out_v = _segment_fold(values, seg, lengths, "sum")
            if kind == "mean":
                out_v = out_v / torch.clamp(counts.reshape((-1,) + tail),
                                            min=1.0)
    else:
        out_v = _segment_fold(values, seg, lengths, kind)
    # a group's key is its first record's (every record of it has that
    # key); an empty segment's is -1
    group_keys = torch.where(lengths[:n] > 0,
                             keys.to(torch.int32)[first[:n].clamp(max=n - 1)],
                             -1)
    group_valid = group_keys >= 0
    out_v = out_v[:n]
    out_v = torch.where(group_valid.reshape((-1,) + (1,) * (out_v.dim() - 1)),
                        out_v, torch.zeros_like(out_v))
    return group_keys, out_v, group_valid


def apply_reduce_fn(reduce_fn, keys: torch.Tensor, values: torch.Tensor,
                    starts: torch.Tensor):
    """Dispatch a grouping reducer: a built-in kind name or a user
    callable with the ``(keys, values, starts) -> (gk, gv, gvalid)``
    contract (see the module docstring)."""
    if isinstance(reduce_fn, str):
        return segment_reduce(reduce_fn, keys, values, starts)
    return reduce_fn(keys, values, starts)


# ---------------------------------------------------------------------------
# On-device sliding-window fan-out (broadcast + arange)
# ---------------------------------------------------------------------------

def window_fanout(last_index: torch.Tensor, n_windows: torch.Tensor,
                  keys: torch.Tensor, values: torch.Tensor,
                  valid: torch.Tensor, fanout: int, n_slots: int,
                  min_window):
    """Replicate each record into its overlapping windows on the device.

    A record carries the index of the last window containing it and how
    many consecutive windows do (1..fanout); copy ``j`` covers window
    ``last_index - j`` and is live when ``j < n_windows`` and the window
    is at least ``min_window`` (below it the window already finalized:
    the copy is late and counted).  Ring slots are ``window mod n_slots``
    as a floor mod, as the fused fold computes them.  Returns flattened
    ``(n * fanout,)`` (int32 slots, int32 keys, values, bool live) in
    record-major order, plus int32 scalar (late pairs, live pairs)."""
    n = last_index.shape[0]
    j = torch.arange(fanout, dtype=torch.int32, device=last_index.device)
    widx = last_index.to(torch.int32)[:, None] - j[None, :]
    covers = valid[:, None] & (j[None, :]
                               < n_windows.to(torch.int32)[:, None])
    live = covers & (widx >= min_window)
    late = torch.sum(covers & (widx < min_window), dtype=torch.int32)
    slots = torch.remainder(widx, n_slots)
    keys_f = keys.to(torch.int32)[:, None].expand(n, fanout)
    values_f = values[:, None].expand((n, fanout) + tuple(values.shape[1:]))
    return (slots.reshape(-1), keys_f.reshape(-1),
            values_f.reshape((n * fanout,) + tuple(values.shape[1:])),
            live.reshape(-1), late, torch.sum(live, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Windowed group-mode record buffers (fixed capacity, carried across
# micro-batches)
# ---------------------------------------------------------------------------

def append_window_records(keys_buf: torch.Tensor, vals_buf: torch.Tensor,
                          counts: torch.Tensor, flat_keys: torch.Tensor,
                          values: torch.Tensor, valid: torch.Tensor,
                          n_slots: int, capacity: int, num_buckets: int):
    """Append ``(slot, bucket)`` records (``flat_keys = slot * num_buckets
    + bucket``) into per-slot buffers: ``keys_buf`` ``(n_slots,
    capacity)`` int32 (``INVALID`` = empty), ``vals_buf`` ``(n_slots,
    capacity)``, ``counts`` ``(n_slots,)`` int32.  Records are stably
    slot-sorted, so each lands at ``counts[slot] + its rank within the
    slot`` in arrival order; past ``capacity`` it is dropped and counted.
    Returns new ``(keys_buf, vals_buf, counts, dropped)``; nothing is read
    back to the host."""
    m = flat_keys.shape[0]
    dev = flat_keys.device
    flat = flat_keys.to(torch.int64)
    slot = torch.where(valid, torch.div(flat, num_buckets,
                                        rounding_mode="floor"), n_slots)
    key = torch.remainder(flat, num_buckets)
    order = torch.argsort(slot, stable=True)
    s = slot[order]
    k = key[order]
    v = values[order]
    per_slot, offsets = sorted_runs(s, n_slots + 1)
    base = torch.cat([counts.to(torch.int64),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    pos = base[s] + (torch.arange(m, dtype=torch.int64, device=dev)
                     - offsets[s])
    ok = (s < n_slots) & (pos < capacity)
    size = n_slots * capacity
    dst = torch.where(ok, s * capacity + pos, size)
    vshape = tuple(vals_buf.shape[2:])
    kb = torch.cat([keys_buf.reshape(-1),
                    torch.full((1,), INVALID, dtype=keys_buf.dtype,
                               device=dev)])
    kb[dst] = torch.where(ok, k, INVALID).to(kb.dtype)
    vb = torch.cat([vals_buf.reshape((-1,) + vshape),
                    torch.zeros((1,) + vshape, dtype=vals_buf.dtype,
                                device=dev)])
    vb[dst] = torch.where(ok.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                          torch.zeros_like(v)).to(vb.dtype)
    added = per_slot[:n_slots].to(counts.dtype)
    new_counts = torch.clamp(counts + added, max=capacity)
    dropped = (torch.sum(per_slot[:n_slots], dtype=torch.int32)
               - torch.sum(ok, dtype=torch.int32))
    return (kb[:-1].reshape(keys_buf.shape), vb[:-1].reshape(vals_buf.shape),
            new_counts, dropped)


def gather_window_group(keys_buf: torch.Tensor, vals_buf: torch.Tensor,
                        slot: int, reduce_fn, axis=None):
    """Finalize one window of the grouping carry: slot ``slot`` of every
    worker's buffers gathered in worker order (``axis.all_gather``, the
    reference's tiled ``all_gather``: the local workers' ``(local,
    n_slots, capacity)`` buffers in, every worker's records out),
    key-sorted, and the grouping reducer run over each key's full value
    list.  Returns dense ``(group_keys, group_values, group_valid)`` of
    length ``W * capacity`` on the buffers' device, the same on every
    worker.  ``axis`` defaults to every worker simulated here."""
    axis = axis or SimulatedAxis(keys_buf.shape[0])
    k = axis.all_gather(keys_buf[:, slot])
    v = axis.all_gather(vals_buf[:, slot])
    sk, sv, starts = sort_and_group(k, v, valid=k >= 0)
    return apply_reduce_fn(reduce_fn, sk, sv, starts)


def clear_window_group(keys_buf: torch.Tensor, vals_buf: torch.Tensor,
                       counts: torch.Tensor, slot: int):
    """Reset slot ``slot`` of every worker's ``(W, n_slots, capacity)``
    buffers (and ``(W, n_slots)`` counts) in place, so its ring slot can
    be reused.  Returns the three tensors."""
    keys_buf[:, slot] = INVALID
    vals_buf[:, slot] = 0
    counts[:, slot] = 0
    return keys_buf, vals_buf, counts


# ---------------------------------------------------------------------------
# Carry handoff (multi-stage chains + DAG fan-out: one plan's finalized
# windows feed one or more successor plans, one call per edge)
# ---------------------------------------------------------------------------

def carry_handoff_rows(agg: torch.Tensor, relabel: torch.Tensor,
                       last_window: int, n_windows: int, kind: str,
                       n_rows: int, channel_base: int = 0) -> torch.Tensor:
    """One finalized window's dense aggregate → a successor plan's wire
    rows, on the aggregate's device.  Pure per-edge function: a teed stage
    runs it once per out-edge with that edge's own ``relabel`` table.

    ``agg`` is the ``(num_buckets, channels)`` slice of a finalized
    window; its ``[sum, count]`` pair lives at ``channel_base``.  Each
    occupied bucket becomes one device-wire row ``[last_window, n_windows,
    key, value, valid]`` for the next stage's plan: ``relabel`` (int32, on
    the same device) maps this plan's bucket ids to the next key space
    (``< 0`` marks unassigned buckets), ``last_window`` / ``n_windows``
    are the re-windowed span of the window's start (already rebased by the
    caller; every row of one handoff shares them), and the value is the
    finalized aggregate per ``kind`` (count | sum | mean, the mean as the
    float32 quotient ``sum / max(count, 1)``).  The output is padded to
    ``n_rows`` with invalid (all-zero) rows.  Nothing here reads a tensor
    back to the host, so the handoff and the next stage's fold queue on
    one stream without a sync between them."""
    sums = agg[:, channel_base]
    counts = agg[:, channel_base + 1]
    if kind == "count":
        value = counts
    elif kind == "sum":
        value = sums
    elif kind == "mean":
        value = sums / torch.clamp(counts, min=1.0)
    else:
        raise ValueError(f"unknown handoff aggregate kind {kind!r}")
    n = agg.shape[0]
    if relabel.shape[0] != n:
        raise ValueError(f"relabel table has {relabel.shape[0]} entries for "
                         f"{n} buckets")
    if n_rows < n:
        raise ValueError(f"n_rows={n_rows} cannot hold {n} buckets")
    rows = torch.zeros((n_rows, 5), dtype=torch.float32, device=agg.device)
    rows[:n, 0] = float(last_window)
    rows[:n, 1] = float(n_windows)
    rows[:n, 2] = relabel.to(torch.float32)
    rows[:n, 3] = value.to(torch.float32)
    rows[:n, 4] = ((counts > 0) & (relabel >= 0)).to(torch.float32)
    return rows
