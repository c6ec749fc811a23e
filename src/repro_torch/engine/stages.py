"""Key hashing, the aggregating shuffle and heavy-hitter selection.

The part of the reference's stage library the ported paths need: host
and device key folding (``fold_key24`` → ``device_hash`` /
``host_bucket``, bit-identical to one another and to the reference); the
batch plans' aggregating shuffle — the Mapper's combiner
(``local_combine_dense``, the ``hash_combine`` kernel) with exact
per-bucket collision accounting for hashed key spaces
(``distinct_keys_per_bucket``); and the fixed-capacity top-k over a
dense aggregate; and the carry handoff (``carry_handoff_rows``), which
turns one finalized window of a stage into the next stage's wire rows on
the device.  The streaming window fan-out and scatter-accumulate live in
the fused fold kernel (``kernels/fused_fold``); the group-mode stages of
the reference are queued in ``ROADMAP.md``.

The reference runs these stages once per worker under ``vmap`` or
``shard_map`` and finishes with a collective.  The port runs them once
over every worker's records on one device: a sum of per-worker sums is
one sum, so the combine plus ``psum_scatter`` is one combine, and the
owner-routed distinct-key exchange is one global ``torch.unique``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels.fused_fold.ref import murmur32
from ..kernels.hash_combine import ops as hash_combine

#: raw hashed-key ids must survive the float32 wire exactly
RAW_KEY_BITS = 24
#: the reference's invalid-key sentinel in its distinct-key exchange
INT32_MAX = 2 ** 31 - 1


def device_hash(keys: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over int32 keys, as int64 values in
    ``[0, 2**32)`` — the bits the reference's uint32 hash gives."""
    return murmur32(keys)


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


def shuffle_aggregate(keys: torch.Tensor, values: torch.Tensor,
                      num_buckets: int, valid: torch.Tensor | None = None,
                      combine_fn=None) -> torch.Tensor:
    """Aggregating shuffle over every worker's records at once: the
    combiner's dense ``(num_buckets, ...)`` sum.  Worker ``w`` of the
    reference owns the contiguous slice ``[w * per, (w + 1) * per)`` of
    it, which is what its ``psum_scatter`` hands out."""
    return resolve_combine_fn(combine_fn)(keys, values, num_buckets, valid)


@dataclass(frozen=True)
class ShuffleStats:
    """Accounting of one batch run, the analogue of the paper's
    bytes_in/bytes_out: ``sent`` valid records, ``dropped`` records (0: the
    aggregating shuffle never drops), and for hashed key spaces with
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


def distinct_keys_per_bucket(raw_keys: torch.Tensor,
                             valid: torch.Tensor | None,
                             num_buckets: int) -> torch.Tensor:
    """Exact global per-bucket distinct-raw-key counts over the valid
    records of every worker, as int32 ``(num_buckets,)``; the reference's
    ``distinct_keys_per_bucket`` computes the same counts with a
    dedupe-and-route exchange that cannot drop.  ``INT32_MAX`` is the
    reference's invalid sentinel, so a raw key of that value is not
    counted there either."""
    raw = raw_keys.to(torch.int32)
    keep = raw != INT32_MAX
    if valid is not None:
        keep = keep & valid.to(torch.bool)
    uniq = torch.unique(raw[keep])
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
