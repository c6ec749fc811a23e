"""Key hashing and heavy-hitter selection for the streaming engine.

The part of the reference's stage library the streaming aggregate path
needs: host and device key folding (``fold_key24`` → ``device_hash`` /
``host_bucket``, bit-identical to one another and to the reference) and
the fixed-capacity top-k over one finalized window's dense aggregate.
The window fan-out and the scatter-accumulate live in the fused fold
kernel (``kernels/fused_fold``); the shuffle, group-mode and handoff
stages of the reference are queued in ``ROADMAP.md``.
"""

from __future__ import annotations

import torch

from ..kernels.fused_fold.ref import murmur32

#: raw hashed-key ids must survive the float32 wire exactly
RAW_KEY_BITS = 24


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
