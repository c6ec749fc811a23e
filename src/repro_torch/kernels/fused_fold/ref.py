"""Plain PyTorch version of the fused streaming fold — the kernel's oracle.

A straight re-statement of what one micro-batch fold computes, with no
attempt at speed: decode the float32 wire rows, hash raw keys into buckets
(murmur3 finalizer, bit-identical to ``engine.stages.device_hash``), fan
each record out to its 1..fanout overlapping window slots, mask and count
the pairs below the watermark bound, and scatter-accumulate ``[value, 1]``
pairs into the flattened ``(n_slots * carry_buckets, channels)`` carry.
The CUDA kernel in ``csrc/fused_fold.cu`` must match it bit for bit on
integer-valued data (float32 sums of integers below 2**24 are exact in any
order, so the kernel's atomics cannot drift from ``index_add_``).

It runs on any device: the CPU tests use it as the fold, and the chip
smoke holds the kernel against it on the card's own tensors.
"""

from __future__ import annotations

import torch

#: streaming wire widths (mirrors engine.plan HOST_FANOUT_ROW / DEVICE_FANOUT_ROW)
HOST_ROW = 4    # [window_slot, key, value, valid]
DEVICE_ROW = 5  # [last_window_index, n_windows, key, value, valid]

#: fold kinds the fused kernel accumulates (count folds as sum-of-ones;
#: mean is emission-side sum/count and needs no kind of its own)
FOLD_KINDS = ("sum", "count", "min", "max")

INT32_MIN = -(2 ** 31)
_MASK32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in ``[0, 2**32)``, split into
    16-bit halves of ``c`` so no int64 product overflows (CPU torch has no
    uint32 shifts, so the hash runs in int64 with explicit masking)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def murmur32(keys: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over int32 keys, as int64 values in ``[0, 2**32)``
    — the bits ``uint32`` arithmetic gives, without uint32 ops."""
    h = keys.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def murmur_bucket(keys: torch.Tensor, num_buckets: int,
                  hashed: bool) -> torch.Tensor:
    """Wire keys → int32 bucket ids.  The float→int cast truncates toward
    zero, as the reference's ``astype(int32)`` and C's ``(int)`` do."""
    keys = keys.to(torch.int32)
    if not hashed:
        return keys
    return (murmur32(keys) % num_buckets).to(torch.int32)


def _decode(rows, min_window, *, fanout, n_slots, num_buckets,
            carry_buckets, hashed, host_wire):
    """Wire rows → flattened (flat id, value, live) pairs + late count.

    Device wire: copy j of a record covers window ``last - j``, is live
    when ``j < n_windows`` and the window is still admissible
    (``>= min_window``); late pairs are counted, not folded.  Ring slots
    are ``w mod n_slots`` as a *floor* mod (``torch.remainder``): sliding
    windows near the start of a stream have negative indices, and a
    truncating mod would send them outside the carry.  Host wire: the host
    already expanded records (fan-out 1), so ``live == valid``.
    """
    if host_wire:
        slots = rows[:, 0].to(torch.int32)[:, None]
        bucket = murmur_bucket(rows[:, 1], num_buckets, hashed)[:, None]
        vals = rows[:, 2][:, None]
        live = (rows[:, 3] > 0)[:, None]
        late = torch.zeros((), dtype=torch.int32, device=rows.device)
    else:
        last = rows[:, 0].to(torch.int32)
        n_windows = rows[:, 1].to(torch.int32)
        bucket = murmur_bucket(rows[:, 2], num_buckets, hashed)[:, None]
        vals = rows[:, 3][:, None]
        valid = rows[:, 4] > 0
        j = torch.arange(fanout, dtype=torch.int32, device=rows.device)
        widx = last[:, None] - j[None, :]
        covers = valid[:, None] & (j[None, :] < n_windows[:, None])
        live = covers & (widx >= min_window)
        late = (covers & (widx < min_window)).sum(dtype=torch.int32)
        slots = torch.remainder(widx, n_slots)
    flat = slots.to(torch.int64) * carry_buckets + bucket.to(torch.int64)
    return flat, vals.expand(flat.shape), live, late


def fused_streaming_fold_ref(rows, carry, min_window=None, *, fanout,
                             n_slots, num_buckets, carry_buckets,
                             channel_base=0, hashed=False, host_wire=False,
                             kind="sum"):
    """Oracle fold: ``(carry', stats)`` with stats int32 ``[late, folded,
    0]``.  Functional: ``carry`` is not modified.

    ``carry`` is the flattened ``(n_slots * carry_buckets, channels)``
    slab.  ``sum``/``count`` accumulate into channels ``[channel_base,
    channel_base + 1]`` (value-or-one, one); ``min``/``max`` keep the
    running extremum in the value channel (an empty cell stays 0 — the
    count channel says whether the extremum is populated) and the count in
    the next.  Pairs whose flat id falls outside the carry are dropped, as
    the reference's ``segment_sum`` drops out-of-range ids.
    """
    if kind not in FOLD_KINDS:
        raise ValueError(f"unknown fold kind {kind!r}")
    if min_window is None:
        min_window = INT32_MIN
    flat, vals, live, late = _decode(
        rows, int(min_window), fanout=fanout, n_slots=n_slots,
        num_buckets=num_buckets, carry_buckets=carry_buckets, hashed=hashed,
        host_wire=host_wire)
    size = carry.shape[0]
    # dead and out-of-range pairs park on an overflow row past the carry
    keep = live & (flat >= 0) & (flat < size)
    seg = torch.where(keep, flat, size).reshape(-1)
    vals = vals.reshape(-1)
    ones = keep.to(carry.dtype).reshape(-1)
    folded = live.sum(dtype=torch.int32)
    new = carry.clone()
    b0, b1 = channel_base, channel_base + 1

    if kind in ("sum", "count"):
        v = ones if kind == "count" else torch.where(keep.reshape(-1), vals,
                                                     0.0)
        sums = torch.zeros(size + 1, dtype=carry.dtype, device=carry.device)
        cnts = torch.zeros_like(sums)
        sums.index_add_(0, seg, v)
        cnts.index_add_(0, seg, ones)
        new[:, b0] = carry[:, b0] + sums[:size]
        new[:, b1] = carry[:, b1] + cnts[:size]
    else:
        neutral = float("inf") if kind == "min" else float("-inf")
        masked = torch.where(keep.reshape(-1), vals, neutral)
        ext = torch.full((size + 1,), neutral, dtype=carry.dtype,
                         device=carry.device)
        ext.scatter_reduce_(0, seg, masked,
                            reduce="amin" if kind == "min" else "amax")
        cnts = torch.zeros(size + 1, dtype=carry.dtype, device=carry.device)
        cnts.index_add_(0, seg, ones)
        old_v, old_c = carry[:, b0], carry[:, b1]
        eff = torch.where(old_c > 0, old_v, neutral)
        comb = torch.minimum(eff, ext[:size]) if kind == "min" \
            else torch.maximum(eff, ext[:size])
        new_c = old_c + cnts[:size]
        new[:, b0] = torch.where(new_c > 0, comb, 0.0)
        new[:, b1] = new_c
    zero = torch.zeros((), dtype=torch.int32, device=carry.device)
    return new, torch.stack([late.to(carry.device), folded, zero])
