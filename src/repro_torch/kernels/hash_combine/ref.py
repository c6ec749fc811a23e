"""Plain PyTorch version of the hash_combine kernel — the oracle the CUDA
kernel is held against on the card, and the CPU path of the wrapper."""

from __future__ import annotations

import torch


def hash_combine_ref(keys: torch.Tensor, values: torch.Tensor,
                     num_buckets: int,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Dense bucket accumulation: ``out[b] = sum(values[keys == b])``.

    keys   : (N,) integer; a key outside ``[0, num_buckets)`` matches no
             bucket and is dropped, as ``jax.ops.segment_sum`` drops it
    values : (N,) or (N, D)
    valid  : (N,) bool, optional — invalid rows are skipped, not
             multiplied by zero, so a NaN in one never reaches the sum
    returns: (num_buckets,) or (num_buckets, D) in the values' dtype,
             accumulated in float32 for 16-bit floats (rounded once)
    """
    keys = keys.to(torch.int64)
    keep = (keys >= 0) & (keys < num_buckets)
    if valid is not None:
        keep = keep & valid.to(torch.bool)
    acc_dtype = (torch.float32 if values.dtype in (torch.float16,
                                                   torch.bfloat16)
                 else values.dtype)
    out = torch.zeros((num_buckets,) + tuple(values.shape[1:]),
                      dtype=acc_dtype, device=values.device)
    out.index_add_(0, keys[keep], values[keep].to(acc_dtype))
    return out.to(values.dtype)
