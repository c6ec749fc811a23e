"""Gradient compression — smaller 'spill files' for the gradient shuffle.

The partner of ``repro/optim/compression.py``: int8 quantization with a
per-tensor scale, error feedback for host-side paths, and
``compressed_psum``, the int8 all-reduce of a gradient tree over a worker
axis.  The axis is ``engine.compile.DistributedAxis`` (one
``torch.distributed`` rank a worker: NCCL for CUDA tensors, gloo for the
CPU's): the shared scale is an ``all_reduce`` of the maximum, the int32
sums an ``all_reduce`` of the sum — exact, no overflow for up to 2^23
workers — and the mean follows.  Rounding is half to even in both
packages (``torch.round``, ``jnp.round``).
"""

from __future__ import annotations

from typing import Any

import torch

from .tree import tree_leaves, tree_map, tree_unflatten


def _scale(gf: torch.Tensor) -> torch.Tensor:
    return torch.clamp(gf.abs().max(), min=1e-12) / 127.0


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (int8 values, float32 scale).  Symmetric per-tensor
    quantization."""
    xf = x.float()
    scale = _scale(xf)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """``q · scale`` in ``dtype``."""
    return (q.float() * scale).to(dtype)


def compressed_psum(grads: Any, axis) -> Any:
    """All-reduce a gradient tree in int8 over a worker axis and average.

    Per leaf: share one scale (the maximum over workers), quantize, sum
    the int32 values over the workers, dequantize, divide by the
    workers."""
    n = axis.size

    def leaf(g):
        gf = g.float()
        scale = axis.pmax(_scale(gf))
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
        s = axis.psum(q)
        return (s.float() * scale / n).to(g.dtype)

    return tree_map(leaf, grads)


def ef_compress_update(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Error-feedback step for host-side compression paths: quantize
    (grad + residual), return (quantized-dequantized grads, new
    residual)."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    new_g, new_r = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
        gf = g.float() + r
        q, scale = compress_int8(gf)
        deq = decompress_int8(q, scale)
        new_g.append(deq.to(g.dtype))
        new_r.append(gf - deq)
    return tree_unflatten(grads, new_g), tree_unflatten(grads, new_r)


__all__ = ["compress_int8", "compressed_psum", "decompress_int8",
           "ef_compress_update"]
