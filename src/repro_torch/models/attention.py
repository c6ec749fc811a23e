"""Attention blocks: GQA with RoPE, qk-norm, sliding windows, softcaps.

The partner of ``repro/models/attention.py`` for the dense attention
architectures (gemma2's alternating local/global windows, attention
softcap and sandwich norms; qwen3's per-head-dim RMS qk-norm; stablelm's
partial rotary; yi's plain GQA).

The reference runs its layers under ``lax.scan``, where the window is a
traced scalar, so its model code takes the jnp paths
(``_traced_window_attention``, ``_traced_window_decode``) that compute
what its Pallas kernels compute.  The port loops over layers in Python,
so each layer's window is a plain int (0 = global), and the blocks call
the attention wrappers of ``kernels/flash_attention/ops.py`` directly:
the CUDA kernels for tensors on the card, the plain versions for CPU
tensors.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention.ops import attention, decode_attention
from .config import ModelConfig
from .layers import Params, dense_init, linear, rmsnorm, rope


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """q, k, v and output projections (and the qk-norm weights)."""
    d, hd = cfg.d_model, cfg.head_dim_
    dt = cfg.param_dtype_
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt,
                         scale=(cfg.n_heads * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=gen.device)
    return p


def _rope_part(x: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig):
    """Rotate the first ``rope_pct`` of the head dim (rounded down to even)."""
    hd = x.shape[-1]
    r = int(hd * cfg.rope_pct)
    r -= r % 2
    if r >= hd:
        return rope(x, pos, cfg.rope_theta)
    return torch.cat([rope(x[..., :r], pos, cfg.rope_theta), x[..., r:]],
                     dim=-1)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x (B, S, d) → q (B, Hq, S, hd), k and v (B, Hkv, S, hd), with the
    qk-norm and rotary embeddings applied."""
    b, s, _ = x.shape
    hd = cfg.head_dim_
    cd = cfg.compute_dtype_
    q = linear(p["wq"], x, cd).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x, cd).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x, cd).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if cfg.rope_pct > 0:
        pos = positions[:, None, :]          # (B, 1, S): broadcast over heads
        q = _rope_part(q, pos, cfg)
        k = _rope_part(k, pos, cfg)
    return q, k, v


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 window: int, positions: torch.Tensor | None = None,
                 return_kv: bool = False):
    """Full-sequence causal attention (prefill): x (B, S, d) → y (B, S, d),
    and the (k, v) tensors (B, Hkv, S, hd) for the cache if asked.
    ``window`` is this layer's window (0 = global)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = attention(q, k, v, causal=True, window=window or None,
                  softcap=cfg.attn_softcap, chunk=cfg.attn_chunk)
    y = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim_)
    y = linear(p["wo"], y, cfg.compute_dtype_)
    if return_kv:
        return y, (k, v)
    return y


def cache_write_pos(lengths: torch.Tensor, size: int) -> torch.Tensor:
    """Where a decode step writes each row's new k and v in a cache of
    ``size`` positions: at ``lengths[b]``, clamped to ``size - 1`` as the
    reference's ``dynamic_update_slice`` clamps a position past the end.
    (B,) int64, on the lengths' device."""
    return lengths.long().clamp(0, size - 1)


def write_cache(cache: torch.Tensor, new: torch.Tensor,
                lengths: torch.Tensor) -> None:
    """Write ``new`` (B, Hkv, 1, hd) into ``cache`` (B, Hkv, S, hd) in
    place at ``cache_write_pos(lengths, S)`` of each row.  Stays on the
    device (no host sync)."""
    pos = cache_write_pos(lengths, cache.shape[2])
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos] = new[:, :, 0].to(cache.dtype)


def attn_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                window: int, k_cache: torch.Tensor, v_cache: torch.Tensor,
                lengths: torch.Tensor):
    """One-token decode: x (B, 1, d); caches (B, Hkv, S, hd); lengths (B,).

    Writes the new token's k and v into the caches in place at position
    ``lengths`` (clamped to S - 1) and attends over the first
    ``lengths + 1`` positions (the last ``window`` of them).  Returns
    (y (B, 1, d), k_cache, v_cache) — the same cache tensors."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, lengths[:, None])
    write_cache(k_cache, k, lengths)
    write_cache(v_cache, v, lengths)
    o = decode_attention(q[:, :, 0], k_cache, v_cache, lengths + 1,
                         window=window or None, softcap=cfg.attn_softcap)
    y = o.reshape(b, 1, cfg.n_heads * cfg.head_dim_)
    y = linear(p["wo"], y, cfg.compute_dtype_)
    return y, k_cache, v_cache


def window_schedule(cfg: ModelConfig) -> list[int]:
    """Per-layer window sizes (0 = global attention): gemma2's
    ``alternate`` windows the even layers, ``all`` windows every layer."""
    w = cfg.sliding_window or 0
    if cfg.window_pattern == "all":
        return [w] * cfg.n_layers
    if cfg.window_pattern == "alternate":
        return [w if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    return [0] * cfg.n_layers


__all__ = ["attn_decode", "attn_forward", "attn_init", "cache_write_pos",
           "window_schedule", "write_cache"]
