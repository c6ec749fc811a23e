"""Plain PyTorch versions of flash attention (forward and decode).

The partners of ``repro/kernels/flash_attention/ref.py`` (``mha_ref``,
``decode_ref``, ``_mask``) and of ``chunked_attention`` in
``repro/kernels/flash_attention/ops.py``.  They are the oracles the CUDA
kernels are held against on the card, and the CPU path of the wrappers in
``ops.py``.  All take the JAX package's layouts — q ``(B, Hq, Sq, D)``,
k and v ``(B, Hkv, Skv, D)``, decode q ``(B, Hq, D)`` against caches
``(B, Hkv, S, D)`` — and compute the softmax in float32.

``mha_ref`` materialises the whole (Sq x Skv) score matrix, so it is for
small shapes; ``chunked_attention`` walks KV chunks with an online softmax
and never holds more than (Sq x chunk) scores, which is what the plain
forward path uses at any size.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(sq: int, skv: int, causal: bool, window: int | None,
          q_offset: int, device=None) -> torch.Tensor:
    """(sq, skv) boolean mask.  ``q_offset`` places query row 0 at absolute
    position ``q_offset``."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    k_pos = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= q_pos >= k_pos
    if window is not None and window > 0:
        m &= q_pos - k_pos < window
    return m


def _softcap(s: torch.Tensor, softcap: float | None) -> torch.Tensor:
    if softcap is not None and softcap > 0:
        return softcap * torch.tanh(s / softcap)
    return s


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int | None = None,
            softcap: float | None = None, scale: float | None = None,
            q_offset: int = 0) -> torch.Tensor:
    """Grouped-query attention over the full score matrix.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0.  Returns
    (B, Hq, Sq, D) in q's dtype; a row with no live key is 0."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = _softcap(torch.einsum("bhqd,bhkd->bhqk", qf, kf), softcap)
    m = _mask(sq, skv, causal, window, q_offset, q.device)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(dim=-1)[:, None], p, torch.zeros_like(p))
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               lengths: torch.Tensor, *, window: int | None = None,
               softcap: float | None = None,
               scale: float | None = None) -> torch.Tensor:
    """One query token per row against a KV cache.

    q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,) — row b attends to
    cache positions [0, lengths[b]), and with a window only to the last
    ``window`` of them.  The GQA group rides its own axis, so the cache is
    contracted without repeating it.  Returns (B, Hq, D)."""
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = (q.float() * scale).reshape(b, hkv, group, d)
    s = _softcap(torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()),
                 softcap)
    k_pos = torch.arange(s_max, device=q.device)[None, None, None, :]
    lens = lengths.to(q.device)[:, None, None, None]
    valid = k_pos < lens
    if window is not None and window > 0:
        valid &= k_pos >= lens - window
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, d).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      softcap: float | None = None,
                      scale: float | None = None, chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` keys: the same
    function as ``mha_ref`` with (Sq x chunk) scores live at a time.  GQA
    by repeating each chunk's kv heads."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    chunk = max(1, min(chunk, skv))
    qf = q.float() * scale
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, hq, sq), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, skv, chunk):
        kc = k[:, :, start:start + chunk].float()
        vc = v[:, :, start:start + chunk].float()
        kc = kc.repeat_interleave(group, dim=1)
        vc = vc.repeat_interleave(group, dim=1)
        s = _softcap(torch.einsum("bhqd,bhkd->bhqk", qf, kc), softcap)
        k_pos = torch.arange(start, start + kc.shape[2],
                             device=q.device)[None, :]
        mask = torch.ones((sq, kc.shape[2]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None and window > 0:
            mask &= q_pos - k_pos < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        lsum = lsum * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vc)
        m = m_new
    denom = torch.where(lsum > 0, lsum, torch.ones_like(lsum))
    return (acc / denom[..., None]).to(q.dtype)


__all__ = ["NEG_INF", "chunked_attention", "decode_ref", "mha_ref"]
