"""Primitive layers — functional style: explicit parameter dicts, pure applies.

The partner of ``repro/models/layers.py``, with its numerics:

* weights are stored in ``param_dtype``; matmuls take their inputs in
  ``compute_dtype`` and accumulate in float32 (torch's bfloat16 matmul on
  CUDA does), and the result is cast back to ``compute_dtype``;
* norms, softmax and rope run in float32;
* linear weights are ``(d_in, d_out)``.

Init helpers draw from an explicit ``torch.Generator`` on the device the
parameters are made on.  They do not give the reference's numbers for a
seed (``jax.random`` and torch draw differently): the tests hand the
reference's parameters over through ``models.convert``.  The reference's
``matmul_reduce_dtype`` (a tensor-parallel partial-sum knob) is not
ported.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


# -- init ---------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None) -> torch.Tensor:
    """A (d_in, d_out) weight ~ N(0, scale^2), scale = d_in^-0.5 by
    default, drawn in float32 on the generator's device."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w.mul_(scale)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    """A (vocab, d) embedding table ~ N(0, 0.02^2)."""
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w.mul_(0.02)).to(dtype)


# -- linear / embedding -------------------------------------------------------

def linear(w: torch.Tensor, x: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in ``compute_dtype`` with float32
    accumulation, cast back to ``compute_dtype``."""
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype)) \
        .to(compute_dtype)


def embed(table: torch.Tensor, ids: torch.Tensor, scale: float | None = None,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of ``table`` for ``ids``, times ``scale`` rounded to
    ``compute_dtype`` first (as the reference multiplies)."""
    x = table[ids.long()].to(compute_dtype)
    if scale is not None:
        x = x * torch.tensor(scale, dtype=compute_dtype, device=x.device)
    return x


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, *, tied: bool,
            softcap: float | None = None) -> torch.Tensor:
    """Vocab logits in float32: ``x`` against the embedding table
    transposed (``tied``) or a (d, vocab) head, both cast to float32, then
    the final softcap.  The float32 copy of the table is made per call,
    as the reference computes it."""
    xf = x.float()
    w = table_or_head.float()
    logits = xf @ (w.T if tied else w)
    if softcap is not None and softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


# -- norms ---------------------------------------------------------------------

def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
            weight_offset: float = 0.0) -> torch.Tensor:
    """RMSNorm in float32; ``weight_offset=1.0`` is Gemma's (1 + w)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (w.float() + weight_offset)).to(x.dtype)


def layernorm(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (population variance)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * w.float() + b.float()).to(x.dtype)


# -- rotary embeddings -----------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embeddings, split-halves convention.

    x: (..., S, D) with D even; positions: broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- activations / MLPs -----------------------------------------------------------

def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def glu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                 dtype=torch.float32) -> Params:
    """Gate, up and down projections of a gated MLP."""
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5),
    }


def glu_mlp(p: Params, x: torch.Tensor, activation: str = "silu",
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Gated-linear-unit MLP (SwiGLU / GeGLU per ``activation``)."""
    g = _act(activation, linear(p["w_gate"], x, compute_dtype))
    u = linear(p["w_up"], x, compute_dtype)
    return linear(p["w_down"], g * u, compute_dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap·tanh(x/cap), or x when ``cap`` is None or not positive."""
    if cap is None or cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


__all__ = ["Params", "dense_init", "embed", "embed_init", "glu_mlp",
           "glu_mlp_init", "layernorm", "linear", "rmsnorm", "rope",
           "softcap", "unembed"]
