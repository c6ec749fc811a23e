"""Mixture-of-Experts with MapReduce-shuffle dispatch.

The partner of ``repro/models/moe.py``, function by function.  The
paper's shuffle is ``hash(key) % R`` → pack records into per-reducer
spill buffers → exchange → merge; MoE dispatch is the same pipeline with
``route(token) → expert`` as the partition function: the (token, choice)
pairs are sorted by expert id (a stable sort, so within an expert the
earlier token comes first and the later ones are dropped first), packed
into fixed-capacity per-expert buffers with a dump slot for what
overflows, run through batched expert GEMMs, and combined back with the
gate weights (the weighted 'reduce').  Aux losses: Switch load balance
on the top-1 expert plus the router z-loss.

Numerics as the reference's: the router runs in float32; the gate and up
products in the compute dtype; the down product is kept in float32
(``preferred_element_type=jnp.float32`` there, ``torch.bmm(...,
out_dtype=torch.float32)`` for bfloat16 on the card) until the weighted
combine, and the layer's output is cast to the compute dtype last.  The
top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
does (``torch.topk`` does not promise an order; a stable descending sort
does), which decides who is dropped when a zero router ties every token.

The combine gathers each token's k rows back and sums them in ascending
expert order — the order the reference's ``segment_sum`` meets them in
buffer order — rather than scattering with ``index_add_``, whose float32
atomics sum in another order on every call: two identical calls on the
card give the same bits.  The expert products are library GEMMs, as the
reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import Params, _act, dense_init, linear
from .shardctx import dp_shards


def _stacked(w: torch.Tensor, rows: int, e: int, cols: int) -> torch.Tensor:
    """A (rows, E·cols) draw as the (E, rows, cols) expert stack."""
    return w.reshape(rows, e, cols).transpose(0, 1).contiguous()


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Router (float32), stacked expert weights (E, d, f) / (E, f, d), and
    the shared expert with its float32 sigmoid gate when
    ``n_shared_experts > 0`` — the reference's shapes and scales."""
    d, dt = cfg.d_model, cfg.param_dtype_
    e, f = cfg.n_experts, cfg.expert_d_ff
    p: Params = {
        "router": dense_init(gen, d, e, torch.float32, scale=d ** -0.5),
        "w_gate": _stacked(dense_init(gen, d, e * f, dt), d, e, f),
        "w_up": _stacked(dense_init(gen, d, e * f, dt), d, e, f),
        "w_down": _stacked(dense_init(gen, f, e * d, dt, scale=f ** -0.5),
                           f, e, d),
    }
    if cfg.n_shared_experts > 0:
        sf = cfg.shared_expert_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, d, sf, dt),
            "w_up": dense_init(gen, d, sf, dt),
            "w_down": dense_init(gen, sf, d, dt, scale=sf ** -0.5),
        }
        p["shared_gate"] = dense_init(gen, d, 1, torch.float32)
    return p


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig):
    """Router logits → (weights (T, k) float32, experts (T, k) int64, aux
    loss)."""
    logits = x_flat.float() @ router_w                     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top.values[:, :cfg.top_k]
    experts = top.indices[:, :cfg.top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    # Switch load-balance loss: E · Σ_e f_e · P_e over the top-1 expert
    f_e = F.one_hot(experts[:, 0], cfg.n_experts).float().mean(dim=0)
    p_e = probs.mean(dim=0)
    aux = cfg.n_experts * (f_e * p_e).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return weights, experts, cfg.router_aux_weight * aux + \
        cfg.router_z_weight * z


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert buffer size — the 'spill file' bound, rounded up to a
    multiple of 8 and at least 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class Dispatch(NamedTuple):
    """The packed spill buffers of ``ns`` token shards: ``xb`` (ns, E,
    cap, d) the routed rows (zero where invalid); ``buf_tok``,
    ``buf_valid``, ``buf_w`` (ns, E·cap) each buffer row's shard-local
    token, whether it holds one, and its gate weight; ``pair_slot`` (ns,
    t, k) the buffer row of each (token, choice) pair, E·cap where the
    pair was dropped."""

    xb: torch.Tensor
    buf_tok: torch.Tensor
    buf_valid: torch.Tensor
    buf_w: torch.Tensor
    pair_slot: torch.Tensor


def _dispatch(x_flat: torch.Tensor, weights: torch.Tensor,
              experts: torch.Tensor, e: int, cap: int) -> Dispatch:
    """The reference's ``_pack_one_shard``, batched over the leading
    shard axis: x_flat (ns, t, d), weights and experts (ns, t, k).  A
    stable sort of the flat (t·k) expert ids, position in group = index
    minus the group's offset, pairs past ``cap`` to the dump slot E·cap
    (sliced off).  Each kept row is written once, so the buffers are the
    same on every device and every call."""
    ns, t, d = x_flat.shape
    k = weights.shape[-1]
    dev = x_flat.device
    flat_expert = experts.reshape(ns, t * k)               # the partition key
    se, order = torch.sort(flat_expert, dim=-1, stable=True)
    st = torch.div(order, k, rounding_mode="floor")        # token of a pair
    sw = weights.reshape(ns, t * k).gather(1, order)
    offsets = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(ns, e).contiguous())
    pos = torch.arange(t * k, device=dev) - offsets.gather(1, se)
    in_cap = pos < cap                                     # overflow → dropped
    slot = torch.where(in_cap, se * cap + pos, e * cap)
    size = e * cap + 1
    buf_tok = torch.zeros((ns, size), dtype=torch.int64, device=dev) \
        .scatter_(1, slot, torch.where(in_cap, st, 0))[:, :-1]
    buf_valid = torch.zeros((ns, size), dtype=torch.bool, device=dev) \
        .scatter_(1, slot, in_cap)[:, :-1]
    buf_w = torch.zeros((ns, size), dtype=torch.float32, device=dev) \
        .scatter_(1, slot, torch.where(in_cap, sw, 0.0))[:, :-1]
    pair_slot = torch.empty_like(slot).scatter_(1, order, slot)
    xb = x_flat[torch.arange(ns, device=dev)[:, None], buf_tok]
    xb.masked_fill_(~buf_valid[..., None], 0)
    return Dispatch(xb.view(ns, e, cap, d), buf_tok, buf_valid, buf_w,
                    pair_slot.view(ns, t, k))


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, with a float32 result (float32 accumulation); the
    CPU has no ``out_dtype`` kernel, so there the inputs are upcast."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _experts(p: Params, xb: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The per-expert GEMMs: xb (E, C, d) → (E, C, d) float32."""
    cd = cfg.compute_dtype_
    xb = xb.to(cd)
    g = torch.bmm(xb, p["w_gate"].to(cd))
    u = torch.bmm(xb, p["w_up"].to(cd))
    return _bmm_f32(_act(cfg.activation, g) * u, p["w_down"].to(cd))


def _combine(yb: torch.Tensor, disp: Dispatch) -> torch.Tensor:
    """The weighted reduce back to tokens: yb (ns, E·cap, d) float32 →
    (ns·t, d) float32, each token's kept rows times their gate weights,
    summed in ascending expert order (its dropped pairs add nothing)."""
    ns, t, k = disp.pair_slot.shape
    rows = yb.shape[1]
    slots = disp.pair_slot.sort(dim=-1).values       # expert order, dump last
    kept = slots < rows
    idx = slots.clamp(max=rows - 1)
    shard = torch.arange(ns, device=yb.device)[:, None, None]
    parts = yb[shard, idx] * disp.buf_w[shard, idx][..., None]
    parts.masked_fill_(~kept[..., None], 0)               # (ns, t, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y.reshape(ns * t, -1)


def _shared_expert(p: Params, x_flat: torch.Tensor, cfg: ModelConfig):
    """The shared expert behind its float32 sigmoid gate: (T, d) float32."""
    cd, sp = cfg.compute_dtype_, p["shared"]
    sg = _act(cfg.activation, linear(sp["w_gate"], x_flat, cd))
    su = linear(sp["w_up"], x_flat, cd)
    sy = linear(sp["w_down"], sg * su, cd).float()
    gate = torch.sigmoid(x_flat.float() @ p["shared_gate"])
    return gate * sy


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y (B, S, d) in the compute dtype, aux loss).

    The dispatch runs per data shard (``dp_shards()``; 1 outside an
    ``activation_sharding`` context, and 1 when B·S does not divide):
    the tokens form that many contiguous shards, each packs its own
    (E, cap, d) buffers with cap from its own token count, and the
    expert GEMMs see the concatenated (E, ns·cap, d) buffers."""
    b, s, d = x.shape
    t, e = b * s, cfg.n_experts
    x_flat = x.reshape(t, d)
    ns = dp_shards()
    if t % ns:
        ns = 1
    t_loc = t // ns
    cap = expert_capacity(cfg, t_loc)

    weights, experts, aux = _route(p["router"], x_flat, cfg)
    disp = _dispatch(x_flat.reshape(ns, t_loc, d),
                     weights.reshape(ns, t_loc, cfg.top_k),
                     experts.reshape(ns, t_loc, cfg.top_k), e, cap)
    # (ns, E, cap, d) → (E, ns·cap, d): capacity rows still owned by shard
    xb = disp.xb.transpose(0, 1).reshape(e, ns * cap, d)
    yb = _experts(p, xb, cfg)
    yb = yb.view(e, ns, cap, d).transpose(0, 1).reshape(ns, e * cap, d)
    y = _combine(yb, disp)
    if cfg.n_shared_experts > 0:
        y = y + _shared_expert(p, x_flat, cfg)
    return y.reshape(b, s, d).to(cfg.compute_dtype_), aux


__all__ = ["Dispatch", "expert_capacity", "moe_forward", "moe_init"]
