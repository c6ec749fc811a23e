"""Mamba blocks: Mamba-1 (falcon-mamba) and Mamba-2 / SSD (zamba2).

The partner of ``repro/models/mamba.py``: ``mamba1_init``,
``_causal_conv``, ``mamba1_forward``, ``mamba1_init_cache`` and
``mamba1_decode``; ``mamba2_init``, ``_ssd_chunked``, ``mamba2_forward``,
``mamba2_init_cache`` and ``mamba2_decode``, with the reference's
numerics — projections in ``compute_dtype``; the softplus'd step, ``A``,
the scan and the SSD in float32; ``dt_bias``, ``A_log`` and ``D`` kept in
float32 whatever ``param_dtype`` is (shape ``(di,)`` for Mamba-1, one a
head, ``(nh,)``, for Mamba-2).

The reference's model calls its Mamba-1 scan with ``use_pallas=False``,
so it runs the ``lax.scan`` oracle and never its Pallas kernel.  The port
calls the scan wrapper of ``kernels/mamba_scan/ops.py`` directly: the
CUDA kernel for tensors on the card, the plain version for CPU tensors.
Decode is the reference's one-token recurrence (``ops.decode_step``),
plain tensor operations on either device.

Mamba-2 computes its scan in the chunked SSD form (Mamba-2, arXiv
2405.21060, section 6) outside any kernel in the reference (``jnp.einsum``
and ``lax.scan``), so the port computes it with PyTorch tensor operations
in float32 on either device: each of the reference's three- and
four-operand einsums is written as explicit products and batched
matmuls (``_ssd_intra``, ``_ssd_chunk_states``, ``_ssd_off_diag``), and
the recurrence between chunks is one product with an (nc+1) x (nc+1)
decay matrix (``_ssd_recurrence``) where the reference scans the chunks
one by one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import ops as scan_ops
from .config import ModelConfig
from .layers import Params, dense_init, linear, rmsnorm


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def mamba1_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One Mamba-1 mixer's parameters: in/out projections, the depthwise
    causal conv, the low-rank Δ projection and its bias, A (as ``A_log``,
    the S4D-real init A = -(1..N)) and the skip D."""
    d, di, n = cfg.d_model, cfg.d_inner_, cfg.ssm_state
    dt_rank = _dt_rank(cfg)
    dt_ = cfg.param_dtype_
    dev = gen.device
    in_proj = dense_init(gen, d, 2 * di, dt_)
    conv_w = torch.randn((cfg.conv_kernel, di), generator=gen, device=dev,
                         dtype=torch.float32)
    conv_w = conv_w.mul_((cfg.conv_kernel * di) ** -0.5).to(dt_)
    x_proj = dense_init(gen, di, dt_rank + 2 * n, dt_)
    dt_proj = dense_init(gen, dt_rank, di, dt_)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((di,), generator=gen, device=dev,
                              dtype=torch.float32) * (hi - lo) + lo)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dt_, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dt_, scale=di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x: (B, L, D); w: (K, D); state: (B, K-1,
    D) carries the last K-1 inputs for decode.  Returns (y, new_state),
    the new state a tensor of its own (not a view of the padded input)."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                     # (B, K-1+L, D)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):, :].clone() if k > 1 else state
    return y + b[None, None], new_state


def _ssm_inputs(p: Params, xi: torch.Tensor, cfg: ModelConfig):
    """The scan's Δ (float32), A, B and C from the conv's activated
    output: B and C are column slices of the x_proj output, not copies."""
    cd = cfg.compute_dtype_
    n, dt_rank = cfg.ssm_state, _dt_rank(cfg)
    dbc = linear(p["x_proj"], xi, cd)
    dt, b, c = torch.split(dbc, [dt_rank, n, n], dim=-1)
    delta = F.softplus(linear(p["dt_proj"], dt, cd).float()
                       + p["dt_bias"][None, None])
    return delta, -torch.exp(p["A_log"]), b, c


def mamba1_forward(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, L, d) → (y (B, L, d), the state after the sequence: {"conv":
    (B, K-1, di), "ssm": (B, di, N) float32}) — the reference's
    ``return_state=True``; the scan computes the state either way."""
    cd = cfg.compute_dtype_
    di = cfg.d_inner_
    xz = linear(p["in_proj"], x, cd)
    xi_raw, z = torch.split(xz, di, dim=-1)               # (B, L, di) x2
    xi, conv_state = _causal_conv(xi_raw, p["conv_w"].to(cd),
                                  p["conv_b"].to(cd))
    xi = F.silu(xi)
    delta, a, b, c = _ssm_inputs(p, xi, cfg)
    y, h_final = scan_ops.scan(xi.float(), delta, a, b.float(), c.float(),
                               p["D"])
    y = y.to(cd) * F.silu(z)
    return linear(p["out_proj"], y, cd), {"conv": conv_state,
                                          "ssm": h_final}


def mamba1_init_cache(cfg: ModelConfig, batch: int, *,
                      device) -> dict[str, torch.Tensor]:
    """One layer's zeroed decode state: conv (B, K-1, di) in the compute
    dtype, ssm (B, di, N) float32."""
    di, n = cfg.d_inner_, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di),
                            dtype=cfg.compute_dtype_, device=device),
        "ssm": torch.zeros((batch, di, n), dtype=torch.float32,
                           device=device),
    }


def mamba1_decode(p: Params, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig):
    """x: (B, 1, d) one token; cache: {conv (B, K-1, di), ssm (B, di, N)}.
    Returns (y (B, 1, d), the new {conv, ssm})."""
    cd = cfg.compute_dtype_
    di = cfg.d_inner_
    xz = linear(p["in_proj"], x, cd)
    xi, z = torch.split(xz, di, dim=-1)
    xi, conv_state = _causal_conv(xi, p["conv_w"].to(cd), p["conv_b"].to(cd),
                                  cache["conv"])
    xi = F.silu(xi)
    delta, a, b, c = _ssm_inputs(p, xi, cfg)
    y_t, h = scan_ops.decode_step(cache["ssm"], xi[:, 0].float(),
                                  delta[:, 0], a, b[:, 0].float(),
                                  c[:, 0].float(), p["D"])
    y = y_t[:, None].to(cd) * F.silu(z)
    return linear(p["out_proj"], y, cd), {"conv": conv_state, "ssm": h}


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (zamba2)
# ---------------------------------------------------------------------------

def _mamba2_heads(cfg: ModelConfig) -> int:
    return cfg.d_inner_ // cfg.mamba_head_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """One Mamba-2 mixer's parameters: ``in_proj`` emitting [x (di), z
    (di), B (n), C (n), dt (nh)], the depthwise conv over [x, B, C], A (as
    ``A_log``, A = -(1..nh)), the skip D and ``dt_bias`` a head (float32),
    the gated norm's weight and ``out_proj``."""
    d, di, n = cfg.d_model, cfg.d_inner_, cfg.ssm_state
    nh = _mamba2_heads(cfg)
    dt_ = cfg.param_dtype_
    dev = gen.device
    in_proj = dense_init(gen, d, 2 * di + 2 * n + nh, dt_)
    conv_w = torch.randn((cfg.conv_kernel, di + 2 * n), generator=gen,
                         device=dev, dtype=torch.float32)
    conv_w = conv_w.mul_((cfg.conv_kernel * di) ** -0.5).to(dt_)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di + 2 * n,), dtype=dt_, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dt_, device=dev),
        "out_proj": dense_init(gen, di, d, dt_, scale=di ** -0.5),
    }


def _ssd_intra(x, dt, dA_cum, B, C):
    """The diagonal blocks: each chunk's outputs from its own inputs.

    x (b, nc, c, h, p), dt and dA_cum (b, nc, c, h), B and C (b, nc, c, n)
    → y_diag (b, nc, c, h, p): y[i] = Σ_{j <= i} (C_i·B_j)
    exp(dA_cum[i] - dA_cum[j]) dt_j x_j — the reference's
    ``"bzij,bzijh,bzjh,bzjhp->bzihp"``.  The segment sums above the
    diagonal (j > i) are positive and grow with |A| Σ dt (past ~88 their
    exp overflows float32 to inf, which the reference forms and then
    masks): they are set to -inf before the exp, so the masked entries
    are exactly 0 and no inf is formed; the others are unchanged."""
    c = x.shape[2]
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,i,j,h)
    above = torch.ones((c, c), dtype=torch.bool,
                       device=x.device).triu(1)[:, :, None]
    decay = torch.exp(seg.masked_fill_(above, float("-inf")))
    scores = C @ B.transpose(-1, -2)                         # (b, nc, i, j)
    # (b, nc, h, i, j) weights, then over j: (b,nc,h,i,j) @ (b,nc,h,j,p)
    w = (decay * scores[..., None] * dt[:, :, None, :, :]).permute(
        0, 1, 4, 2, 3)
    return (w @ x.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)


def _ssd_chunk_states(x, dt, dA_cum, B):
    """Each chunk's final state from its own inputs, the state entering
    it taken as zero: S_z = Σ_j exp(dA_cum[last] - dA_cum[j]) dt_j B_j ⊗
    x_j — the reference's ``"bzjh,bzjh,bzjn,bzjhp->bzhnp"``.  x (b, nc,
    c, h, p), dt and dA_cum (b, nc, c, h), B (b, nc, c, n) → (b, nc, h,
    n, p)."""
    b, nc, c, h, p = x.shape
    w = torch.exp(dA_cum[:, :, -1:, :] - dA_cum) * dt        # (b, nc, c, h)
    xw = (x * w[..., None]).reshape(b, nc, c, h * p)
    s = B.transpose(-1, -2) @ xw                           # (b, nc, n, h*p)
    return s.reshape(b, nc, -1, h, p).permute(0, 1, 3, 2, 4)


def _ssd_recurrence(states, chunk_log_decay):
    """The recurrence between chunks, s_z = exp(a_{z-1}) s_{z-1} +
    S_{z-1} from s_0 = 0 (the reference's ``lax.scan``), in closed form:
    s_z = Σ_{y < z} exp(a_{y+1} + ... + a_{z-1}) S_y, one batched matmul
    with an (nc+1) x (nc+1) lower-triangular decay matrix whose row nc is
    the state after the last chunk.  The exponents are sums of runs of
    a (cumulative sums of a masked copy, never differences of large
    cumulative sums), -inf above the diagonal.  states (b, nc, h, n, p),
    chunk_log_decay a = dA_cum[:, :, -1] (b, nc, h) → (the state entering
    each chunk (b, nc, h, n, p), the final state (b, h, n, p))."""
    b, nc, h, n, p = states.shape
    m = nc + 1
    a = F.pad(chunk_log_decay, (0, 0, 1, 0)).transpose(1, 2)  # (b, h, m)
    lower = torch.ones((m, m), dtype=torch.bool,
                       device=states.device).tril()          # y <= z
    # seg[z, y] = a_pad[y+1] + ... + a_pad[z], the cumulative sum over z
    # of a_pad[z] kept where y < z
    run = a[..., None].expand(b, h, m, m).masked_fill(~lower.tril(-1), 0.0)
    seg = run.cumsum(dim=-2).masked_fill_(~lower, float("-inf"))
    # (b, h, z, y) @ (b, h, y, n*p) over [0, S_0, ..., S_{nc-1}]
    s = F.pad(states, (0, 0, 0, 0, 0, 0, 1, 0)).permute(0, 2, 1, 3, 4)
    out = torch.exp(seg) @ s.reshape(b, h, m, n * p)
    out = out.reshape(b, h, m, n, p).permute(0, 2, 1, 3, 4)
    return out[:, :nc], out[:, nc]


def _ssd_off_diag(C, dA_cum, states_in):
    """The carried state's contribution within each chunk: y_off[i] =
    exp(dA_cum[i]) C_i · s_z — the reference's
    ``"bzin,bzih,bzhnp->bzihp"``.  C (b, nc, c, n), dA_cum (b, nc, c, h),
    states_in (b, nc, h, n, p) → (b, nc, c, h, p)."""
    b, nc, c, n = C.shape
    h, p = states_in.shape[2], states_in.shape[4]
    s = states_in.permute(0, 1, 3, 2, 4).reshape(b, nc, n, h * p)
    y = (C @ s).reshape(b, nc, c, h, p)                  # (b,nc,c,n)@(n,h*p)
    return y * torch.exp(dA_cum)[..., None]


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """Chunked SSD (Mamba-2's matrix form), float32.

    x: (b, l, h, p); dt: (b, l, h); A: (h,) negative; B, C: (b, l, n),
    l a multiple of ``chunk``.  Returns (y (b, l, h, p), the state after
    the sequence (b, h, n, p))."""
    b, slen, h, p = x.shape
    n = B.shape[-1]
    if slen % chunk:
        raise ValueError(f"the SSD takes a length that is a multiple of "
                         f"its chunk {chunk}, got {slen}")
    nc = slen // chunk
    x = x.reshape(b, nc, chunk, h, p)
    dt = dt.reshape(b, nc, chunk, h)
    B = B.reshape(b, nc, chunk, n)
    C = C.reshape(b, nc, chunk, n)
    dA_cum = torch.cumsum(dt * A, dim=2)                    # (b, nc, c, h)
    y_diag = _ssd_intra(x, dt, dA_cum, B, C)
    states = _ssd_chunk_states(x, dt, dA_cum, B)
    states_in, s_final = _ssd_recurrence(states, dA_cum[:, :, -1, :])
    y = y_diag + _ssd_off_diag(C, dA_cum, states_in)
    return y.reshape(b, slen, h, p), s_final


def _mamba2_inputs(p: Params, proj: torch.Tensor, cfg: ModelConfig,
                   conv_state=None):
    """From ``in_proj``'s output: the conv over [x, B, C] (the K-1 rows
    of its input it leaves are the new conv state), SiLU, and the
    softplus'd step in float32.  Returns (x, z, B, C, dt, A, conv
    state)."""
    cd = cfg.compute_dtype_
    di, n = cfg.d_inner_, cfg.ssm_state
    xi, z, b, c, dt = torch.split(proj, [di, di, n, n, _mamba2_heads(cfg)],
                                  dim=-1)
    xbc, conv_state = _causal_conv(torch.cat([xi, b, c], dim=-1),
                                   p["conv_w"].to(cd), p["conv_b"].to(cd),
                                   conv_state)
    xi, b, c = torch.split(F.silu(xbc), [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    return xi, z, b, c, dt, -torch.exp(p["A_log"]), conv_state


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor,
                cfg: ModelConfig):
    """``out_proj``'s input from the SSD's float32 y (D x already added):
    the gate first, then the norm — ``rmsnorm(norm, y·silu(z))``, y cast
    to the compute dtype before the gate."""
    return rmsnorm(p["norm"], y.to(cfg.compute_dtype_) * F.silu(z),
                   cfg.norm_eps)


def mamba2_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                   chunk: int = 64, return_state: bool = False):
    """x: (B, L, d) → y (B, L, d) [, the state after the sequence:
    {"conv": (B, K-1, di+2n), "ssm": (B, nh, n, p) float32}].

    A length that is not a multiple of ``chunk`` pads x, dt, B and C with
    zeros after the softplus, as the reference does: a padded step has dt
    = 0 (decay 1, no input), so the final state is the state after the
    last real token."""
    di, hd = cfg.d_inner_, cfg.mamba_head_dim
    nh = _mamba2_heads(cfg)
    b, slen, _ = x.shape
    proj = linear(p["in_proj"], x, cfg.compute_dtype_)
    xi, z, bm, cm, dt, a, conv_state = _mamba2_inputs(p, proj, cfg)
    pad = -slen % chunk
    xi_p, dt_p, b_p, c_p = (F.pad(t, (0, 0, 0, pad)) if pad else t
                            for t in (xi, dt, bm, cm))
    y, s_final = _ssd_chunked(xi_p.float().reshape(b, -1, nh, hd), dt_p, a,
                              b_p.float(), c_p.float(), chunk)
    y = y[:, :slen] + xi.float().reshape(b, slen, nh, hd) \
        * p["D"][None, None, :, None]
    out = linear(p["out_proj"], _gated_norm(p, y.reshape(b, slen, di), z,
                                            cfg), cfg.compute_dtype_)
    if return_state:
        return out, {"conv": conv_state, "ssm": s_final}
    return out


def mamba2_init_cache(cfg: ModelConfig, batch: int, *,
                      device) -> dict[str, torch.Tensor]:
    """One layer's zeroed decode state: conv (B, K-1, di+2n) in the
    compute dtype, ssm (B, nh, n, p) float32."""
    di, n = cfg.d_inner_, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * n),
                            dtype=cfg.compute_dtype_, device=device),
        "ssm": torch.zeros((batch, _mamba2_heads(cfg), n,
                            cfg.mamba_head_dim), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(p: Params, x: torch.Tensor, cache: dict,
                  cfg: ModelConfig):
    """One-token SSD recurrence: h ← exp(dt A) h + dt B ⊗ x; y = C·h + D
    x.  x: (B, 1, d); cache: {conv (B, K-1, di+2n), ssm (B, nh, n, p)}.
    Returns (y (B, 1, d), the new {conv, ssm})."""
    di, hd = cfg.d_inner_, cfg.mamba_head_dim
    nh = _mamba2_heads(cfg)
    b = x.shape[0]
    proj = linear(p["in_proj"], x, cfg.compute_dtype_)
    xi, z, bm, cm, dt, a, conv_state = _mamba2_inputs(p, proj, cfg,
                                                      cache["conv"])
    xh = xi[:, 0].float().reshape(b, nh, hd)
    dt0 = dt[:, 0]                                          # (b, nh)
    bt, ct = bm[:, 0].float(), cm[:, 0].float()             # (b, n)
    # h: (b, nh, n, hd); dt_h B_n x_hp as (b,nh,1,1)·(b,1,n,1)·(b,nh,1,hd)
    h = torch.exp(dt0 * a[None])[..., None, None] * cache["ssm"] + \
        dt0[..., None, None] * bt[:, None, :, None] * xh[:, :, None, :]
    y = (ct[:, None, None, :] @ h)[:, :, 0]                 # (b, nh, hd)
    y = y + xh * p["D"][None, :, None]
    out = linear(p["out_proj"], _gated_norm(p, y.reshape(b, 1, di), z, cfg),
                 cfg.compute_dtype_)
    return out, {"conv": conv_state, "ssm": h}


__all__ = ["mamba1_decode", "mamba1_forward", "mamba1_init",
           "mamba1_init_cache", "mamba2_decode", "mamba2_forward",
           "mamba2_init", "mamba2_init_cache"]
