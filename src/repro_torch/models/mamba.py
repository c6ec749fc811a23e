"""Mamba-1 blocks (falcon-mamba).

The partner of the Mamba-1 half of ``repro/models/mamba.py``:
``mamba1_init``, ``_causal_conv``, ``mamba1_forward``,
``mamba1_init_cache`` and ``mamba1_decode``, with the reference's
numerics — projections in ``compute_dtype``; the softplus'd step, ``A``
and the scan in float32; ``dt_bias``, ``A_log`` and ``D`` kept in float32
whatever ``param_dtype`` is.

The reference's model calls its scan with ``use_pallas=False``, so it runs
the ``lax.scan`` oracle and never its Pallas kernel.  The port calls the
scan wrapper of ``kernels/mamba_scan/ops.py`` directly: the CUDA kernel
for tensors on the card, the plain version for CPU tensors.  Decode is the
reference's one-token recurrence (``ops.decode_step``), plain tensor
operations on either device.  The Mamba-2 (SSD) half is not ported
(``ROADMAP.md`` Queue A #13d).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import ops as scan_ops
from .config import ModelConfig
from .layers import Params, dense_init, linear


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


__all__ = ["mamba1_decode", "mamba1_forward", "mamba1_init",
           "mamba1_init_cache"]
