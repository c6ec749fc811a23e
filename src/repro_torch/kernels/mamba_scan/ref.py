"""Plain PyTorch version of the Mamba-1 selective scan.

The partner of ``repro/kernels/mamba_scan/ref.py`` (``selective_scan_ref``).
It is the oracle the CUDA kernel (``csrc/mamba_scan.cu``) is held against
on the card, and the CPU path of ``ops.scan``.  Sequential in time and
float32 inside, like the reference's oracle: every input is upcast to
float32 first, ``D·u`` is added in float32, and ``y`` is rounded to
``u``'s dtype once.

To keep the number of launches near one per time step on the card, the
step-independent terms ``exp(Δ_t·A)`` and ``(Δ_t·u_t) ⊗ B_t`` are formed
for ``CHUNK`` steps at a time, the recurrence ``h_t = dA_t ⊙ h_{t-1} +
dBu_t`` walks those steps one by one, and ``y_t = ⟨h_t, C_t⟩`` is
contracted for the whole chunk at once.  The arithmetic per element is the
oracle's.  It is differentiable: under autograd the steps are kept as
separate tensors, which is how training differentiates the scan (the
reference differentiates its ``lax.scan``).
"""

from __future__ import annotations

import torch

#: time steps whose step-independent terms are formed at once
CHUNK = 64


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor,
                       A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       D: torch.Tensor, h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential-in-time selective scan.

    u, delta : (batch, L, D)   (delta already softplus'd and biased)
    A        : (D, N)
    B, C     : (batch, L, N)
    D        : (D,)            (skip)
    h0       : (batch, D, N) initial state (None = zeros)

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + (Δ_t u_t) ⊗ B_t ;  y_t = ⟨h_t, C_t⟩ + D u_t
    Returns (y in u's dtype (batch, L, D), h_final float32 (batch, D, N))."""
    bsz, length, d = u.shape
    n = A.shape[1]
    af = A.float()
    # under autograd each step is a fresh tensor (``out=`` records no
    # gradient); without it the steps are written into one buffer
    track = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (u, delta, A, B, C, D, h0))
    h = (torch.zeros((bsz, d, n), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float().clone())
    ys = []
    for s in range(0, length, CHUNK):
        e = min(length, s + CHUNK)
        # time-major (T, batch, ...) so that each step's slice is contiguous
        uf = u[:, s:e].float().transpose(0, 1)
        df = delta[:, s:e].float().transpose(0, 1)
        bf = B[:, s:e].float().transpose(0, 1)
        cf = C[:, s:e].float().transpose(0, 1)
        d_a = torch.exp(df[..., None] * af)                  # (T, b, d, n)
        d_bu = (df * uf)[..., None] * bf[:, :, None, :]      # (T, b, d, n)
        if track:
            steps = []
            for t in range(e - s):
                h = torch.addcmul(d_bu[t], d_a[t], h)
                steps.append(h)
            hs = torch.stack(steps)
        else:
            hs = torch.empty_like(d_a)
            for t in range(e - s):
                h = torch.addcmul(d_bu[t], d_a[t], h, out=hs[t])
            h = hs[-1].clone()
        ys.append(torch.einsum("tbdn,tbn->btd", hs, cf))
        del d_a, d_bu, hs
    y = torch.cat(ys, dim=1) if ys else torch.zeros(
        (bsz, 0, d), dtype=torch.float32, device=u.device)
    y = y + u.float() * D.float()[None, None]
    return y.to(u.dtype), h


__all__ = ["selective_scan_ref"]
