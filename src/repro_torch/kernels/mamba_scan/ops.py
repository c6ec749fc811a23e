"""The selective-scan wrapper and the one-token decode step.

``scan(u, delta, A, B, C, D)`` is what ``repro_torch.models.mamba`` calls,
in the JAX package's layouts (``repro/kernels/mamba_scan/ops.py``): ``u``
and ``delta`` are (batch, L, D), ``A`` is (D, N), ``B`` and ``C`` are
(batch, L, N), ``D`` is (D,).  It returns ``(y, h_final)``: y (batch, L,
D) in u's dtype and the final state (batch, D, N) in float32.  Where it
runs follows the tensors the caller gives it:

* CUDA tensors launch the hand-written kernel (``csrc/mamba_scan.cu``, a
  scan parallel over time in chunks of ``scan_tile()`` steps, built with
  ``nvcc`` at first use) on the current stream, or raise — a
  failed build, a refused launch or an unsupported dtype or shape is an
  error, never a reason to scan some other way;
* CPU tensors run the plain PyTorch version (``ref.py``).

``scan.launches`` counts kernel launches (one per call on the card), so a
run can show that its main path went through the kernel.  The kernel has
no gradient, so a CUDA input that requires grad (with grad mode on) makes
``scan`` raise instead of returning a result cut off from the graph; the
plain version stays differentiable.

``decode_step`` is the O(1) one-token update of a carried state.  It is
plain tensor operations on either device, as the reference's is: it has no
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .ref import selective_scan_ref

#: dtypes of u, delta, B and C the kernel takes, with their dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: states per channel the kernel holds in registers, at most
MAX_STATE = 16


def library() -> ctypes.CDLL:
    """The built kernel with its C signatures declared."""
    lib = load_library("mamba_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn, tile = lib.mamba_scan_launch, lib.mamba_scan_tile
    occupancy = lib.mamba_scan_blocks_per_sm
    if fn.argtypes is None:
        fn.argtypes = [p] * 8 + [i] * 4 + [ll] * 4 + [i, p]
        fn.restype = ctypes.c_int
    if tile.argtypes is None:
        tile.argtypes = [ctypes.POINTER(i)] * 3
        tile.restype = None
    if occupancy.argtypes is None:
        occupancy.argtypes = [i]
        occupancy.restype = ctypes.c_int
    return lib


def scan_tile() -> tuple[int, int, int]:
    """The kernel's chunk geometry, as the built library reports it:
    (channels a block owns; consecutive steps a lane owns in a chunk; steps
    of a chunk, shared by chunk / items lanes of one channel)."""
    channels, items, chunk = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    library().mamba_scan_tile(ctypes.pointer(channels), ctypes.pointer(items),
                              ctypes.pointer(chunk))
    return channels.value, items.value, chunk.value


def blocks_per_sm(dtype: torch.dtype) -> int:
    """Blocks of the kernel that fit one SM of the current card at this
    input dtype (the CUDA occupancy calculator, with the launch's shared
    memory); raises on a CUDA error."""
    n = library().mamba_scan_blocks_per_sm(_DTYPE_CODE[dtype])
    if n < 0:
        raise RuntimeError(f"mamba scan occupancy query failed: CUDA error "
                           f"{-n}")
    return n


def _check(u, delta, A, B, C, D) -> None:
    if u.dim() != 3 or tuple(delta.shape) != tuple(u.shape):
        raise ValueError(f"scan wants u and delta (batch, L, D), got "
                         f"{tuple(u.shape)} and {tuple(delta.shape)}")
    bsz, length, d = u.shape
    if A.dim() != 2 or A.shape[0] != d:
        raise ValueError(f"A must be (D, N) with D = {d}, got "
                         f"{tuple(A.shape)}")
    want = (bsz, length, A.shape[1])
    if tuple(B.shape) != want or tuple(C.shape) != want:
        raise ValueError(f"B and C must be (batch, L, N) = {want}, got "
                         f"{tuple(B.shape)} and {tuple(C.shape)}")
    if tuple(D.shape) != (d,):
        raise ValueError(f"D must be ({d},), got {tuple(D.shape)}")
    devices = {t.device for t in (u, delta, A, B, C, D)}
    if len(devices) > 1:
        raise ValueError(f"scan inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")


def _unit_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its last dimension is contiguous, else a copy."""
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def _scan_cuda(u, delta, A, B, C, D):
    bsz, length, d = u.shape
    n = A.shape[1]
    dtypes = {t.dtype for t in (u, delta, B, C)}
    if len(dtypes) > 1 or u.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA scan takes u, delta, B and C of one "
                        f"dtype, float32 or bfloat16, got "
                        f"{sorted(map(str, dtypes))}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"the CUDA scan takes A and D in float32, got "
                        f"{A.dtype} and {D.dtype}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the CUDA scan takes 1 <= N <= {MAX_STATE} "
                         f"states, got {n}")
    if length < 1:
        raise ValueError("the CUDA scan takes L >= 1")
    lib = library()
    u, delta = u.contiguous(), delta.contiguous()
    A, D = A.contiguous(), D.contiguous()
    B, C = _unit_last(B), _unit_last(C)
    with torch.cuda.device(u.device):
        y = torch.empty_like(u)
        h = torch.empty((bsz, d, n), dtype=torch.float32, device=u.device)
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.mamba_scan_launch(
            u.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(), bsz,
            length, d, n, B.stride(0), B.stride(1), C.stride(0),
            C.stride(1), _DTYPE_CODE[u.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba scan launch failed: CUDA error {err}")
    scan.launches += 1
    return y, h


def scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
         B: torch.Tensor, C: torch.Tensor,
         D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan over a full sequence from a zero state:
    ``h_t = exp(Δ_t·A) ⊙ h_{t−1} + (Δ_t·u_t) ⊗ B_t``, ``y_t = ⟨h_t, C_t⟩ +
    D·u_t``.  Returns (y (batch, L, D) in u's dtype, h_final (batch, D, N)
    float32).

    On the card: u, delta, B and C float32 or bfloat16 (one dtype), A and
    D float32, 1 <= N <= 16, L >= 1; B and C may be strided views (their
    last dimension is copied to unit stride if it is not)."""
    _check(u, delta, A, B, C, D)
    if u.device.type == "cpu":
        return selective_scan_ref(u, delta, A, B, C, D)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, delta, A, B, C, D)):
        raise RuntimeError("the CUDA scan has no gradient (the reference "
                           "differentiates its lax.scan, which has no "
                           "kernel): call it on tensors that do not require "
                           "grad, or under torch.no_grad()")
    return _scan_cuda(u, delta, A, B, C, D)


scan.launches = 0


def decode_step(h: torch.Tensor, u_t: torch.Tensor, delta_t: torch.Tensor,
                A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor,
                D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step for decoding.

    h: (batch, D, N) carried state; u_t, delta_t: (batch, D); B_t, C_t:
    (batch, N).  Returns (y_t (batch, D) in u_t's dtype, h_new (batch, D,
    N))."""
    d_a = torch.exp(delta_t[..., None] * A[None].float())
    d_bu = (delta_t * u_t)[..., None] * B_t[:, None, :]
    h_new = d_a * h + d_bu
    y = torch.einsum("bdn,bn->bd", h_new, C_t) + u_t * D[None]
    return y.to(u_t.dtype), h_new


__all__ = ["MAX_STATE", "blocks_per_sm", "decode_step", "library", "scan",
           "scan_tile", "selective_scan_ref"]
