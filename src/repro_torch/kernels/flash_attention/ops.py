"""The flash attention wrappers: prefill attention and split-K decode.

``attention(q, k, v, ...)`` and ``decode_attention(q, k_cache, v_cache,
lengths, ...)`` are what ``repro_torch.models.attention`` calls, in the
JAX package's layouts.  Where they run follows the tensors the caller
gives them:

* CUDA tensors launch the hand-written kernels
  (``csrc/flash_attention.cu``, built with ``nvcc`` at first use) on the
  current stream, or raise — a failed build, a refused launch or an
  unsupported dtype or shape is an error, never a reason to compute the
  attention some other way.  The forward is ``fwd_wgmma`` (TMA loads,
  wgmma products) for bfloat16 at head dims 64, 128 and 256, ``fwd_rows``
  otherwise (``forward_kernel``).  Decode is ``decode_cluster``: one
  launch of thread-block clusters that split each row's live cache range
  and merge in distributed shared memory (``decode_geometry``);
* CPU tensors run the plain PyTorch versions (``ref.py``):
  ``chunked_attention`` for the forward, ``decode_ref`` for decode.

``attention.launches`` and ``decode_attention.launches`` count kernel
launches (one per call on the card), so a run can show that its main path
went through them.

Training differentiates ``attention`` as the reference does, through the
chunked path: on the card the call is a ``torch.autograd.Function`` whose
forward launches the kernel and whose backward recomputes the output
with ``chunked_attention`` under autograd and returns that vector-Jacobian
product (no backward kernel: the reference has none).  ``decode_attention``
has no gradient in either package, so a CUDA input that requires grad
makes it raise rather than return a result cut off from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .ref import chunked_attention, decode_ref

#: dtypes the kernels take, with their dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the kernels hold D/32 dimensions per lane in registers, at most 8
MAX_HEAD_DIM = 256
#: the TMA reads q, k and v from 16-byte aligned addresses
TMA_ALIGN = 16
#: decode keeps the q vectors of one GQA group in registers, at most 8
MAX_GROUP = 8


def library() -> ctypes.CDLL:
    """The built kernels with their C signatures declared."""
    lib = load_library("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, dec = lib.flash_attention_fwd_launch, lib.flash_decode_launch
    tile, geometry = lib.flash_attention_fwd_tile, lib.flash_decode_geometry
    if tile.argtypes is None:
        tile.argtypes = [i, i] + [ctypes.POINTER(i)] * 3
        tile.restype = ctypes.c_int
    if fwd.argtypes is None:
        fwd.argtypes = [p, p, p, p] + [i] * 9 + [f, f, p]
        fwd.restype = ctypes.c_int
    if dec.argtypes is None:
        dec.argtypes = [p] * 5 + [i] * 7 + [f, f, i, p]
        dec.restype = ctypes.c_int
    if geometry.argtypes is None:
        geometry.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 3
        geometry.restype = ctypes.c_int
    return lib


def _check_dtypes(*tensors) -> None:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) > 1:
        raise TypeError(f"attention inputs have mixed dtypes "
                        f"{sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"attention takes float32 or bfloat16 inputs, got "
                        f"{dtype}")


def _check_devices(*tensors) -> None:
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"attention inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")


def _check_heads(hq: int, hkv: int) -> None:
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")


def _check_attention(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"attention wants q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Skv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    _check_heads(q.shape[1], k.shape[1])
    _check_devices(q, k, v)
    _check_dtypes(q, k, v)


def _window(window) -> int:
    return int(window) if window is not None and window > 0 else 0


def _softcap(softcap) -> float:
    return float(softcap) if softcap is not None and softcap > 0 else 0.0


def forward_tile(dtype: torch.dtype,
                 head_dim: int) -> tuple[int, int, int] | None:
    """``fwd_wgmma``'s tile at this dtype and head dim, as the built
    library reports it: (query rows of a block, keys of a K/V tile, ring
    slots per operand); None where the forward runs ``fwd_rows``."""
    rows, keys, stages = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if not library().flash_attention_fwd_tile(
            head_dim, _DTYPE_CODE.get(dtype, -1), ctypes.pointer(rows),
            ctypes.pointer(keys), ctypes.pointer(stages)):
        return None
    return rows.value, keys.value, stages.value


def forward_kernel(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA forward of this dtype and head dim launches:
    ``fwd_wgmma`` (TMA and wgmma) where the library reports a tile for
    it, ``fwd_rows`` (float32 FMAs) otherwise."""
    return "fwd_rows" if forward_tile(dtype, head_dim) is None \
        else "fwd_wgmma"


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a ``TMA_ALIGN``-byte boundary (a
    view into a larger tensor may not): a copy where it is not."""
    t = t.contiguous()
    if t.data_ptr() % TMA_ALIGN:
        t = t.clone()
    return t


def _attention_cuda(q, k, v, causal, window, softcap, scale):
    """One launch of the forward kernel (no autograd)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA flash attention takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    lib = library()
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
            _window(window), _softcap(softcap), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error "
                           f"{err}")
    attention.launches += 1
    return out


class _KernelAttention(torch.autograd.Function):
    """The kernel's forward with the reference's gradient: the backward
    recomputes ``chunked_attention`` on the saved q, k and v (same causal,
    window, softcap, scale and ``chunk``; ``q_offset`` is 0 on the card)
    and returns its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale, chunk)
        return _attention_cuda(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, grad):
        causal, window, softcap, scale, chunk = ctx.args
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = chunked_attention(*inputs, causal=causal,
                                    window=window or None, softcap=softcap,
                                    scale=scale, chunk=chunk)
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad))
        return tuple(next(got) if t.requires_grad else None
                     for t in inputs) + (None,) * 5


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None, scale: float | None = None,
              chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Attention forward: q (B, Hq, Sq, D) against k, v (B, Hkv, Skv, D)
    → (B, Hq, Sq, D) in q's dtype.

    GQA by head grouping (Hq % Hkv == 0); ``causal`` masks keys after the
    query (query i sits at position ``q_offset + i``, key j at j);
    ``window`` (None or 0 = global) keeps keys with i - j < window;
    ``softcap`` maps scores to c·tanh(s/c); ``scale`` defaults to
    D**-0.5.  float32 or bfloat16, all on one device.  Differentiable on
    either device (see the module's docstring): ``chunk`` is the keys a
    block of ``chunked_attention``, the CPU's forward and the card's
    backward (the kernel's forward tiles the keys its own way); the kernel
    takes ``q_offset`` 0 only, and raises for any other."""
    _check_attention(q, k, v)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal,
                                 window=window or None, softcap=softcap,
                                 scale=scale, chunk=chunk,
                                 q_offset=q_offset)
    if q_offset:
        raise ValueError(f"the CUDA flash attention takes q_offset 0, got "
                         f"{q_offset}")
    return _KernelAttention.apply(q, k, v, causal, window, softcap, scale,
                                  chunk)


attention.launches = 0


def _check_decode(q, k_cache, v_cache, lengths) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or \
            tuple(k_cache.shape) != tuple(v_cache.shape):
        raise ValueError(f"decode wants q (B, Hq, D) and caches "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if q.shape[0] != k_cache.shape[0] or q.shape[2] != k_cache.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and the cache "
                         f"{tuple(k_cache.shape)} differ in batch or head "
                         f"dim")
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"lengths must be (B,) = ({q.shape[0]},), got "
                         f"{tuple(lengths.shape)}")
    _check_heads(q.shape[1], k_cache.shape[1])
    _check_devices(q, k_cache, v_cache, lengths)
    _check_dtypes(q, k_cache, v_cache)


def _check_decode_shape(q, k_cache) -> None:
    d, group = q.shape[-1], q.shape[1] // k_cache.shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA decode takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    if group > MAX_GROUP:
        raise ValueError(f"the CUDA decode takes GQA groups of at most "
                         f"{MAX_GROUP} q heads, got {group}")


def decode_geometry(q: torch.Tensor,
                    k_cache: torch.Tensor) -> tuple[int, int, int]:
    """The CUDA decode's geometry for a call on these tensors, as the
    built library reports it for their device: (cluster size — blocks that
    share one (batch row, kv head)'s live range —, keys of a K/V tile,
    slots of the ring)."""
    _check_decode_shape(q, k_cache)
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    cluster, keys, slots = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(q.device):
        err = library().flash_decode_geometry(
            d, _DTYPE_CODE[q.dtype], hq // hkv, s_max, b, hkv,
            ctypes.pointer(cluster), ctypes.pointer(keys),
            ctypes.pointer(slots))
    if err != 0:
        raise RuntimeError(f"flash decode geometry failed: CUDA error {err}")
    return cluster.value, keys.value, slots.value


def _decode_cuda(q, k_cache, v_cache, lengths, window, softcap, scale,
                 cluster=0):
    """One launch of the cluster kernel; ``cluster`` 0 takes the library's
    cluster size, a size from 1 to 16 forces one.  Allocates only the
    output (given contiguous caches, q and int32 lengths)."""
    _check_decode_shape(q, k_cache)
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    lib = library()
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), b, hq, hkv, s_max, d,
            _DTYPE_CODE[q.dtype], _window(window), _softcap(softcap),
            float(scale), int(cluster), stream)
    if err != 0:
        raise RuntimeError(f"flash decode launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int | None = None,
                     softcap: float | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """One query token per row against a KV cache: q (B, Hq, D), caches
    (B, Hkv, S, D), lengths (B,) → (B, Hq, D) in q's dtype.

    Row b sees cache positions [max(0, lengths[b] - window),
    min(lengths[b], S)) (``window`` None or 0 = all of [0, lengths[b])).
    float32 or bfloat16, all on one device; lengths stay on the device.

    Contract: lengths >= 1 (the model's ``attn_decode`` passes lengths +
    1).  A row of length 0 attends to no key, and the two paths answer it
    as their reference twins do: the plain version gives the mean of V
    over all S rows (the reference's ``decode_ref``), the kernel gives 0
    (the reference's ``flash_decode``).  Neither is a result to rely on."""
    _check_decode(q, k_cache, v_cache, lengths)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, lengths,
                          window=window or None, softcap=softcap,
                          scale=scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("decode_attention has no gradient on the card "
                           "(the reference differentiates no decode): call "
                           "it on tensors that do not require grad, or "
                           "under torch.no_grad()")
    return _decode_cuda(q, k_cache, v_cache, lengths, window, softcap, scale)


decode_attention.launches = 0

__all__ = ["attention", "decode_attention", "decode_geometry",
           "forward_kernel", "forward_tile", "library"]
