"""The fused streaming fold's wrapper: one call per micro-batch.

``fold`` updates the carry **in place** and returns ``(carry, stats)``
with ``stats`` an int32 ``[late, folded, 0]`` tensor on the carry's
device.  Where it runs follows the tensors the caller gives it:

* CUDA tensors launch the hand-written kernel (``csrc/fused_fold.cu``,
  built with ``nvcc`` at first use) on the current stream, or raise — a
  failed build, a refused launch or a bad argument is an error, never a
  reason to compute the fold some other way;
* CPU tensors run the plain PyTorch version (``ref.py``), because that is
  where the caller put them.

``fold.launches`` counts the kernel's launches (one per call on the
card), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from .._build import KernelError, load_library
from .ref import (DEVICE_ROW, FOLD_KINDS, HOST_ROW, INT32_MIN,
                  fused_streaming_fold_ref)

_KIND_CODE = {kind: i for i, kind in enumerate(FOLD_KINDS)}


def _ordered_int(x: float) -> int:
    """The kernel's order-preserving int encoding of a float32."""
    i = struct.unpack("<i", struct.pack("<f", x))[0]
    return i if i >= 0 else i ^ 0x7FFFFFFF


_EXT_INIT = {"min": _ordered_int(float("inf")),
             "max": _ordered_int(float("-inf"))}


def library() -> ctypes.CDLL:
    """The built kernel with its C signature declared."""
    lib = load_library("fused_fold")
    fn = lib.fused_fold_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, ll, p, ll, i, p, p, p,
                       i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check(rows, carry, *, n_slots, carry_buckets, channel_base, host_wire,
           kind) -> None:
    if kind not in FOLD_KINDS:
        raise ValueError(f"unknown fold kind {kind!r}")
    width = HOST_ROW if host_wire else DEVICE_ROW
    if rows.dim() != 2 or rows.shape[1] != width:
        raise ValueError(f"expected width-{width} wire rows, got "
                         f"{tuple(rows.shape)}")
    if carry.dim() != 2 or carry.shape[0] != n_slots * carry_buckets:
        raise ValueError(f"carry has shape {tuple(carry.shape)}, expected "
                         f"({n_slots * carry_buckets}, channels)")
    if not 0 <= channel_base <= carry.shape[1] - 2:
        raise ValueError("channel window [base, base+2) must fit the "
                         "carry's channel count")
    if rows.dtype != torch.float32 or carry.dtype != torch.float32:
        raise TypeError("the fold takes float32 rows and carry")
    if rows.device != carry.device:
        raise ValueError(f"rows on {rows.device} but carry on "
                         f"{carry.device}")


def _fold_cuda(rows, carry, min_window, *, fanout, n_slots, num_buckets,
               carry_buckets, channel_base, hashed, host_wire, kind):
    lib = library()
    if not carry.is_cuda:
        raise ValueError("the CUDA fold takes CUDA tensors")
    if not (rows.is_contiguous() and carry.is_contiguous()):
        raise ValueError("the CUDA fold takes contiguous rows and carry")
    with torch.cuda.device(carry.device):
        size = carry.shape[0]
        stats = torch.zeros(3, dtype=torch.int32, device=carry.device)
        ext = cnt = None
        if kind in ("min", "max"):
            ext = torch.full((size,), _EXT_INIT[kind], dtype=torch.int32,
                             device=carry.device)
            cnt = torch.zeros(size, dtype=torch.float32, device=carry.device)
        stream = torch.cuda.current_stream(carry.device).cuda_stream
        err = lib.fused_fold_launch(
            rows.data_ptr(), rows.shape[0], carry.data_ptr(), size,
            carry.shape[1], stats.data_ptr(),
            None if ext is None else ext.data_ptr(),
            None if cnt is None else cnt.data_ptr(),
            fanout, n_slots, num_buckets, carry_buckets, channel_base,
            int(hashed), int(host_wire), _KIND_CODE[kind], min_window,
            stream)
    if err != 0:
        raise KernelError(f"fused_fold launch failed: CUDA error {err}")
    fold.launches += 1
    return carry, stats


def fold(rows, carry, min_window=None, *, fanout, n_slots, num_buckets,
         carry_buckets, channel_base=0, hashed=False, host_wire=False,
         kind="sum"):
    """One micro-batch fold, in place: ``(rows, carry[, min_window]) →
    (carry, [late, folded, 0])``.

    rows : ``(N, 5)`` float32 device wire ``[last_window_index,
    n_windows, key, value, valid]`` (or ``(N, 4)`` host wire
    ``[window_slot, key, value, valid]`` with ``host_wire=True``); carry :
    the flat ``(n_slots * carry_buckets, channels)`` slab, on the same
    device.  ``min_window`` (default: int32 min) masks late pairs."""
    _check(rows, carry, n_slots=n_slots, carry_buckets=carry_buckets,
           channel_base=channel_base, host_wire=host_wire, kind=kind)
    minw = INT32_MIN if min_window is None else int(min_window)
    geometry = dict(fanout=fanout, n_slots=n_slots, num_buckets=num_buckets,
                    carry_buckets=carry_buckets, channel_base=channel_base,
                    hashed=hashed, host_wire=host_wire, kind=kind)
    if carry.device.type == "cpu":
        new, stats = fused_streaming_fold_ref(rows, carry, minw, **geometry)
        carry.copy_(new)
        return carry, stats
    return _fold_cuda(rows, carry, minw, **geometry)


fold.launches = 0
