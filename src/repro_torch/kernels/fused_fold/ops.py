"""The fused streaming fold's wrapper: one call per micro-batch.

``make_fold_step(**geometry, device=...)`` closes over a plan's geometry
once, as the reference's ``make_fold_step`` does: it validates it, packs
it for the kernel, and returns ``step(rows, carry, min_window)`` (or
``step(rows, carry)`` on the host wire).  Each step updates the carry
**in place** and returns ``(carry, stats)`` with ``stats`` a fresh int32
``[late, folded, 0]`` tensor on the carry's device.  ``fold(...)`` is
the one-off form of the same call.  Where a step runs follows the
tensors the caller gives it:

* CUDA tensors launch the hand-written kernel (``csrc/fused_fold.cu``,
  built with ``nvcc`` at first use) on the current stream, one
  cooperative launch a fold, or raise — a failed build, a refused launch
  or a bad argument is an error, never a reason to compute the fold some
  other way;
* CPU tensors run the plain PyTorch version (``ref.py``), because that is
  where the caller put them.

``fold.launches`` counts the kernel's launches (one per step on the
card), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelError, load_library
from .ref import (DEVICE_ROW, FOLD_KINDS, HOST_ROW, INT32_MIN,
                  fused_streaming_fold_ref)

_KIND_CODE = {kind: i for i, kind in enumerate(FOLD_KINDS)}


class _Geometry(ctypes.Structure):
    """``FoldGeometry`` of ``csrc/fused_fold.cu``, field by field."""
    _fields_ = [("size", ctypes.c_longlong), ("fanout", ctypes.c_int),
                ("n_slots", ctypes.c_int), ("num_buckets", ctypes.c_int),
                ("carry_buckets", ctypes.c_int),
                ("channel_base", ctypes.c_int), ("hashed", ctypes.c_int),
                ("host_wire", ctypes.c_int), ("kind", ctypes.c_int),
                ("device", ctypes.c_int), ("max_blocks", ctypes.c_int)]


def library() -> ctypes.CDLL:
    """The built kernel with its C signatures declared."""
    lib = load_library("fused_fold")
    if lib.fused_fold_launch.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.fused_fold_prepare.argtypes = [p]
        lib.fused_fold_prepare.restype = i
        lib.fused_fold_launch.argtypes = [p, p, ll, p, i, p, p, i, p]
        lib.fused_fold_launch.restype = i
    return lib


def _check_geometry(*, fanout, n_slots, num_buckets, carry_buckets,
                    channel_base, kind) -> None:
    if kind not in FOLD_KINDS:
        raise ValueError(f"unknown fold kind {kind!r}")
    if channel_base < 0:
        raise ValueError("channel window [base, base+2) must fit the "
                         "carry's channel count")
    if min(fanout, n_slots, num_buckets, carry_buckets) < 1:
        raise ValueError(f"fold geometry needs positive sizes, got fanout="
                         f"{fanout} n_slots={n_slots} num_buckets="
                         f"{num_buckets} carry_buckets={carry_buckets}")


def _make(*, fanout, n_slots, num_buckets, carry_buckets, channel_base,
          hashed, host_wire, kind, device):
    """``run(rows, carry, min_window)`` for one validated, packed
    geometry; its ``geometry`` attribute is the packed ``_Geometry``."""
    _check_geometry(fanout=fanout, n_slots=n_slots, num_buckets=num_buckets,
                    carry_buckets=carry_buckets, channel_base=channel_base,
                    kind=kind)
    device = torch.device(device)
    size = n_slots * carry_buckets
    width = HOST_ROW if host_wire else DEVICE_ROW
    extremum = kind in ("min", "max")
    plain_kw = dict(fanout=fanout, n_slots=n_slots, num_buckets=num_buckets,
                    carry_buckets=carry_buckets, channel_base=channel_base,
                    hashed=hashed, host_wire=host_wire, kind=kind)
    geometry = _Geometry(size, fanout, n_slots, num_buckets, carry_buckets,
                         channel_base, int(hashed), int(host_wire),
                         _KIND_CODE[kind], -1, 0)
    # filled at the first CUDA call: (launch, geometry address, the current
    # raw stream of a device index, the device); the library is looked up
    # once
    bound = []

    def _bind():
        lib = library()
        index = device.index
        if device.type == "cuda" and index is None:
            index = torch.cuda.current_device()
        geometry.device = -1 if index is None else index
        if device.type == "cuda":
            err = lib.fused_fold_prepare(ctypes.addressof(geometry))
            if err != 0:
                raise KernelError(f"fused_fold cannot launch on {device}: "
                                  f"CUDA error {err}")
        bound.append((lib.fused_fold_launch, ctypes.addressof(geometry),
                      torch._C._cuda_getCurrentRawStream,
                      torch.device(device.type, index)))
        return bound[0]

    def run(rows, carry, min_window):
        if rows.dim() != 2 or rows.shape[1] != width:
            raise ValueError(f"expected width-{width} wire rows, got "
                             f"{tuple(rows.shape)}")
        if carry.dim() != 2 or carry.shape[0] != size:
            raise ValueError(f"carry has shape {tuple(carry.shape)}, "
                             f"expected ({size}, channels)")
        channels = carry.shape[1]
        if channel_base > channels - 2:
            raise ValueError("channel window [base, base+2) must fit the "
                             "carry's channel count")
        if rows.dtype != torch.float32 or carry.dtype != torch.float32:
            raise TypeError("the fold takes float32 rows and carry")
        where = carry.device
        if rows.device != where:
            raise ValueError(f"rows on {rows.device} but carry on {where}")
        minw = INT32_MIN if min_window is None else int(min_window)
        if where.type == "cpu":
            new, stats = fused_streaming_fold_ref(rows, carry, minw,
                                                  **plain_kw)
            carry.copy_(new)
            return carry, stats
        launch, packed, stream, on = bound[0] if bound else _bind()
        if not carry.is_cuda:
            raise ValueError("the CUDA fold takes CUDA tensors")
        if where != on:
            raise ValueError(f"tensors on {where} but the step was made "
                             f"for {on}")
        if not (rows.is_contiguous() and carry.is_contiguous()):
            raise ValueError("the CUDA fold takes contiguous rows and carry")
        stats = torch.empty(3, dtype=torch.int32, device=where)
        scratch = torch.empty((size, 2), dtype=torch.int32,
                              device=where) if extremum else None
        err = launch(packed, rows.data_ptr(), rows.shape[0],
                     carry.data_ptr(), channels, stats.data_ptr(),
                     None if scratch is None else scratch.data_ptr(), minw,
                     stream(where.index))
        if err != 0:
            raise KernelError(f"fused_fold launch failed: CUDA error {err}")
        fold.launches += 1
        return carry, stats

    run.geometry = geometry
    return run


def make_fold_step(*, fanout, n_slots, num_buckets, carry_buckets,
                   channel_base=0, hashed=False, host_wire=False, kind="sum",
                   device):
    """A plan's fold, its geometry closed over once.

    Returns ``step(rows, carry, min_window) -> (carry, stats)`` for the
    device wire, or ``step(rows, carry)`` for the host wire — the
    signatures of the reference's ``make_fold_step``.  A bad geometry
    raises here; each call checks only what can change (the rows' width,
    dtype and device, the carry's shape, contiguity on the card).  On the
    card every call is one kernel launch into a fresh ``stats`` tensor
    (``torch.empty``: the caller may keep it until a later barrier) and,
    for min / max, a fresh scratch; nothing else is kept between calls
    but the library and the packed geometry (``step.geometry``)."""
    run = _make(fanout=fanout, n_slots=n_slots, num_buckets=num_buckets,
                carry_buckets=carry_buckets, channel_base=channel_base,
                hashed=hashed, host_wire=host_wire, kind=kind, device=device)
    if host_wire:
        def step(rows, carry):
            return run(rows, carry, None)
    else:
        def step(rows, carry, min_window):
            return run(rows, carry, min_window)
    step.geometry = run.geometry
    return step


def fold(rows, carry, min_window=None, *, fanout, n_slots, num_buckets,
         carry_buckets, channel_base=0, hashed=False, host_wire=False,
         kind="sum"):
    """One micro-batch fold, in place: ``(rows, carry[, min_window]) →
    (carry, [late, folded, 0])`` — a step of ``make_fold_step`` for the
    carry's device, made for this call alone.

    rows : ``(N, 5)`` float32 device wire ``[last_window_index,
    n_windows, key, value, valid]`` (or ``(N, 4)`` host wire
    ``[window_slot, key, value, valid]`` with ``host_wire=True``); carry :
    the flat ``(n_slots * carry_buckets, channels)`` slab, on the same
    device.  ``min_window`` (default: int32 min) masks late pairs."""
    return _make(fanout=fanout, n_slots=n_slots, num_buckets=num_buckets,
                 carry_buckets=carry_buckets, channel_base=channel_base,
                 hashed=hashed, host_wire=host_wire, kind=kind,
                 device=carry.device)(rows, carry, min_window)


fold.launches = 0
