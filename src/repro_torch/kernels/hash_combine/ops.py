"""The hash_combine wrapper: the ``combine_fn`` of the aggregating shuffle.

``combine(keys, values, num_buckets, valid)`` returns the dense
``(num_buckets,)`` or ``(num_buckets, D)`` per-bucket sum of ``values``
in the values' dtype.  Where it runs follows the tensors the caller gives
it:

* CUDA tensors launch the hand-written kernel (``csrc/hash_combine.cu``,
  built with ``nvcc`` at first use) on the current stream, or raise — a
  failed build, a refused launch or an unsupported dtype is an error,
  never a reason to compute the combine some other way;
* CPU tensors run the plain PyTorch version (``ref.py``), because that is
  where the caller put them.

Keys become contiguous int32 before either runs (a UDF may return int64),
as the reference casts them.  ``combine.launches`` counts the kernel's
launches (one per call on the card), so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import load_library
from .ref import hash_combine_ref

#: value dtypes the kernel takes, with its dtype code
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def library() -> ctypes.CDLL:
    """The built kernel with its C signature declared."""
    lib = load_library("hash_combine")
    fn = lib.hash_combine_launch
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, ll, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check(keys, values, num_buckets, valid) -> None:
    if keys.dim() != 1:
        raise ValueError(f"keys must be (N,), got {tuple(keys.shape)}")
    if values.dim() not in (1, 2) or values.shape[0] != keys.shape[0]:
        raise ValueError(f"values must be (N,) or (N, D) with N = "
                         f"{keys.shape[0]}, got {tuple(values.shape)}")
    if valid is not None and tuple(valid.shape) != tuple(keys.shape):
        raise ValueError(f"valid must be (N,) like keys, got "
                         f"{tuple(valid.shape)}")
    if num_buckets < 1:
        raise ValueError("num_buckets must be >= 1")
    devices = {t.device for t in (keys, values, valid) if t is not None}
    if len(devices) > 1:
        raise ValueError(f"keys, values and valid lie on different devices: "
                         f"{sorted(map(str, devices))}")


def _combine_cuda(keys, values, num_buckets, valid):
    lib = library()
    if values.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA hash_combine takes float32 or bfloat16 "
                        f"values, got {values.dtype}")
    values = values.contiguous()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
    shape = (num_buckets,) + tuple(values.shape[1:])
    d = 1 if values.dim() == 1 else values.shape[1]
    with torch.cuda.device(values.device):
        out = torch.empty(shape, dtype=values.dtype, device=values.device)
        acc = out if values.dtype == torch.float32 else torch.empty(
            shape, dtype=torch.float32, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.hash_combine_launch(
            keys.data_ptr(), values.data_ptr(),
            None if valid is None else valid.data_ptr(), keys.shape[0],
            num_buckets, d, _DTYPE_CODE[values.dtype], acc.data_ptr(),
            None if acc is out else out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hash_combine launch failed: CUDA error {err}")
    combine.launches += 1
    return out


def combine(keys: torch.Tensor, values: torch.Tensor, num_buckets: int,
            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Bucket-accumulate ``values`` by ``keys`` → ``(num_buckets[, D])``.

    keys : (N,) integer (cast to int32; a key outside ``[0,
    num_buckets)`` is dropped); values : (N,) or (N, D) — float32 or
    bfloat16 on the card, summed in float32; valid : (N,) bool or None
    (all valid).  All on one device."""
    _check(keys, values, num_buckets, valid)
    keys = keys.to(torch.int32).contiguous()
    if values.device.type == "cpu":
        return hash_combine_ref(keys, values, num_buckets, valid)
    return _combine_cuda(keys, values, num_buckets, valid)


combine.launches = 0


def make_combine_fn():
    """A ``combine_fn(keys, values, num_buckets, valid)`` for
    ``engine.stages.shuffle_aggregate`` — the reference's factory of the
    same name, whose Pallas/interpret switches have no counterpart here:
    the tensors' device picks kernel or plain version."""
    return combine
