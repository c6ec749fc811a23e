"""The fused fold kernel on the card: one launch a fold, bit for bit.

No JAX here: these tests run on the card machine
(``python -m pytest -m cuda tests/test_torch_fold_step_cuda.py``) and
skip elsewhere.  ``test_torch_fold_step.py`` holds the step's plain
version against the reference's ``make_fold_step``.  Values are
integers, so float32 sums are exact in any order and every comparison
is exact (tolerance zero).
"""

import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.fused_fold import ops
from repro_torch.kernels.fused_fold.ref import (FOLD_KINDS,
                                                fused_streaming_fold_ref)

N_SLOTS, NB, FANOUT = 8, 4096, 5
# more rows than the card's co-resident threads: the grid strides
N_ROWS = 1 << 19


def _rows(rng, n, *, host_wire, keymax):
    if host_wire:
        cols = [rng.integers(0, N_SLOTS, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.15]
    else:
        cols = [rng.integers(-9, 3 * N_SLOTS, n),
                rng.integers(0, FANOUT + 1, n), rng.integers(0, keymax, n),
                rng.integers(-20, 100, n), rng.random(n) > 0.15]
    return np.stack(cols, axis=1).astype(np.float32)


def _carry(rng, size, channels, kind):
    carry = rng.integers(0, 5, (size, channels)).astype(np.float32)
    if kind in ("min", "max"):
        for b in range(0, channels - 1, 2):
            carry[:, b] = np.where(carry[:, b + 1] > 0, carry[:, b], 0.0)
    return carry


def _geometry(host_wire, kind, hashed=False, base=0):
    return dict(fanout=1 if host_wire else FANOUT, n_slots=N_SLOTS,
                num_buckets=NB, carry_buckets=NB, channel_base=base,
                hashed=hashed, host_wire=host_wire, kind=kind)


def _call(step, rows, carry, host_wire, minw=2):
    return step(rows, carry) if host_wire else step(rows, carry, minw)


# (host_wire, kind, hashed, channel_base, channels): C and base even take
# the paired (float2) reduction, C = 3 at base 1 the scalar pair
PATHS = [(hw, kind, hashed, 0, 2) for hw in (False, True)
         for kind in FOLD_KINDS for hashed in (False, True)]
PATHS += [(False, "sum", False, 2, 4), (False, "sum", False, 1, 3),
          (True, "count", True, 1, 3), (False, "max", False, 1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "host_wire,kind,hashed,base,channels", PATHS,
    ids=[f"{'host' if p[0] else 'device'}-{p[1]}-"
         f"{'hashed' if p[2] else 'dense'}-base{p[3]}of{p[4]}" for p in PATHS])
def test_step_is_bit_identical_to_the_plain_version(cuda_device, host_wire,
                                                    kind, hashed, base,
                                                    channels):
    """The vector path (even C and base) and the scalar path (C = 3,
    base 1), every kind and wire, rows past the co-resident grid: carry
    and stats equal the plain version's, and other channels untouched."""
    rng = np.random.default_rng(59)
    keymax = (1 << 24) if hashed else NB
    rows = torch.from_numpy(_rows(rng, N_ROWS, host_wire=host_wire,
                                  keymax=keymax)).to(cuda_device)
    carry = torch.from_numpy(_carry(rng, N_SLOTS * NB, channels,
                                    kind)).to(cuda_device)
    geometry = _geometry(host_wire, kind, hashed, base)
    step = ops.make_fold_step(**geometry, device=cuda_device)
    want_c, want_s = fused_streaming_fold_ref(
        rows, carry, None if host_wire else 2, **geometry)
    got = carry.clone()
    before = ops.fold.launches
    _, got_s = _call(step, rows, got, host_wire)
    torch.cuda.synchronize()
    assert ops.fold.launches == before + 1
    assert torch.equal(got, want_c) and torch.equal(got_s, want_s)
    others = [c for c in range(channels) if c not in (base, base + 1)]
    assert torch.equal(got[:, others], carry[:, others])


@pytest.mark.cuda
def test_unaligned_carry_takes_the_scalar_pair(cuda_device):
    """A carry that starts 4 bytes off an 8-byte boundary cannot take the
    paired reduction even at C = 2: the launch picks the scalar pair, and
    the fold is still exact."""
    rng = np.random.default_rng(61)
    rows = torch.from_numpy(_rows(rng, 1 << 16, host_wire=False,
                                  keymax=NB)).to(cuda_device)
    flat = torch.from_numpy(_carry(rng, N_SLOTS * NB * 2 + 1, 1, "sum")
                            ).to(cuda_device).reshape(-1)
    carry = flat[1:].view(N_SLOTS * NB, 2)
    assert carry.is_contiguous() and carry.data_ptr() % 8 == 4
    head = flat[:1].clone()
    geometry = _geometry(False, "sum")
    want_c, want_s = fused_streaming_fold_ref(rows, carry, 2, **geometry)
    _, got_s = ops.make_fold_step(**geometry, device=cuda_device)(
        rows, carry, 2)
    torch.cuda.synchronize()
    assert torch.equal(carry, want_c) and torch.equal(got_s, want_s)
    assert torch.equal(flat[:1], head)        # the float before it untouched


def _device_records_in(prof, label):
    """The device records that the CUDA calls made inside the
    ``record_function(label)`` ranges of ``prof`` queued, matched to those
    calls by CUPTI correlation id (a record's timestamp may fall outside
    the range of the call that queued it)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    ranges = [(ev.start_ns(), ev.end_ns()) for ev in events
              if ev.name() == label and ev.device_type() == DeviceType.CPU]
    calls = {ev.correlation_id() for ev in events
             if ev.device_type() == DeviceType.CPU
             and ev.name().startswith("cu")
             and any(lo <= ev.start_ns() <= hi for lo, hi in ranges)}
    calls.discard(0)
    return [ev.name() for ev in events
            if ev.device_type() == DeviceType.CUDA
            and ev.correlation_id() in calls]


@pytest.mark.cuda
def test_one_device_operation_a_fold(cuda_device):
    """Under torch.profiler, folds of every kind put one record on the
    device each — the kernel: no fill of the stats, no fill of the min /
    max scratch, no second kernel.  Every kind's folds run in one profiler
    session, warmed first (unlabelled folds of every kind at the session's
    start: a session's first milliseconds have come back without device
    records), each kind's in ``record_function`` ranges of its own, and
    each fold must have exactly its one record."""
    from torch.profiler import ProfilerActivity, profile, record_function
    rng = np.random.default_rng(67)
    rows = torch.from_numpy(_rows(rng, 1 << 16, host_wire=False,
                                  keymax=NB)).to(cuda_device)
    steps = {}
    for kind in FOLD_KINDS:
        carry = torch.from_numpy(_carry(rng, N_SLOTS * NB, 2,
                                        kind)).to(cuda_device)
        step = ops.make_fold_step(**_geometry(False, kind),
                                  device=cuda_device)
        steps[kind] = (step, carry)
        step(rows, carry, 2)
    torch.cuda.synchronize()
    folds = 5
    before = ops.fold.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for step, carry in steps.values():
            for _ in range(folds):
                step(rows, carry, 2)
        torch.cuda.synchronize()
        for kind, (step, carry) in steps.items():
            for _ in range(folds):
                with record_function(f"fold {kind}"):
                    step(rows, carry, 2)
            torch.cuda.synchronize()
    assert ops.fold.launches == before + 2 * folds * len(steps)
    for kind in steps:
        records = _device_records_in(prof, f"fold {kind}")
        assert len(records) == folds, (kind, records)
        assert all("fold_kernel" in name for name in records), records


@pytest.mark.cuda
def test_stats_stay_fresh_across_a_deferred_drain(cuda_device):
    """Several folds' stats kept on the card and read together at the
    end, as the coordinator drains them at a barrier: each holds its own
    fold's counters, equal to the plain version's fold by fold."""
    rng = np.random.default_rng(71)
    geometry = _geometry(False, "sum")
    step = ops.make_fold_step(**geometry, device=cuda_device)
    carry = torch.zeros((N_SLOTS * NB, 2), device=cuda_device)
    plain = carry.clone()
    kept, want = [], []
    for i, n in enumerate((1000, 70000, 5, 30000)):
        rows = torch.from_numpy(_rows(rng, n, host_wire=False,
                                      keymax=NB)).to(cuda_device)
        plain, s = fused_streaming_fold_ref(rows, plain, i, **geometry)
        want.append(s)
        kept.append(step(rows, carry, i)[1])
    assert len({s.data_ptr() for s in kept}) == len(kept)
    assert torch.stack(kept).tolist() == torch.stack(want).tolist()
    assert torch.equal(carry, plain)


@pytest.mark.cuda
def test_refused_launch_raises_kernel_error(cuda_device):
    """A cooperative grid larger than the card can hold at once is
    refused by CUDA: the step raises ``KernelError`` and counts no
    launch, and the next fold (within the limit) is exact."""
    rng = np.random.default_rng(73)
    geometry = _geometry(False, "count")
    step = ops.make_fold_step(**geometry, device=cuda_device)
    rows = torch.from_numpy(_rows(rng, 1 << 21, host_wire=False,
                                  keymax=NB)).to(cuda_device)
    carry = torch.zeros((N_SLOTS * NB, 2), device=cuda_device)
    step(rows[:10], carry.clone(), 2)                  # binds the geometry
    limit = step.geometry.max_blocks
    assert limit > 0
    step.geometry.max_blocks = 1 << 20
    before = ops.fold.launches
    try:
        with pytest.raises(KernelError, match="launch failed"):
            step(rows, carry, 2)
    finally:
        step.geometry.max_blocks = limit
    assert ops.fold.launches == before
    want_c, want_s = fused_streaming_fold_ref(rows, carry, 2, **geometry)
    _, got_s = step(rows, carry, 2)
    torch.cuda.synchronize()
    assert torch.equal(carry, want_c) and torch.equal(got_s, want_s)


@pytest.mark.cuda
def test_step_for_another_device_refuses(cuda_device):
    """A step made for the CPU refuses card tensors (its plan put the
    carry elsewhere), and a step made for the card runs the plain
    version on CPU tensors, as ``fold`` does."""
    geometry = _geometry(False, "sum")
    rows = torch.zeros((4, 5), device=cuda_device)
    carry = torch.zeros((N_SLOTS * NB, 2), device=cuda_device)
    with pytest.raises(ValueError, match="made for cpu"):
        ops.make_fold_step(**geometry, device="cpu")(rows, carry, 0)
    before = ops.fold.launches
    step = ops.make_fold_step(**geometry, device=cuda_device)
    step(rows.cpu(), carry.cpu(), 0)
    assert ops.fold.launches == before
