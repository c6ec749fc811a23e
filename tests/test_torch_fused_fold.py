"""The port's fused streaming fold against the reference, bit for bit.

The same wire rows and carry, made from a numpy seed, go through the
reference's XLA oracle (``repro.kernels.fused_fold.ref``), its Pallas
kernel in interpret mode, and the port's plain PyTorch version — the
version the port's wrapper runs for CPU tensors and ``chip_smoke.py``
holds the CUDA kernel against on the card.  Values are integers, so
float32 sums are exact in any order and every comparison is exact
(tolerance zero).  The murmur hash and the floor-mod slot rule are pinned
on their edge cases.  The CUDA kernel itself runs only on a card: its
tests carry the ``cuda`` marker and skip here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import stages as jstages
from repro.kernels.fused_fold.kernel import fused_streaming_fold
from repro.kernels.fused_fold.ref import (
    fused_streaming_fold_ref as jax_fold_ref, murmur_bucket as jax_murmur)

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.engine import stages
from repro_torch.kernels.fused_fold import ops
from repro_torch.kernels.fused_fold.ref import (
    fused_streaming_fold_ref, murmur_bucket)

N_SLOTS, NB, FANOUT = 6, 16, 4
EDGE_KEYS = [0, -1, 1, (1 << 24) - 1, 1 << 24, -(2 ** 31), 2 ** 31 - 1,
             12345, -987654]


def _rows(rng, n, *, host_wire, keymax):
    """Integer-valued wire rows; device-wire window indices reach below
    zero (the start of a sliding stream) and below ``min_window`` (late)."""
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
    if kind in ("min", "max"):      # the carry contract: count 0 -> value 0
        for b in range(0, channels, 2):
            carry[:, b] = np.where(carry[:, b + 1] > 0, carry[:, b], 0.0)
    return carry


CASES = [(hw, kind, hashed, 0, 2) for hw in (False, True)
         for kind in ("sum", "count", "min", "max")
         for hashed in (False, True)] + [(False, "sum", False, 2, 4),
                                          (False, "max", True, 2, 4)]


@pytest.mark.parametrize(
    "host_wire,kind,hashed,base,channels", CASES,
    ids=[f"{'host' if c[0] else 'device'}-{c[1]}-"
         f"{'hashed' if c[2] else 'dense'}-base{c[3]}" for c in CASES])
def test_plain_fold_matches_reference_and_pallas(host_wire, kind, hashed,
                                                 base, channels):
    rng = np.random.default_rng(7)
    keymax = (1 << 24) if hashed else NB
    rows = _rows(rng, 300, host_wire=host_wire, keymax=keymax)
    carry = _carry(rng, N_SLOTS * NB, channels, kind)
    kw = dict(fanout=1 if host_wire else FANOUT, n_slots=N_SLOTS,
              num_buckets=NB, carry_buckets=NB, channel_base=base,
              hashed=hashed, host_wire=host_wire, kind=kind)
    minw = None if host_wire else 2
    want_c, want_s = jax_fold_ref(jnp.asarray(rows), jnp.asarray(carry),
                                  minw, **kw)
    pal_c, pal_s = fused_streaming_fold(jnp.asarray(rows),
                                        jnp.asarray(carry), minw,
                                        block_n=128, interpret=True, **kw)
    t_rows, t_carry = torch.from_numpy(rows), torch.from_numpy(carry)
    got_c, got_s = fused_streaming_fold_ref(t_rows, t_carry, minw, **kw)
    assert torch.equal(t_carry, torch.from_numpy(carry))   # functional
    for ref_c, ref_s in ((want_c, want_s), (pal_c, pal_s)):
        assert np.array_equal(got_c.numpy(), np.asarray(ref_c))
        assert np.array_equal(got_s.numpy(), np.asarray(ref_s))
    if not host_wire:
        assert int(got_s[0]) > 0                # late pairs were exercised
    # the wrapper on CPU tensors: the same bytes, written in place
    before = ops.fold.launches
    out_c, out_s = ops.fold(t_rows, t_carry, minw, **kw)
    assert out_c is t_carry
    assert torch.equal(out_c, got_c) and torch.equal(out_s, got_s)
    assert ops.fold.launches == before          # no kernel ran on the CPU


def test_negative_windows_use_floor_mod():
    """Sliding windows near the stream start are negative (at ts=10 with
    size 300 / slide 60 the first window is -4); their ring slot is the
    floor mod.  A truncating mod (C's ``%``, ``torch.fmod``) would give a
    negative slot and a flat id outside the carry."""
    rows = np.array([[-1, 5, 3, 7, 1]], np.float32)  # windows -1 .. -5
    carry = torch.zeros(N_SLOTS * NB, 2)
    new, stats = fused_streaming_fold_ref(
        torch.from_numpy(rows), carry, None, fanout=5, n_slots=N_SLOTS,
        num_buckets=NB, carry_buckets=NB)
    hit = sorted(int(i) // NB for i in torch.nonzero(new[:, 1])[:, 0])
    assert hit == sorted((w % N_SLOTS) for w in range(-5, 0))
    assert hit == [1, 2, 3, 4, 5]
    assert int(torch.fmod(torch.tensor(-1), N_SLOTS)) == -1   # the trap
    assert stats.tolist() == [0, 5, 0]
    want_c, _ = jax_fold_ref(jnp.asarray(rows), jnp.zeros((N_SLOTS * NB, 2)),
                             None, fanout=5, n_slots=N_SLOTS, num_buckets=NB,
                             carry_buckets=NB)
    assert np.array_equal(new.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("hashed", [False, True], ids=["dense", "hashed"])
def test_float_wire_values_truncate_toward_zero(hashed):
    """Window indices and keys travel as float32 and are cast to int the
    way the reference casts them: toward zero (-1.5 → -1, 2.7 → 2)."""
    rows = np.array([[2.7, 2.9, 3.6, 1, 1], [-1.5, 1, 5.2, 2, 1],
                     [0.9, 1.5, -0.7, 4, 1]], np.float32)
    kw = dict(fanout=3, n_slots=N_SLOTS, num_buckets=NB, carry_buckets=NB,
              hashed=hashed)
    new, stats = fused_streaming_fold_ref(
        torch.from_numpy(rows), torch.zeros(N_SLOTS * NB, 2), -1, **kw)
    want_c, want_s = jax_fold_ref(jnp.asarray(rows),
                                  jnp.zeros((N_SLOTS * NB, 2)), -1, **kw)
    assert np.array_equal(new.numpy(), np.asarray(want_c))
    assert stats.tolist() == np.asarray(want_s).tolist() == [0, 4, 0]


def test_murmur_and_host_bucket_bit_pins():
    """The int64 murmur (CPU torch has no uint32 shifts) matches the
    reference's uint32 ``device_hash``, its in-kernel ``murmur_bucket``
    and the host mirror ``host_bucket``, bit for bit, edge keys included."""
    rng = np.random.default_rng(19)
    keys = np.concatenate([np.array(EDGE_KEYS, np.int64),
                           rng.integers(-(2 ** 31), 2 ** 31, 4096)]
                          ).astype(np.int32)
    want_hash = np.asarray(jstages.device_hash(jnp.asarray(keys)))
    got_hash = stages.device_hash(torch.from_numpy(keys)).numpy()
    assert np.array_equal(got_hash, want_hash.astype(np.int64))
    for nb in (1, 7, 64, 1 << 20):
        want = np.asarray(jstages.bucketize(jnp.asarray(keys), nb,
                                            hashed=True))
        got = stages.bucketize(torch.from_numpy(keys), nb, hashed=True)
        assert np.array_equal(got.numpy(), want)
        host = [stages.host_bucket(int(k), nb) for k in keys[:64]]
        assert host == [jstages.host_bucket(int(k), nb) for k in keys[:64]]
        assert host == want[:64].tolist()
    # wire keys travel as float32 (24-bit raw ids are exact there)
    wire = keys[:4].astype(np.float32)
    assert np.array_equal(
        murmur_bucket(torch.from_numpy(wire), 64, True).numpy(),
        np.asarray(jax_murmur(jnp.asarray(wire), 64, True)))


def test_fold_key24_matches_reference():
    keys = ["1:0:17", "vehicle-3", "", "k" * 100, 42, "ñ"]
    assert [stages.fold_key24(k) for k in keys] == \
        [jstages.fold_key24(k) for k in keys]


def test_out_of_range_flat_ids_are_dropped_not_written():
    """A host-wire slot or dense key past the carry lands nowhere, as the
    reference's segment_sum drops it — and is still counted as folded."""
    rows = np.array([[N_SLOTS, 1, 5, 1], [0, NB * N_SLOTS, 5, 1],
                     [0, 2, 5, 1]], np.float32)
    carry = torch.zeros(N_SLOTS * NB, 2)
    new, stats = fused_streaming_fold_ref(
        torch.from_numpy(rows), carry, None, fanout=1, n_slots=N_SLOTS,
        num_buckets=NB, carry_buckets=NB, host_wire=True)
    assert stats.tolist() == [0, 3, 0]
    assert float(new.sum()) == 6.0 and new[2].tolist() == [5.0, 1.0]
    want_c, want_s = jax_fold_ref(
        jnp.asarray(rows), jnp.zeros((N_SLOTS * NB, 2)), None, fanout=1,
        n_slots=N_SLOTS, num_buckets=NB, carry_buckets=NB, host_wire=True)
    assert np.array_equal(new.numpy(), np.asarray(want_c))
    assert stats.tolist() == np.asarray(want_s).tolist()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(cuda_device):
    """On the card: the kernel against its plain version on the same
    tensors, across kinds, wires and key spaces — exact."""
    rng = np.random.default_rng(23)
    for host_wire, kind, hashed, base, channels in CASES:
        keymax = (1 << 24) if hashed else NB
        rows = torch.from_numpy(_rows(rng, 5000, host_wire=host_wire,
                                      keymax=keymax)).to(cuda_device)
        carry = torch.from_numpy(_carry(rng, N_SLOTS * NB, channels,
                                        kind)).to(cuda_device)
        kw = dict(fanout=1 if host_wire else FANOUT, n_slots=N_SLOTS,
                  num_buckets=NB, carry_buckets=NB, channel_base=base,
                  hashed=hashed, host_wire=host_wire, kind=kind)
        want_c, want_s = fused_streaming_fold_ref(rows, carry, 2, **kw)
        before = ops.fold.launches
        got_c, got_s = ops.fold(rows, carry.clone(), 2, **kw)
        torch.cuda.synchronize()
        assert ops.fold.launches == before + 1
        assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)
