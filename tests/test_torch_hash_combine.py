"""The port's hash_combine against the reference's.

The same keys, values and valid mask, made from a numpy seed, go through
the reference's XLA oracle (``repro.kernels.hash_combine.ref``), its
Pallas kernel in interpret mode, and the port's wrapper on CPU tensors —
its plain PyTorch version, which ``chip_smoke.py`` holds the CUDA kernel
against on the card.  Integer-valued float32 sums below 2**24 are exact in
any order, so those comparisons are exact; real-valued float32 sums are
compared at rtol 1e-5, the reference's own kernel tolerance
(``tests/test_kernels.py``); bfloat16 at rtol 2e-2, since the reference
rounds its bfloat16 sums at other places than the port (which sums in
float32 and rounds once).  The CUDA kernel itself runs only on a card:
its tests carry the ``cuda`` marker and skip here.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.hash_combine.kernel import hash_combine as jax_pallas
from repro.kernels.hash_combine.ref import hash_combine_ref as jax_ref

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.engine import stages
from repro_torch.kernels.hash_combine import ops
from repro_torch.kernels.hash_combine.ref import hash_combine_ref

SWEEP = [(256, 1, 32, 128), (1000, 4, 64, 512), (4096, 16, 256, 512),
         (777, 8, 128, 256)]


def _inputs(rng, n, d, buckets, *, spill=0, integer=True):
    """Keys in ``[-spill, buckets + spill)`` (``spill > 0``: some outside
    the bucket range), values ``(n, d)`` (``(n,)`` when ``d == 1``), about
    20% invalid rows."""
    keys = rng.integers(-spill, buckets + spill, n).astype(np.int32)
    vals = (rng.integers(-9, 10, (n, d)) if integer
            else rng.normal(size=(n, d))).astype(np.float32)
    if d == 1:
        vals = vals[:, 0]
    valid = rng.random(n) > 0.2
    return keys, vals, valid


def _port(keys, vals, buckets, valid):
    return ops.combine(torch.from_numpy(keys), torch.from_numpy(vals),
                       buckets, None if valid is None
                       else torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("n,d,buckets,block_n", SWEEP)
@pytest.mark.parametrize("integer", [True, False],
                         ids=["integer", "real"])
def test_plain_matches_reference_and_pallas(n, d, buckets, block_n, integer):
    rng = np.random.default_rng(n + d)
    keys, vals, valid = _inputs(rng, n, d, buckets, integer=integer)
    got = _port(keys, vals, buckets, valid)
    want = np.asarray(jax_ref(jnp.asarray(keys), jnp.asarray(vals), buckets,
                              jnp.asarray(valid)))
    pallas = np.asarray(jax_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(valid), num_buckets=buckets,
                                   block_n=block_n, interpret=True))
    assert got.shape == want.shape == pallas.shape
    if integer:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [1, 4])
def test_out_of_range_keys_are_dropped(d):
    """Keys below 0 or at/above the bucket count match no bucket in the
    reference's oracle and its kernel; the port drops them too."""
    rng = np.random.default_rng(3)
    keys, vals, valid = _inputs(rng, 900, d, 40, spill=15)
    assert (keys < 0).any() and (keys >= 40).any()
    got = _port(keys, vals, 40, valid)
    want = np.asarray(jax_ref(jnp.asarray(keys), jnp.asarray(vals), 40,
                              jnp.asarray(valid)))
    pallas = np.asarray(jax_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                   jnp.asarray(valid), num_buckets=40,
                                   block_n=128, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    # and against a plain loop
    loop = np.zeros((40,) + vals.shape[1:], np.float32)
    for k, v, ok in zip(keys, vals, valid):
        if ok and 0 <= k < 40:
            loop[k] += v
    np.testing.assert_array_equal(got, loop)


def test_without_a_mask_every_row_counts():
    rng = np.random.default_rng(4)
    keys, vals, _ = _inputs(rng, 500, 1, 16)
    got = _port(keys, vals, 16, None)
    np.testing.assert_array_equal(
        got, np.asarray(jax_ref(jnp.asarray(keys), jnp.asarray(vals), 16)))


def test_invalid_rows_are_skipped_not_multiplied():
    """A NaN or inf in an invalid row never reaches the sum (the
    reference's oracle masks with ``where``; the port skips the row)."""
    rng = np.random.default_rng(5)
    keys, vals, valid = _inputs(rng, 300, 2, 8)
    vals[~valid] = np.nan
    vals[np.flatnonzero(~valid)[:3]] = np.inf
    got = _port(keys, vals, 8, valid)
    want = np.asarray(jax_ref(jnp.asarray(keys), jnp.asarray(vals), 8,
                              jnp.asarray(valid)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(512,), (512, 4)])
def test_bfloat16_matches_reference(shape):
    rng = np.random.default_rng(6)
    keys = rng.integers(0, 32, shape[0]).astype(np.int32)
    vals = rng.normal(size=shape).astype(np.float32)
    got = ops.combine(torch.from_numpy(keys),
                      torch.from_numpy(vals).to(torch.bfloat16), 32)
    assert got.dtype == torch.bfloat16
    jv = jnp.asarray(vals, jnp.bfloat16)
    # the port sums in float32 and rounds once, as the Pallas kernel does
    # within one 512-row tile; the reference's oracle sums in bfloat16, so
    # it is taken over the same bfloat16 values in float32 and rounded
    oracle = jax_ref(jnp.asarray(keys), jv.astype(jnp.float32), 32)
    for want in (oracle.astype(jnp.bfloat16),
                 jax_pallas(jnp.asarray(keys), jv, num_buckets=32,
                            interpret=True)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2e-2, atol=1e-2)


def test_int64_keys_are_cast_like_the_reference():
    """A UDF may hand back int64 keys; the wrapper casts them to int32 as
    the reference's batch body does."""
    rng = np.random.default_rng(7)
    keys, vals, valid = _inputs(rng, 400, 1, 24)
    got = ops.combine(torch.from_numpy(keys.astype(np.int64)),
                      torch.from_numpy(vals), 24, torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), _port(keys, vals, 24, valid))


def test_stage_combiners_resolve_to_the_kernel():
    assert stages.resolve_combine_fn(None) is stages.local_combine_dense
    assert stages.resolve_combine_fn("pallas") is stages.local_combine_dense
    assert ops.make_combine_fn() is ops.combine
    custom = lambda k, v, n, ok: v   # noqa: E731
    assert stages.resolve_combine_fn(custom) is custom
    with pytest.raises(ValueError, match="combine_fn"):
        stages.resolve_combine_fn("mxu")


def test_wrapper_rejects_mismatched_arguments():
    k, v = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    with pytest.raises(ValueError, match="keys must be"):
        ops.combine(k[None], v, 4)
    with pytest.raises(ValueError, match="values must be"):
        ops.combine(k, torch.zeros(7), 4)
    with pytest.raises(ValueError, match="valid must be"):
        ops.combine(k, v, 4, torch.ones(7, dtype=torch.bool))
    with pytest.raises(ValueError, match="num_buckets"):
        ops.combine(k, v, 0)
    with pytest.raises(ValueError, match="different devices"):
        ops.combine(k, torch.zeros(8, device="meta"), 4)


def test_non_cpu_tensor_never_reaches_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: with the
    kernel's library missing the call raises, and the plain version is
    never consulted (meta tensors stand in for CUDA ones here)."""
    def missing(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(ops, "load_library", missing)
    monkeypatch.setattr(ops, "hash_combine_ref", plain)
    keys = torch.zeros(16, dtype=torch.int32, device="meta")
    vals = torch.zeros(16, device="meta")
    before = ops.combine.launches
    with pytest.raises(OSError, match="cannot open"):
        ops.combine(keys, vals, 8)
    assert ops.combine.launches == before
    # a dtype the kernel does not take raises too, with the library there
    monkeypatch.setattr(ops, "library", lambda: None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.combine(keys, vals.to(torch.int32), 8)
    assert ops.combine.launches == before
    # the same call on CPU tensors is the plain version's to answer
    with pytest.raises(AssertionError, match="plain version ran"):
        ops.combine(torch.zeros(16, dtype=torch.int32), torch.zeros(16), 8)


def test_library_signature_passes_pointers_whole(monkeypatch):
    """ctypes must pass pointers and the stream as 64-bit values and the
    record count as a long long."""
    class Fn:
        argtypes = None
        restype = None

    class Lib:
        hash_combine_launch = Fn()

    monkeypatch.setattr(ops, "load_library", lambda name: Lib())
    fn = ops.library().hash_combine_launch
    p = ctypes.c_void_p
    assert fn.argtypes[:3] == [p, p, p] and fn.argtypes[7:] == [p, p, p]
    assert fn.argtypes[3] is ctypes.c_longlong
    assert fn.restype is ctypes.c_int


# ---------------------------------------------------------------------------
# On the card (skipped on a host without CUDA)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("d,buckets", [(1, 1000), (16, 4096), (1, 65536)])
def test_cuda_kernel_matches_plain_version(cuda_device, d, buckets):
    """Both the shared-memory path and the global-atomics path, with
    invalid rows and out-of-range keys: bit-identical on integer values."""
    rng = np.random.default_rng(buckets + d)
    keys, vals, valid = _inputs(rng, 1 << 16, d, buckets,
                                spill=buckets // 10)
    args = (torch.from_numpy(keys).to(cuda_device),
            torch.from_numpy(vals).to(cuda_device))
    mask = torch.from_numpy(valid).to(cuda_device)
    before = ops.combine.launches
    got = ops.combine(*args, buckets, mask)
    assert ops.combine.launches == before + 1
    want = hash_combine_ref(*args, buckets, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
