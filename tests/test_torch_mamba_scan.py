"""The port's selective scan (``repro_torch.kernels.mamba_scan``) against
the reference.

On the CPU: the plain version ``selective_scan_ref`` against the
reference's oracle (``repro/kernels/mamba_scan/ref.py``) at ragged L with
and without an initial state, and against its Pallas kernel
``selective_scan`` run with ``interpret=True`` (as ``tests/test_kernels.py``
runs it) on the shapes that kernel accepts; ``decode_step`` against the
reference's and a decode loop against the full scan; then the wrapper's
routing (CPU tensors count no launch; any other tensor goes to the kernel
or raises), its argument checks and strided B/C views.  The CUDA kernel
itself runs only on the card: its tests carry the ``cuda`` marker and skip
here.

Inputs follow ``tests/test_kernels.py``: Δ = |N(0, 1)|·0.1 + 0.01 and a
random negative A = -(|N(0, 1)| + 0.5), never the model's A = -(1..N).

Tolerances.  float32: rtol 1e-4, atol 1e-5 — both packages run the same
float32 recurrence with sums in other orders (observed under 1e-6).
bfloat16 inputs: both upcast to float32, add D·u in float32 and round y
once, so they differ by at most one bfloat16 step (2^-7 relative): rtol
1e-2, atol 1e-4.  The reference's Pallas kernel rounds d·u to bfloat16
(``kernel.py:49``) and adds D·u after rounding y (``kernel.py:106``), so
at bfloat16 it stands further from its own oracle: observed 0.031 on y
(one step at |y| near 9, more steps relative to y near 0) and 1.9e-3 on
h; pinned within atol 6.25e-2 + rtol 2^-6 on y and 5e-3 on h.  On the
card the kernel is held against the plain version at float32 within rtol
1e-4 and atol 1e-5 (exp2f against expf, 2 ulp a step, carried over the
state's memory of about 1/(Δ|A|) < 200 steps here), at bfloat16 as above.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro.kernels.mamba_scan.kernel import selective_scan as jax_pallas
from repro.kernels.mamba_scan.ops import decode_step as jax_decode_step
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_ref
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ops import decode_step
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-4)
PALLAS_BF16_Y = dict(rtol=2.0 ** -6, atol=6.25e-2)
PALLAS_BF16_H = dict(rtol=0.0, atol=5e-3)


def _inputs(seed, b, length, d, n):
    """u, delta, A, B, C, D as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, length, d)).astype(np.float32)
    delta = (np.abs(rng.normal(size=(b, length, d))) * 0.1
             + 0.01).astype(np.float32)
    a = -(np.abs(rng.normal(size=(d, n))) + 0.5).astype(np.float32)
    bm = rng.normal(size=(b, length, n)).astype(np.float32)
    cm = rng.normal(size=(b, length, n)).astype(np.float32)
    dv = rng.normal(size=(d,)).astype(np.float32)
    return u, delta, a, bm, cm, dv


def _both(arrays, dtype: str):
    """The inputs as JAX arrays and torch tensors, u, delta, B and C in
    ``dtype`` (A and D stay float32)."""
    js, ts = [], []
    for i, a in enumerate(arrays):
        cast = dtype if i in (0, 1, 3, 4) else "float32"
        js.append(jnp.asarray(a, getattr(jnp, cast)))
        ts.append(torch.from_numpy(a).to(getattr(torch, cast)))
    return js, ts


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,length,d,n,block_d,block_l", [
    (2, 128, 128, 8, 128, 64), (1, 128, 256, 16, 128, 128)])
def test_plain_matches_pallas_kernel_in_interpret_mode(b, length, d, n,
                                                       block_d, block_l):
    js, ts = _both(_inputs(length + d, b, length, d, n), "float32")
    y_k, h_k = jax_pallas(*js, block_d=block_d, block_l=block_l,
                          interpret=True)
    y, h = selective_scan_ref(*ts)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert tuple(h.shape) == (b, d, n)
    np.testing.assert_allclose(_np(y), _np(y_k), **F32)
    np.testing.assert_allclose(_np(h), _np(h_k), **F32)


@pytest.mark.parametrize("b,length,d,n", [  # within, across, past chunks
    (2, 77, 48, 16), (1, 130, 32, 4), (3, 1, 16, 8), (1, 200, 8, 1)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_matches_reference_oracle_at_ragged_length(b, length, d, n,
                                                         with_h0):
    arrays = _inputs(length * 7 + n, b, length, d, n)
    js, ts = _both(arrays, "float32")
    h0 = None
    if with_h0:
        h0 = np.random.default_rng(3).normal(size=(b, d, n)).astype(
            np.float32)
    y_r, h_r = jax_ref(*js, h0=None if h0 is None else jnp.asarray(h0))
    y, h = selective_scan_ref(*ts, h0=None if h0 is None else
                              torch.from_numpy(h0))
    np.testing.assert_allclose(_np(y), _np(y_r), **F32)
    np.testing.assert_allclose(_np(h), _np(h_r), **F32)


def test_plain_bfloat16_within_one_step_of_the_oracle():
    js, ts = _both(_inputs(11, 2, 128, 128, 8), "bfloat16")
    y_r, h_r = jax_ref(*js)
    y, h = selective_scan_ref(*ts)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(y_r), **BF16)
    np.testing.assert_allclose(_np(h), _np(h_r), **F32)


def test_pallas_kernel_stands_further_from_its_oracle_at_bfloat16():
    """The reference's Pallas kernel forms d·u in bfloat16 and adds D·u
    after rounding y; the port follows the oracle.  Pinned: the Pallas
    kernel's own distance from the oracle, and that the port is nearer."""
    js, ts = _both(_inputs(11, 2, 128, 128, 8), "bfloat16")
    y_r, h_r = jax_ref(*js)
    y_k, h_k = jax_pallas(*js, block_d=128, block_l=64, interpret=True)
    np.testing.assert_allclose(_np(y_k), _np(y_r), **PALLAS_BF16_Y)
    np.testing.assert_allclose(_np(h_k), _np(h_r), **PALLAS_BF16_H)
    y, h = selective_scan_ref(*ts)
    port_err = np.abs(_np(y) - _np(y_r)).max()
    pallas_err = np.abs(_np(y_k) - _np(y_r)).max()
    assert port_err < pallas_err
    assert np.abs(_np(h) - _np(h_r)).max() < np.abs(
        _np(h_k) - _np(h_r)).max()


def test_decode_step_matches_reference():
    rng = np.random.default_rng(4)
    b, d, n = 3, 32, 8
    u, delta, a, bm, cm, dv = _inputs(4, b, 1, d, n)
    h = rng.normal(size=(b, d, n)).astype(np.float32)
    args = (h, u[:, 0], delta[:, 0], a, bm[:, 0], cm[:, 0], dv)
    y_r, h_r = jax_decode_step(*map(jnp.asarray, args))
    y, h_new = decode_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(y), _np(y_r), **F32)
    np.testing.assert_allclose(_np(h_new), _np(h_r), **F32)


def test_decode_loop_equals_the_full_scan():
    """Running decode_step over a sequence equals the full scan — the
    invariant behind serving from a prefill's state."""
    b, length, d, n = 2, 40, 24, 16
    u, delta, a, bm, cm, dv = map(torch.from_numpy,
                                  _inputs(5, b, length, d, n))
    y_full, h_full = selective_scan_ref(u, delta, a, bm, cm, dv)
    h = torch.zeros((b, d, n))
    ys = []
    for t in range(length):
        y_t, h = decode_step(h, u[:, t], delta[:, t], a, bm[:, t], cm[:, t],
                             dv)
        ys.append(y_t)
    torch.testing.assert_close(torch.stack(ys, 1), y_full, **F32)
    torch.testing.assert_close(h, h_full, **F32)


def test_cpu_wrapper_runs_the_plain_version_and_counts_no_launch():
    ts = [torch.from_numpy(a) for a in _inputs(6, 2, 50, 16, 4)]
    before = ops.scan.launches
    y, h = ops.scan(*ts)
    y_r, h_r = selective_scan_ref(*ts)
    assert torch.equal(y, y_r) and torch.equal(h, h_r)
    assert ops.scan.launches == before


def test_strided_b_and_c_views_equal_contiguous_copies():
    """The model's B and C are column slices of the x_proj output, with a
    row stride of dt_rank + 2N: the wrapper gives the same result for the
    views as for contiguous copies."""
    b, length, d, n, rank = 2, 33, 16, 8, 4
    u, delta, a, _, _, dv = map(torch.from_numpy,
                                _inputs(7, b, length, d, n))
    dbc = torch.from_numpy(np.random.default_rng(8).normal(
        size=(b, length, rank + 2 * n)).astype(np.float32))
    _, bm, cm = torch.split(dbc, [rank, n, n], dim=-1)
    assert bm.stride() == (length * (rank + 2 * n), rank + 2 * n, 1)
    y, h = ops.scan(u, delta, a, bm, cm, dv)
    y_c, h_c = ops.scan(u, delta, a, bm.contiguous(), cm.contiguous(), dv)
    assert torch.equal(y, y_c) and torch.equal(h, h_c)


def test_wrapper_rejects_mismatched_arguments():
    u, delta, a, bm, cm, dv = map(torch.from_numpy, _inputs(9, 1, 8, 16, 4))
    with pytest.raises(ValueError, match="u and delta"):
        ops.scan(u, delta[:, :4], a, bm, cm, dv)
    with pytest.raises(ValueError, match="A must be"):
        ops.scan(u, delta, a[:8], bm, cm, dv)
    with pytest.raises(ValueError, match="B and C must be"):
        ops.scan(u, delta, a, bm[:, :, :2], cm, dv)
    with pytest.raises(ValueError, match="D must be"):
        ops.scan(u, delta, a, bm, cm, dv[:3])
    with pytest.raises(ValueError, match="different devices"):
        ops.scan(u, delta, a, bm, cm, dv.to("meta"))


def _meta(b, length, d, n, dtype=torch.float32, a_dtype=torch.float32):
    m = dict(device="meta")
    return (torch.zeros(b, length, d, dtype=dtype, **m),
            torch.zeros(b, length, d, dtype=dtype, **m),
            torch.zeros(d, n, dtype=a_dtype, **m),
            torch.zeros(b, length, n, dtype=dtype, **m),
            torch.zeros(b, length, n, dtype=dtype, **m),
            torch.zeros(d, **m))


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: with the
    kernel's library missing the call raises, and the plain version is
    never consulted (meta tensors stand in for CUDA ones here)."""
    def missing(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    monkeypatch.setattr(ops, "load_library", missing)
    monkeypatch.setattr(ops, "selective_scan_ref", plain)
    before = ops.scan.launches
    with pytest.raises(OSError, match="cannot open"):
        ops.scan(*_meta(1, 8, 32, 16))
    # inputs the kernel does not take raise before any launch
    with pytest.raises(ValueError, match="N <= 16"):
        ops.scan(*_meta(1, 8, 32, 17))
    with pytest.raises(ValueError, match="L >= 1"):
        ops.scan(*_meta(1, 0, 32, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.scan(*_meta(1, 8, 32, 16, dtype=torch.float16))
    mixed = list(_meta(1, 8, 32, 16))
    mixed[3] = mixed[3].to(torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        ops.scan(*mixed)
    with pytest.raises(TypeError, match="A and D in float32"):
        ops.scan(*_meta(1, 8, 32, 16, a_dtype=torch.bfloat16))
    assert ops.scan.launches == before
    # the same call on CPU tensors is the plain version's to answer
    with pytest.raises(AssertionError, match="plain version ran"):
        ops.scan(torch.zeros(1, 8, 32), torch.zeros(1, 8, 32),
                 torch.zeros(32, 16), torch.zeros(1, 8, 16),
                 torch.zeros(1, 8, 16), torch.zeros(32))


def test_library_signature_passes_pointers_and_strides_whole(monkeypatch):
    """ctypes must pass pointers and the stream as 64-bit values, and the
    strides of B and C as 64-bit integers."""
    class Fn:
        argtypes = None
        restype = None

    class Lib:
        mamba_scan_launch = Fn()

    monkeypatch.setattr(ops, "load_library", lambda name: Lib())
    fn = ops.library().mamba_scan_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert fn.argtypes == [p] * 8 + [i] * 4 + [ll] * 4 + [i, p]
    assert fn.restype is ctypes.c_int


# ---------------------------------------------------------------------------
# On the card (skipped on a host without CUDA)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,length,d,n,dtype,strided", [
    (1, 777, 1000, 16, "float32", True), (2, 63, 128, 8, "bfloat16", False),
    (4, 1, 8192, 4, "float32", False), (1, 300, 96, 16, "bfloat16", True)])
def test_cuda_scan_matches_plain_version(cuda_device, b, length, d, n,
                                         dtype, strided):
    u, delta, a, bm, cm, dv = (torch.from_numpy(x).to(cuda_device)
                               for x in _inputs(d + n, b, length, d, n))
    if strided:
        rank = 8
        dbc = torch.randn(b, length, rank + 2 * n, device=cuda_device)
        _, bm, cm = torch.split(dbc, [rank, n, n], dim=-1)
    cast = getattr(torch, dtype)
    u, delta, bm, cm = (t.to(cast) for t in (u, delta, bm, cm))
    before = ops.scan.launches
    y, h = ops.scan(u, delta, a, bm, cm, dv)
    assert ops.scan.launches == before + 1
    y_r, h_r = selective_scan_ref(u, delta, a, bm, cm, dv)
    torch.cuda.synchronize()
    assert y.dtype == cast and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_r.float(),
                               **(F32 if dtype == "float32" else BF16))
    torch.testing.assert_close(h, h_r, **F32)
