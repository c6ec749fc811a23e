"""The port's selective scan (``repro_torch.kernels.mamba_scan``) against
the reference.

On the CPU: the plain version ``selective_scan_ref`` against the
reference's oracle (``repro/kernels/mamba_scan/ref.py``) at ragged L with
and without an initial state, and against its Pallas kernel
``selective_scan`` run with ``interpret=True`` (as ``tests/test_kernels.py``
runs it) on the shapes that kernel accepts; ``decode_step`` against the
reference's and a decode loop against the full scan; then the wrapper's
routing (CPU tensors count no launch; any other tensor goes to the kernel
or raises), its argument checks and strided B/C views, and its reading of
the library's chunk geometry.  A numpy emulation of the kernel's
time-parallel decomposition (lane segments, the scan of (P, h) over a
channel's lanes, the chunk carry, the re-walk) is held against the plain
version and the reference's oracle at lengths on its seams.  The CUDA
kernel itself runs only on the card: its tests carry the ``cuda`` marker
and skip here.

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
    # One torch thread: in a fresh test process (this is the first torch
    # call of the file), torch.exp's first parallel call has computed one
    # of its thread chunks about 1e-4 off, while the same call repeated is
    # exact; the comparison is of the arithmetic, not of torch's threads.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        y, h = selective_scan_ref(*ts)
    finally:
        torch.set_num_threads(threads)
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
    strides of B and C as 64-bit integers; the geometry and occupancy
    queries take three int pointers and a dtype code."""
    class Fn:
        argtypes = None
        restype = None

    class Lib:
        mamba_scan_launch = Fn()
        mamba_scan_tile = Fn()
        mamba_scan_blocks_per_sm = Fn()

    monkeypatch.setattr(ops, "load_library", lambda name: Lib())
    lib = ops.library()
    fn = lib.mamba_scan_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    assert fn.argtypes == [p] * 8 + [i] * 4 + [ll] * 4 + [i, p]
    assert fn.restype is ctypes.c_int
    assert lib.mamba_scan_tile.argtypes == [ctypes.POINTER(i)] * 3
    assert lib.mamba_scan_blocks_per_sm.argtypes == [i]
    assert lib.mamba_scan_blocks_per_sm.restype is ctypes.c_int


def test_scan_tile_and_occupancy_are_read_from_the_library(monkeypatch):
    """``scan_tile`` returns what the library writes through its three
    pointers, and ``blocks_per_sm`` passes the dtype code and raises on a
    negative answer (a CUDA error); a stand-in library here."""
    asked = []

    class Lib:
        @staticmethod
        def mamba_scan_tile(channels, items, chunk):
            channels[0], items[0], chunk[0] = 8, 4, 128

        @staticmethod
        def mamba_scan_blocks_per_sm(code):
            asked.append(code)
            return -2 if code == 1 else 3

    monkeypatch.setattr(ops, "library", lambda: Lib())
    assert ops.scan_tile() == (8, 4, 128)
    assert ops.blocks_per_sm(torch.float32) == 3
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        ops.blocks_per_sm(torch.bfloat16)
    assert asked == [0, 1]


# ---------------------------------------------------------------------------
# The kernel's decomposition, emulated in numpy float32
# ---------------------------------------------------------------------------

def _emulate_kernel(u, delta, a, bm, cm, dv, *, items, lanes=8):
    """What ``csrc/mamba_scan.cu`` computes for each channel, step by step
    in float32: time in chunks of ``lanes * items`` steps; lane l of the
    channel's ``lanes`` owns ``items`` consecutive steps of a chunk and
    folds its factors into (P, h), lane 0 from the chunk's carry; an
    inclusive Hillis-Steele scan of (P, h) over the lanes (``lanes`` a power
    of two) and a shift give each lane its start state; the lanes walk
    their steps again from it, adding h·C to y; the last lane's last state
    is the next chunk's carry.  Steps past L enter as the identity.
    Returns (y (b, L, d), h_final (b, d, n))."""
    f = np.float32
    b, length, d = u.shape
    n = a.shape[1]
    chunk = lanes * items
    a2 = a * f(np.log2(np.e))
    carry = np.zeros((b, d, n), f)
    y = np.empty((b, length, d), f)
    for t0 in range(0, length, chunk):
        m = min(chunk, length - t0)

        def tile(x):       # (b, lanes, items, ...), zero past L
            out = np.zeros((b, chunk) + x.shape[2:], f)
            out[:, :m] = x[:, t0:t0 + m]
            return out.reshape((b, lanes, items) + x.shape[2:])

        dt, du = tile(delta), tile(delta * u)
        b_t, c_t = tile(bm), tile(cm)
        d_a = np.exp2(dt[..., None] * a2)                # (b, l, i, d, n)
        d_bu = du[..., None] * b_t[:, :, :, None, :]
        p_seg = np.ones((b, lanes, d, n), f)
        h = np.zeros((b, lanes, d, n), f)
        h[:, 0] = carry
        for i in range(items):
            h = d_a[:, :, i] * h + d_bu[:, :, i]
            p_seg = p_seg * d_a[:, :, i]
        off = 1
        while off < lanes:
            h_new, p_new = h.copy(), p_seg.copy()
            h_new[:, off:] = p_seg[:, off:] * h[:, :-off] + h[:, off:]
            p_new[:, off:] = p_seg[:, off:] * p_seg[:, :-off]
            h, p_seg, off = h_new, p_new, 2 * off
        hs = np.concatenate([carry[:, None], h[:, :-1]], axis=1)
        y_t = np.zeros((b, lanes, items, d), f)
        for i in range(items):
            hs = d_a[:, :, i] * hs + d_bu[:, :, i]
            y_t[:, :, i] = np.einsum("bldn,bln->bld", hs, c_t[:, :, i])
        carry = hs[:, -1]
        y[:, t0:t0 + m] = (y_t.reshape(b, chunk, d)[:, :m]
                           + dv * u[:, t0:t0 + m])
    return y, carry


def _seam_length(seam: str, items: int, chunk: int) -> int:
    """A sequence length that puts L at one of the kernel's seams."""
    return {"one step": 1,
            "inside the first segment": max(1, items - 1),
            "a chunk less one": chunk - 1,
            "a chunk and one": chunk + 1,
            "two chunks and a segment and one": 2 * chunk + items + 1}[seam]


SEAMS = ["one step", "inside the first segment", "a chunk less one",
         "a chunk and one", "two chunks and a segment and one"]


@pytest.mark.parametrize("items", [1, 3, 8, 16])
@pytest.mark.parametrize("seam", SEAMS)
def test_time_parallel_decomposition_matches_plain_and_oracle(items, seam):
    """The kernel's decomposition (lane segments, the scan of (P, h) over
    a channel's 8 lanes, the chunk carry and the re-walk) in float32 equals
    the sequential scan: the plain version and the reference's oracle, at
    lengths on each seam and over segment sizes; 6 channels."""
    lanes = 8
    length = _seam_length(seam, items, lanes * items)
    arrays = _inputs(items * 1000 + length, 2, length, 6, 5)
    y, h = _emulate_kernel(*arrays, items=items, lanes=lanes)
    js, ts = _both(arrays, "float32")
    y_p, h_p = selective_scan_ref(*ts)
    y_r, h_r = jax_ref(*js)
    assert y.shape == (2, length, 6) and h.shape == (2, 6, 5)
    for want_y, want_h in ((y_p, h_p), (y_r, h_r)):
        np.testing.assert_allclose(y, _np(want_y), **F32)
        np.testing.assert_allclose(h, _np(want_h), **F32)


@pytest.mark.parametrize("lanes,items", [(2, 1), (4, 2), (8, 5), (32, 2)])
def test_decomposition_with_other_lane_counts_over_many_chunks(lanes,
                                                               items):
    """Other lane counts, up to a whole warp: many chunks, so the carry
    crosses 30 seams."""
    length = 31 * lanes * items + 3
    arrays = _inputs(lanes + items, 1, length, 3, 16)
    y, h = _emulate_kernel(*arrays, items=items, lanes=lanes)
    y_p, h_p = selective_scan_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(y, _np(y_p), **F32)
    np.testing.assert_allclose(h, _np(h_p), **F32)


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


@pytest.mark.cuda
@pytest.mark.parametrize("seam,dtype", [
    ("inside the first segment", "float32"),
    ("a chunk less one", "bfloat16"), ("a chunk and one", "float32"),
    ("two chunks and a segment and one", "bfloat16")])
def test_cuda_scan_at_the_kernel_seams(cuda_device, seam, dtype):
    """Lengths on the kernel's own seams (from the library's geometry),
    with D one channel past a whole number of blocks, so the last block
    has a single live warp and u's rows are not 16-byte aligned."""
    channels, items, chunk = ops.scan_tile()
    length = _seam_length(seam, items, chunk)
    d = 3 * channels + 1
    cast = getattr(torch, dtype)
    u, delta, a, bm, cm, dv = (torch.from_numpy(x).to(cuda_device)
                               for x in _inputs(length, 2, length, d, 16))
    u, delta, bm, cm = (t.to(cast) for t in (u, delta, bm, cm))
    y, h = ops.scan(u, delta, a, bm, cm, dv)
    y_r, h_r = selective_scan_ref(u, delta, a, bm, cm, dv)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_r.float(),
                               **(F32 if dtype == "float32" else BF16))
    torch.testing.assert_close(h, h_r, **F32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_two_blocks_fit_an_sm(cuda_device, dtype):
    """The chunk geometry leaves room for two blocks an SM (shared memory
    and registers); a channel's lanes, chunk / items, divide a warp."""
    channels, items, chunk = ops.scan_tile()
    lanes = chunk // items
    assert lanes * items == chunk and 32 % lanes == 0
    assert ops.blocks_per_sm(dtype) >= 2
