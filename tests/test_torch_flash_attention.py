"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the reference.

On the CPU: the plain versions (``mha_ref``, ``chunked_attention``,
``decode_ref``) against the reference's oracles and its Pallas kernels
``flash_attention`` / ``flash_decode`` run with ``interpret=True`` (as
``tests/test_kernels.py`` runs them), over GQA, causal and bidirectional
masks, sliding windows, the Gemma-2 softcap and bfloat16; then the
wrappers' routing (CPU tensors count no launch; any other tensor goes to
the kernel or raises) and argument checks.  The CUDA kernels themselves
run only on the card: their tests carry the ``cuda`` marker and skip here.

Tolerances.  float32: rtol 1e-4, atol 2e-5 — the reference's own bound for
its kernel against its oracle; the two frameworks sum the same float32
terms in other orders.  bfloat16 inputs: both packages compute in float32
and round the output to bfloat16 once, so they differ by at most one
bfloat16 step (at most 2^-7 relative): rtol 1e-2, atol 1e-4.  On the
card, bfloat16 kernel vs plain as in ``chip_smoke.py``: the forward rounds
P to bfloat16 before P V on the tensor cores (an absolute error up to
2^-9 max|v| per element), so atol 5e-3 + rtol 2e-2 and a relative L2
error of at most 5e-3; decode sums in float32 like its plain version,
so atol 1e-4 + rtol 1e-2 and the same relative L2 bound.
"""

import ctypes
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro.kernels.flash_attention.kernel import flash_attention, flash_decode
from repro.kernels.flash_attention.ops import \
    chunked_attention as jax_chunked
from repro.kernels.flash_attention.ref import decode_ref as jax_decode_ref
from repro.kernels.flash_attention.ref import mha_ref as jax_mha_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (chunked_attention,
                                                     decode_ref, mha_ref)

F32 = dict(rtol=1e-4, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-4)
CUDA_BF16 = {"forward": dict(rtol=2e-2, atol=5e-3),
             "decode": dict(rtol=1e-2, atol=1e-4)}
REL_L2_BF16 = 5e-3


def _assert_kernel_close(got, want, dtype, kernel):
    """Kernel vs plain on the card, element by element and as a whole."""
    got, want = got.float(), want.float()
    if dtype == "float32":
        torch.testing.assert_close(got, want, **F32)
        return
    torch.testing.assert_close(got, want, **CUDA_BF16[kernel])
    assert float((got - want).norm() / want.norm()) <= REL_L2_BF16


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


FWD_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window, cap
    (1, 4, 4, 256, 256, 64, True, None, None),
    (2, 8, 2, 256, 256, 32, True, None, None),        # GQA
    (1, 2, 1, 256, 256, 64, True, 128, None),         # sliding window
    (1, 4, 4, 256, 256, 64, True, None, 50.0),        # softcap (gemma2)
    (2, 4, 2, 256, 256, 64, False, None, None),       # bidirectional
    (1, 4, 2, 128, 384, 64, True, None, None),        # skv > sq
    (1, 4, 2, 256, 256, 32, True, 16, 50.0),          # gemma2's mix
    (1, 8, 1, 128, 256, 16, False, 32, 30.0),         # MQA, window, no mask
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,cap", FWD_CASES)
def test_plain_forward_matches_reference_and_pallas(b, hq, hkv, sq, skv, d,
                                                    causal, window, cap):
    rng = np.random.default_rng(sq + skv + d + hq)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, s), "float32")
        for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    kw = dict(causal=causal, window=window, softcap=cap)
    want = _np(jax_mha_ref(jq, jk, jv, **kw))
    pallas = _np(flash_attention(jq, jk, jv, interpret=True, **kw))
    np.testing.assert_allclose(pallas, want, **F32)
    np.testing.assert_allclose(_np(mha_ref(tq, tk, tv, **kw)), want, **F32)
    got = _np(chunked_attention(tq, tk, tv, chunk=64, **kw))
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, pallas, **F32)
    np.testing.assert_allclose(
        got, _np(jax_chunked(jq, jk, jv, chunk=64, **kw)), **F32)


def test_plain_forward_ragged_chunks_and_q_offset():
    """A last chunk shorter than the rest (the reference pads it) and a
    query block placed after a prefix (``q_offset``)."""
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, s), "float32")
        for s in ((1, 4, 40, 32), (1, 2, 100, 32), (1, 2, 100, 32)))
    kw = dict(causal=True, window=24, softcap=50.0, q_offset=60)
    want = _np(jax_mha_ref(jq, jk, jv, **kw))
    np.testing.assert_allclose(_np(mha_ref(tq, tk, tv, **kw)), want, **F32)
    np.testing.assert_allclose(
        _np(chunked_attention(tq, tk, tv, chunk=48, **kw)), want, **F32)


def test_fully_masked_rows_are_zero():
    """A query with no live key — placed before every key by a negative
    offset — writes 0, as the reference's oracle and kernel do."""
    rng = np.random.default_rng(3)
    tq, tk, tv = (torch.from_numpy(_normal(rng, s))
                  for s in ((1, 2, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    kw = dict(causal=True, window=1, q_offset=-4)
    for out in (mha_ref(tq, tk, tv, **kw),
                chunked_attention(tq, tk, tv, chunk=4, **kw)):
        assert torch.equal(out[:, :, :4], torch.zeros_like(out[:, :, :4]))
        assert out[:, :, 4:].abs().sum() > 0


def test_plain_forward_bfloat16_matches_reference():
    rng = np.random.default_rng(11)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, s), "bfloat16")
        for s in ((1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)))
    kw = dict(causal=True, window=64, softcap=50.0)
    got = chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jax_mha_ref(jq, jk, jv, **kw)),
                               **BF16)
    np.testing.assert_allclose(
        _np(got), _np(flash_attention(jq, jk, jv, interpret=True, **kw)),
        **BF16)


DECODE_CASES = [
    # b, hq, hkv, smax, d, window, cap
    (2, 8, 2, 1024, 64, None, None),
    (1, 4, 4, 512, 128, None, None),
    (2, 8, 4, 2048, 64, 512, None),                   # windowed decode
    (1, 16, 8, 1024, 64, None, 30.0),
    (3, 4, 2, 512, 32, 16, 50.0),                     # gemma2's mix
]


@pytest.mark.parametrize("b,hq,hkv,smax,d,window,cap", DECODE_CASES)
def test_plain_decode_matches_reference_and_pallas(b, hq, hkv, smax, d,
                                                   window, cap):
    rng = np.random.default_rng(smax + d + b)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, s), "float32")
        for s in ((b, hq, d), (b, hkv, smax, d), (b, hkv, smax, d)))
    lens = rng.integers(1, smax + 1, b).astype(np.int32)
    lens[0] = smax
    kw = dict(window=window, softcap=cap)
    want = _np(jax_decode_ref(jq, jk, jv, jnp.asarray(lens), **kw))
    pallas = _np(flash_decode(jq, jk, jv, jnp.asarray(lens), interpret=True,
                              **kw))
    np.testing.assert_allclose(pallas, want, **F32)
    got = decode_ref(tq, tk, tv, torch.from_numpy(lens), **kw)
    np.testing.assert_allclose(_np(got), want, **F32)
    np.testing.assert_allclose(_np(got), pallas, **F32)


def test_plain_decode_bfloat16_matches_reference():
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, s), "bfloat16")
        for s in ((2, 8, 64), (2, 4, 512, 64), (2, 4, 512, 64)))
    lens = np.array([512, 37], np.int32)
    kw = dict(window=128, softcap=50.0)
    got = decode_ref(tq, tk, tv, torch.from_numpy(lens), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(got), _np(jax_decode_ref(jq, jk, jv, jnp.asarray(lens), **kw)),
        **BF16)


def _length_zero_row():
    """The smallest input with a length-0 row: q (2, 4, 64), caches
    (2, 2, 128, 64), lengths [0, 5]."""
    rng = np.random.default_rng(12)
    q, k, v = (_normal(rng, s) for s in ((2, 4, 64), (2, 2, 128, 64),
                                         (2, 2, 128, 64)))
    return q, k, v, np.array([0, 5], np.int32)


@pytest.mark.parametrize("window", [None, 3])
def test_plain_decode_at_a_length_zero_row_matches_reference(window):
    """Outside the wrappers' contract (lengths >= 1): the plain version
    answers a row that attends to no key as the reference's decode_ref
    does, with the mean of V over every cache row; the other row is
    unaffected."""
    q, k, v, lens = _length_zero_row()
    want = _np(jax_decode_ref(*map(jnp.asarray, (q, k, v, lens)),
                              window=window))
    got = _np(decode_ref(*map(torch.from_numpy, (q, k, v, lens)),
                         window=window))
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got[0], np.repeat(v[0].mean(axis=1), 2, 0),
                               **F32)
    pallas = _np(flash_decode(*map(jnp.asarray, (q, k, v, lens)),
                              window=window, interpret=True))
    assert not pallas[0].any()
    np.testing.assert_allclose(got[1], pallas[1], **F32)


def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(_normal(rng, s))
               for s in ((1, 4, 96, 32), (1, 2, 96, 32), (1, 2, 96, 32)))
    before = (ops.attention.launches, ops.decode_attention.launches)
    got = ops.attention(q, k, v, causal=True, window=16, softcap=50.0)
    assert torch.equal(got, chunked_attention(q, k, v, causal=True,
                                              window=16, softcap=50.0))
    lens = torch.tensor([96], dtype=torch.int32)
    got = ops.decode_attention(q[:, :, 0], k, v, lens, window=16)
    assert torch.equal(got, decode_ref(q[:, :, 0], k, v, lens, window=16))
    # window 0 means global, as None does
    assert torch.equal(ops.attention(q, k, v, window=0),
                       ops.attention(q, k, v, window=None))
    assert (ops.attention.launches, ops.decode_attention.launches) == before


def test_wrappers_reject_mismatched_arguments():
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.attention(q, k, k)
    with pytest.raises(ValueError, match="attention wants"):
        ops.attention(q[0], k, k)
    with pytest.raises(ValueError, match="differ in batch or head dim"):
        ops.attention(q, torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8))
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="different devices"):
        ops.attention(q, kv, torch.zeros(1, 2, 8, 16, device="meta"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError, match="mixed dtypes"):
        ops.attention(q, kv.to(torch.bfloat16), kv)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.decode_attention(q[:, :, 0], k, k, lens)
    with pytest.raises(ValueError, match="lengths must be"):
        ops.decode_attention(q[:, :, 0], kv, kv, torch.ones(2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.decode_attention(q[:, :, 0].half(), kv.half(), kv.half(), lens)
    with pytest.raises(ValueError, match="different devices"):
        ops.decode_attention(q[:, :, 0], kv, kv, lens.to("meta"))


def test_non_cpu_tensors_never_reach_the_plain_versions(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel: with the
    kernels' library missing the call raises, and the plain versions are
    never consulted (meta tensors stand in for CUDA ones here)."""
    def missing(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran for a non-CPU tensor")

    monkeypatch.setattr(ops, "load_library", missing)
    monkeypatch.setattr(ops, "chunked_attention", plain)
    monkeypatch.setattr(ops, "decode_ref", plain)
    q = torch.zeros(1, 4, 8, 64, device="meta")
    kv = torch.zeros(1, 2, 8, 64, device="meta")
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    before = (ops.attention.launches, ops.decode_attention.launches)
    with pytest.raises(OSError, match="cannot open"):
        ops.attention(q, kv, kv)
    with pytest.raises(OSError, match="cannot open"):
        ops.decode_attention(q[:, :, 0], kv, kv, lens)
    # shapes the kernels do not take raise before any launch
    big = torch.zeros(1, 2, 8, 320, device="meta")
    with pytest.raises(ValueError, match="head_dim <= 256"):
        ops.attention(big, big, big)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        ops.decode_attention(big[:, :, 0], big, big, lens)
    with pytest.raises(ValueError, match="groups of at most 8"):
        ops.decode_attention(torch.zeros(1, 9, 64, device="meta"),
                             kv[:, :1], kv[:, :1], lens)
    assert (ops.attention.launches, ops.decode_attention.launches) == before
    # the same calls on CPU tensors are the plain versions' to answer
    with pytest.raises(AssertionError, match="plain version ran"):
        ops.attention(torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64),
                      torch.zeros(1, 2, 8, 64))
    with pytest.raises(AssertionError, match="plain version ran"):
        ops.decode_attention(torch.zeros(1, 4, 64), torch.zeros(1, 2, 8, 64),
                             torch.zeros(1, 2, 8, 64), torch.ones(1))


def test_library_signatures_pass_pointers_whole(monkeypatch):
    """ctypes must pass pointers and the stream as 64-bit values, the
    softcap and scale as floats."""
    class Fn:
        argtypes = None
        restype = None

    class Lib:
        flash_attention_fwd_launch = Fn()
        flash_attention_fwd_tile = Fn()
        flash_decode_launch = Fn()

    monkeypatch.setattr(ops, "load_library", lambda name: Lib())
    lib = ops.library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, dec = lib.flash_attention_fwd_launch, lib.flash_decode_launch
    tile = lib.flash_attention_fwd_tile
    assert fwd.argtypes == [p] * 4 + [i] * 9 + [f, f, p]
    assert dec.argtypes == [p] * 8 + [i] * 7 + [f, f, i, p]
    assert tile.argtypes == [i, i] + [ctypes.POINTER(i)] * 3
    assert fwd.restype is ctypes.c_int and dec.restype is ctypes.c_int
    assert tile.restype is ctypes.c_int


@pytest.mark.parametrize("b,hkv,smax,want", [
    (1, 8, 8320, 33), (4, 8, 8320, 9), (8, 8, 128, 2), (1, 1, 64, 1),
    (64, 8, 8320, 1)])
def test_decode_splits_fill_the_card_without_short_splits(b, hkv, smax, want):
    assert ops.n_splits_for(b, hkv, smax, sms=132) == want


@pytest.mark.parametrize("dtype,d,reported", [
    (torch.bfloat16, 256, (128, 80, 2)), (torch.float32, 64, None)])
def test_forward_kernel_is_named_from_the_librarys_tile(monkeypatch, dtype,
                                                        d, reported):
    """``forward_tile`` passes the head dim and dtype code to the library
    and reads the tile it writes back; ``forward_kernel`` names fwd_wgmma
    exactly where the library reports a tile (a stand-in library here)."""
    asked = []

    def fwd_tile(head_dim, code, rows, keys, stages):
        asked.append((head_dim, code))
        if reported is None:
            return 0
        rows[0], keys[0], stages[0] = reported
        return 1

    class Lib:
        flash_attention_fwd_tile = staticmethod(fwd_tile)

    monkeypatch.setattr(ops, "library", lambda: Lib())
    assert ops.forward_tile(dtype, d) == reported
    assert ops.forward_kernel(dtype, d) == (
        "fwd_rows" if reported is None else "fwd_wgmma")
    assert asked == [(d, ops._DTYPE_CODE[dtype])] * 2


def test_tma_ready_copies_only_unaligned_or_strided_tensors():
    base = torch.arange(4 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:256].view(4, 64)
    assert aligned.data_ptr() % ops.TMA_ALIGN == 0
    assert ops._tma_ready(aligned).data_ptr() == aligned.data_ptr()
    shifted = base[1:257].view(4, 64)          # starts 2 bytes in
    assert shifted.data_ptr() % ops.TMA_ALIGN
    ready = ops._tma_ready(shifted)
    assert ready.data_ptr() % ops.TMA_ALIGN == 0
    assert ready.is_contiguous() and torch.equal(ready, shifted)
    strided = aligned.t()
    ready = ops._tma_ready(strided)
    assert ready.is_contiguous() and torch.equal(ready, strided)


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19fwd_wgmmaILi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_19fwd_wgmmaILi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem, 1000 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8fwd_rowsPf' for 'sm_90a'
ptxas info    : Function properties for _Z8fwd_rowsPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 360 bytes cmem[0]
"""


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    usage = _build.ptxas_usage(PTXAS_REPORT)
    wgmma = next(v for k, v in usage.items() if "fwd_wgmmaILi256E" in k)
    assert wgmma == {"registers": 168, "spill_stores": 0, "spill_loads": 0}
    assert usage["_Z8fwd_rowsPf"] == {"registers": 255, "spill_stores": 4,
                                      "spill_loads": 12}
    assert _build.ptxas_usage("") == {}


def test_build_keeps_the_compilers_report_beside_the_library(monkeypatch,
                                                             tmp_path):
    """The build passes ``-Xptxas=-v`` and keeps what the compiler said
    next to the library it made (a stand-in compiler here)."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "args = sys.argv[1:]\n"
        "assert '-Xptxas=-v' in args and 'arch=compute_90a,code=sm_90a' "
        "in args\n"
        "open(args[args.index('-o') + 1], 'w').write('library')\n"
        f"sys.stderr.write({PTXAS_REPORT!r})\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    assert _build.build_log("flash_attention") == ""
    lib = _build.build("flash_attention")
    assert lib.read_text() == "library"
    assert _build.build_log("flash_attention") == PTXAS_REPORT
    assert "fwd_wgmmaILi256E" in next(iter(_build.ptxas_usage(
        _build.build_log("flash_attention"))))


# ---------------------------------------------------------------------------
# On the card (skipped on a host without CUDA)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,sq,skv,causal,window,cap", [
    ("bfloat16", 256, 333, 333, True, 16, 50.0),
    ("bfloat16", 128, 333, 333, False, None, None),
    ("bfloat16", 96, 333, 333, True, 64, 30.0),
    ("float32", 64, 333, 333, True, None, 50.0),
    # fwd_wgmma: ragged Sq and Skv, windows below and above a key tile
    ("bfloat16", 64, 1000, 777, True, 16, 50.0),
    ("bfloat16", 64, 777, 1000, False, None, None),
    ("bfloat16", 128, 1000, 1000, True, 4096, None),
    ("bfloat16", 128, 129, 333, True, 16, 50.0),
    ("bfloat16", 256, 1000, 1000, True, 4096, 50.0),
    ("bfloat16", 256, 300, 10, True, 16, None),
    ("bfloat16", 256, 333, 777, False, None, 50.0)])
def test_cuda_forward_matches_plain_version(cuda_device, dtype, d, sq, skv,
                                            causal, window, cap):
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(_normal(rng, s)).to(cuda_device,
                                                    getattr(torch, dtype))
               for s in ((2, 8, sq, d), (2, 4, skv, d), (2, 4, skv, d)))
    kw = dict(causal=causal, window=window, softcap=cap)
    before = ops.attention.launches
    got = ops.attention(q, k, v, **kw)
    assert ops.attention.launches == before + 1
    want = chunked_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_kernel_close(got, want, dtype, "forward")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "fwd_wgmma"), (torch.bfloat16, 128, "fwd_wgmma"),
    (torch.bfloat16, 256, "fwd_wgmma"), (torch.bfloat16, 96, "fwd_rows"),
    (torch.bfloat16, 32, "fwd_rows"), (torch.float32, 64, "fwd_rows"),
    (torch.float32, 256, "fwd_rows")])
def test_forward_kernel_by_dtype_and_head_dim(cuda_device, dtype, d, want):
    """bfloat16 at 64, 128 and 256 goes to the TMA/wgmma kernel; float32
    and other head dims to the float32 FMA kernel."""
    assert ops.forward_kernel(dtype, d) == want


@pytest.mark.cuda
def test_wgmma_tiles_fit_shared_memory(cuda_device):
    """The tiles the library reports: Q's tile plus both rings fit the 227
    KB a block may use at every head dim, and each suits wgmma and the
    128-byte swizzle."""
    for d in (64, 128, 256):
        rows, keys, stages = ops.forward_tile(torch.bfloat16, d)
        smem = 1024 + rows * d * 2 + 2 * stages * keys * d * 2 + 8 * (
            1 + 4 * stages)
        assert smem <= 232448, (d, smem)
        assert rows == 128 and stages >= 2
        assert keys % 16 == 0 and keys <= 256   # wgmma's N and k-steps
        assert (keys * 128) % 1024 == 0


@pytest.mark.cuda
def test_cuda_forward_with_no_keys_writes_zeros(cuda_device):
    """Skv = 0 (a TMA map has no empty dimension, so the launch writes the
    zeros itself): every row attends to no key and is 0, as the plain
    version gives."""
    q = torch.ones(1, 4, 5, 128, device=cuda_device, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 0, 128, device=cuda_device, dtype=torch.bfloat16)
    got = ops.attention(q, kv, kv)
    torch.cuda.synchronize()
    assert not got.any()
    assert torch.equal(got, chunked_attention(q, kv, kv))


@pytest.mark.cuda
def test_cuda_forward_takes_unaligned_views(cuda_device):
    """q, k and v as views 2 bytes into their storage: the TMA needs
    16-byte aligned bases, so the wrapper copies them first."""
    rng = np.random.default_rng(4)
    flat = [torch.from_numpy(_normal(rng, (n + 1,))).to(cuda_device,
                                                       torch.bfloat16)
            for n in (2 * 4 * 200 * 128, 2 * 2 * 200 * 128,
                      2 * 2 * 200 * 128)]
    q, k, v = (x[1:].view(2, h, 200, 128) for x, h in zip(flat, (4, 2, 2)))
    assert q.data_ptr() % ops.TMA_ALIGN
    got = ops.attention(q, k, v, causal=True, softcap=50.0)
    want = chunked_attention(q, k, v, causal=True, softcap=50.0)
    torch.cuda.synchronize()
    _assert_kernel_close(got, want, "bfloat16", "forward")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,window,cap", [
    ("bfloat16", 16, 50.0), ("float32", None, None)])
def test_cuda_decode_matches_plain_version(cuda_device, dtype, window, cap):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(_normal(rng, s)).to(cuda_device,
                                                    getattr(torch, dtype))
               for s in ((4, 16, 256), (4, 8, 1000, 256), (4, 8, 1000, 256)))
    lens = torch.tensor([1, 17, 999, 1000], dtype=torch.int32,
                        device=cuda_device)
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, lens, window=window, softcap=cap)
    assert ops.decode_attention.launches == before + 1
    want = decode_ref(q, k, v, lens, window=window, softcap=cap)
    torch.cuda.synchronize()
    _assert_kernel_close(got, want, dtype, "decode")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 3])
def test_cuda_decode_at_a_length_zero_row_is_zero(cuda_device, window):
    """Outside the contract (lengths >= 1): the kernel answers a row that
    attends to no key with 0, as the reference's flash_decode does; the
    other row matches the plain version."""
    q, k, v, lens = (torch.from_numpy(a).to(cuda_device)
                     for a in _length_zero_row())
    got = ops.decode_attention(q, k, v, lens, window=window)
    want = decode_ref(q, k, v, lens, window=window)
    torch.cuda.synchronize()
    assert not got[0].any()
    torch.testing.assert_close(got[1], want[1], **F32)
