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
import math
import pathlib
import shutil
import subprocess
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
        flash_decode_geometry = Fn()

    monkeypatch.setattr(ops, "load_library", lambda name: Lib())
    lib = ops.library()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, dec = lib.flash_attention_fwd_launch, lib.flash_decode_launch
    tile, geometry = lib.flash_attention_fwd_tile, lib.flash_decode_geometry
    assert fwd.argtypes == [p] * 4 + [i] * 9 + [f, f, p]
    # q, k_cache, v_cache, lengths, out; B, Hq, Hkv, S, D, dtype, window;
    # softcap, scale; cluster; stream — no scratch, no split count
    assert dec.argtypes == [p] * 5 + [i] * 7 + [f, f, i, p]
    assert tile.argtypes == [i, i] + [ctypes.POINTER(i)] * 3
    # D, dtype, group, S, B, Hkv; cluster, keys per tile, slots
    assert geometry.argtypes == [i] * 6 + [ctypes.POINTER(i)] * 3
    assert fwd.restype is ctypes.c_int and dec.restype is ctypes.c_int
    assert tile.restype is ctypes.c_int and geometry.restype is ctypes.c_int


# The decode kernel's geometry (csrc/decode_geometry.h) is plain C++: the
# host's compiler builds it alone here, so the cluster-size rule and the
# ring are held on shapes the card never sees, from the one source the
# library reads.
GEOMETRY_SHIM = """
#include "decode_geometry.h"
namespace dg = decode_geometry;
extern "C" int cluster_size(int bh, int s_max, int sms, const int* active) {
  return dg::cluster_size(bh, s_max, sms, active);
}
extern "C" void tile(int d, int esize, int g, int* out) {
  const dg::Tile t = dg::tile(d, esize, g);
  const dg::Layout l = dg::layout(t, d, g);
  const int v[] = {t.keys, t.slots, t.slot_bytes, dg::fits(t, d, g),
                   l.exchange, l.q, l.scratch, l.barriers, l.end,
                   dg::step_keys(g, dg::epl_for(d)), dg::kWarps, dg::kGroups,
                   dg::kGroupWarps, dg::kSmem, dg::kMinSplitKeys,
                   dg::kMaxCluster, dg::kRuleMaxCluster};
  for (int i = 0; i < 17; ++i) out[i] = v[i];
}
"""
TILE_FIELDS = ("keys", "slots", "slot_bytes", "fits", "exchange", "q",
               "scratch", "barriers", "end", "step_keys", "warps", "groups",
               "group_warps", "smem", "min_split_keys", "max_cluster",
               "rule_max_cluster")


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    """``decode_geometry.h`` built by the host's C++ compiler into a small
    library: ``cluster_size(bh, s_max, sms, active)`` and ``tile(d,
    esize, group)`` (a dict of the tile, the layout and the constants)."""
    compiler = shutil.which("g++") or shutil.which("c++")
    assert compiler, "a host C++ compiler builds decode_geometry.h"
    out = tmp_path_factory.mktemp("decode_geometry")
    (out / "shim.cpp").write_text(GEOMETRY_SHIM)
    csrc = pathlib.Path(ops.__file__).parent / "csrc"
    subprocess.run([compiler, "-std=c++17", "-shared", "-fPIC", "-I",
                    str(csrc), "-o", str(out / "libshim.so"),
                    str(out / "shim.cpp")], check=True)
    lib = ctypes.CDLL(str(out / "libshim.so"))
    lib.cluster_size.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.cluster_size.restype = ctypes.c_int

    def cluster_size(bh, s_max, sms, active):
        return lib.cluster_size(bh, s_max, sms,
                                (ctypes.c_int * len(active))(*active))

    def tile(d, esize, group):
        buf = (ctypes.c_int * len(TILE_FIELDS))()
        lib.tile(d, esize, 1 << max(0, group - 1).bit_length(), buf)
        return dict(zip(TILE_FIELDS, buf))

    return cluster_size, tile


# a stand-in H100: 132 SMs, one decode block an SM, so 132 // c clusters
# of c blocks resident at once (a real card may hold fewer of the larger
# ones: a cluster stays within one GPC)
H100_SMS = 132
H100_ACTIVE = tuple(132 // c for c in range(1, 17))


@pytest.mark.parametrize("b,hkv,smax,want", [
    (1, 8, 8320, 8), (4, 8, 8320, 4), (8, 8, 128, 2), (1, 1, 64, 1),
    (64, 8, 8320, 1)])
def test_decode_cluster_fills_the_card_without_short_splits(geometry, b, hkv,
                                                           smax, want):
    """The largest cluster size up to the rule's cap that keeps every
    block resident, one an SM (B Hkv C <= SMs), with no split under the
    minimum of S_max's keys; 1 where B Hkv already fills the card."""
    cluster_size, tile = geometry
    t = tile(64, 2, 1)
    c = cluster_size(b * hkv, smax, H100_SMS, H100_ACTIVE)
    assert c == want
    assert c == 1 or (b * hkv * c <= H100_SMS and c <= t["rule_max_cluster"]
                      and c * t["min_split_keys"] <= smax)


def test_decode_cluster_keeps_every_cluster_resident(geometry):
    """A cluster size the card cannot hold B Hkv of at once, or cannot
    launch at all (16 is non-portable), is not taken; nor is one past the
    largest."""
    cluster_size, tile = geometry
    active = list(H100_ACTIVE)
    active[7] = 7                       # 7 clusters of 8 at once: not 8
    assert cluster_size(8, 8320, 132, active) == 7
    active[6:8] = [0, 0]                # 7 and 8 refused
    assert cluster_size(8, 8320, 132, active) == 6
    assert cluster_size(3, 8320, 132, active) == 6
    assert cluster_size(8, 8320, 132, [132] + [0] * 15) == 1
    t = tile(64, 2, 1)
    assert t["rule_max_cluster"] <= t["max_cluster"]
    assert cluster_size(1, 1 << 20, 10 ** 4, (10 ** 4,) * 16) == \
        t["rule_max_cluster"]


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("group", [1, 2, 7, 8])
def test_decode_tile_fits_and_gives_every_warp_whole_steps(geometry, esize,
                                                           group):
    """At every head dim up to 256: the ring, the block's exchanged state,
    q, the warps' score scratch and the barriers fit the shared memory a
    launch asks for; the slots are a whole number for each warp group (a
    slot always serves one group, so a parity wait on its barriers cannot
    pass a phase early), two or more for each where a tile is 16 KB or
    less; a tile is whole steps for every warp of a group; a slot holds a
    tile's rows plus the 16-byte envelope on both sides, on a 16-byte
    boundary; the warps' states fit over the ring."""
    _, tile = geometry
    for d in range(1, 257):
        t = tile(d, esize, group)
        g = 1 << max(0, group - 1).bit_length()
        assert t["fits"] and t["slots"] >= t["groups"]
        assert t["slots"] % t["groups"] == 0
        if t["keys"] * d * esize <= 16384:
            assert t["slots"] >= 2 * t["groups"]
        assert t["end"] + 128 <= t["smem"] <= 232448   # 227 KB a block
        assert t["warps"] == t["groups"] * t["group_warps"]
        assert t["keys"] % (t["group_warps"] * t["step_keys"]) == 0
        assert t["step_keys"] * g <= 32                # one warp reduction
        assert t["slot_bytes"] % 16 == 0
        assert t["slot_bytes"] >= t["keys"] * d * esize + 30
        assert t["exchange"] >= max(2 * t["slots"] * t["slot_bytes"],
                                    t["warps"] * g * (2 + d) * 4)
        assert t["scratch"] >= t["q"] + g * d * 4
        assert t["barriers"] >= t["scratch"] + t["warps"] * g * t[
            "step_keys"] * 4


LOG2E = 1.4426950408889634


def emulate_decode(q, k_cache, v_cache, lengths, *, window=None,
                   softcap=None, scale=None, cluster, keys, slots, groups,
                   group_warps, step, faults=()):
    """The CUDA decode's decomposition in float64 on the CPU, as
    ``decode_cluster`` computes it: rank r of ``cluster`` takes
    [lo + r per, lo + (r + 1) per) of the row's live range [lo, hi), per
    = ceil((hi - lo) / cluster), in tiles of ``keys`` that pass through a
    ring of ``slots``; tile i goes to warp group i % ``groups``, and in it
    the group's warp w of ``group_warps`` takes the steps of ``step`` keys
    w, w + group_warps, ...; scores in log2 units (the
    softcap as c1 - c2 / (1 + 2^(s k1))); each warp keeps (m, l, acc),
    the warps merge into the rank's partial, and the ranks merge in rank
    order (an empty rank has m = -inf, l = 0; a row with no live key is
    0).  ``faults`` plants what a faulty kernel would compute: "drop_rank"
    (rank 1's partial left out of the merge, rank 0's where there is one
    rank), "stale_slot" (rank 0's tile ``slots`` read from the slot's
    previous tile), "drop_tail" (every rank's ragged last tile skipped)."""
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    cap = softcap is not None and softcap > 0
    k1 = 2 * LOG2E * scale / softcap if cap else LOG2E * scale
    c1 = LOG2E * softcap if cap else 0.0
    out = torch.zeros((b, hq, d), dtype=torch.float64)
    dropped = (1 if cluster > 1 else 0) if "drop_rank" in faults else None
    for bi in range(b):
        length = int(lengths[bi])
        lo = max(0, length - window) if window else 0
        live = max(min(length, s_max) - lo, 0)
        per = -(-live // cluster)
        for h in range(hkv):
            qg = q[bi, h * group:(h + 1) * group].double()
            k, v = k_cache[bi, h].double(), v_cache[bi, h].double()
            parts = []
            for r in range(cluster):
                r0 = lo + r * per
                n = max(0, min(lo + live, r0 + per) - r0)
                rows, owner = [], []
                for i in range(-(-n // keys)):
                    k0 = r0 + i * keys
                    nk = min(keys, r0 + n - k0)
                    if "drop_tail" in faults and nk < keys:
                        continue
                    src = k0
                    if "stale_slot" in faults and r == 0 and i == slots:
                        src = k0 - slots * keys   # the slot's previous tile
                    rows.append(torch.arange(src, src + nk))
                    owner.append(i % groups * group_warps
                                 + torch.arange(nk) // step % group_warps)
                m = torch.full((group,), -math.inf, dtype=torch.float64)
                l = torch.zeros(group, dtype=torch.float64)
                acc = torch.zeros((group, d), dtype=torch.float64)
                if rows and r != dropped:
                    idx, own = torch.cat(rows), torch.cat(owner)
                    s = qg @ k[idx].T
                    t = c1 - 2 * c1 / (1 + torch.exp2(s * k1)) if cap \
                        else s * k1
                    for w in range(groups * group_warps):  # warps' states
                        tw = t[:, own == w]
                        if tw.shape[1] == 0:
                            continue
                        mw = tw.max(dim=1).values
                        pw = torch.exp2(tw - mw[:, None])
                        mm = torch.maximum(m, mw)
                        fo, fw = torch.exp2(m - mm), torch.exp2(mw - mm)
                        l = l * fo + pw.sum(dim=1) * fw
                        acc = acc * fo[:, None] + (pw @ v[idx][own == w]) \
                            * fw[:, None]
                        m = mm
                parts.append((m, l, acc))
            mm = torch.stack([p[0] for p in parts]).max(dim=0).values
            if bool(torch.isinf(mm).all()):
                continue                        # no live key: 0
            num = sum(p[2] * torch.exp2(p[0] - mm)[:, None] for p in parts)
            den = sum(p[1] * torch.exp2(p[0] - mm) for p in parts)
            out[bi, h * group:(h + 1) * group] = num / den[:, None]
    return out.to(q.dtype)


EMULATED = [
    # b, hq, hkv, smax, d, window, cap, dtype, lengths, cluster
    (2, 8, 8, 256, 64, None, None, "float32", (1, 256), 16),  # length 1
    (1, 2, 1, 128, 96, None, 50.0, "float32", (5,), 8),       # length < C
    (2, 14, 2, 320, 128, 3, None, "bfloat16", (320, 200), 8),  # window < C
    (1, 8, 1, 200, 160, None, 30.0, "float32", (199,), 4),    # group 8
    (3, 4, 2, 384, 256, 100, 50.0, "bfloat16", (384, 1, 130), 2),
    (2, 4, 4, 64, 64, None, None, "float32", (64, 33), 1),
    (2, 16, 8, 300, 128, 64, 50.0, "float32", (300, 65), 16),  # empty ranks
    (1, 14, 2, 512, 256, None, 50.0, "float32", (512,), 2),    # group 7
]


@pytest.mark.parametrize("b,hq,hkv,smax,d,window,cap,dtype,lens,cluster",
                         EMULATED)
def test_emulated_decode_matches_reference_and_pallas(
        geometry, b, hq, hkv, smax, d, window, cap, dtype, lens, cluster):
    """The kernel's decomposition, at the library's tile and ring for this
    head dim and dtype, against ``decode_ref`` (both packages') and the
    reference's ``flash_decode`` in interpret mode, at its seams: length 1
    and S_max, lengths and windows shorter than the cluster (empty ranks),
    ragged last tiles, groups 1, 2, 7 and 8, head dims 64-256."""
    _, tile = geometry
    rng = np.random.default_rng(smax + d + cluster)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(rng, shape), dtype)
        for shape in ((b, hq, d), (b, hkv, smax, d), (b, hkv, smax, d)))
    lengths = np.array(lens, np.int32)
    kw = dict(window=window, softcap=cap)
    t = tile(d, 2 if dtype == "bfloat16" else 4, hq // hkv)
    got = emulate_decode(tq, tk, tv, torch.from_numpy(lengths),
                         cluster=cluster, keys=t["keys"], slots=t["slots"],
                         groups=t["groups"], group_warps=t["group_warps"],
                         step=t["step_keys"], **kw)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(
        _np(got), _np(decode_ref(tq, tk, tv, torch.from_numpy(lengths),
                                 **kw)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(jax_decode_ref(jq, jk, jv, jnp.asarray(lengths),
                                     **kw)), **tol)
    np.testing.assert_allclose(
        _np(got), _np(flash_decode(jq, jk, jv, jnp.asarray(lengths),
                                   interpret=True, **kw)), **tol)


@pytest.mark.parametrize("cluster,keys,slots", [(1, 32, 3), (3, 32, 3),
                                                (4, 64, 3), (16, 32, 8)])
def test_emulated_decode_is_the_same_function_at_any_geometry(cluster, keys,
                                                              slots):
    """Cluster size, tile and ring depth change the order of the sums and
    nothing else (float64: to rounding)."""
    rng = np.random.default_rng(cluster + keys)
    q, k, v = (torch.from_numpy(_normal(rng, s))
               for s in ((3, 8, 32), (3, 2, 700, 32), (3, 2, 700, 32)))
    lengths = torch.tensor([700, 301, 2], dtype=torch.int32)
    kw = dict(window=500, softcap=50.0)
    want = emulate_decode(q.double(), k.double(), v.double(), lengths,
                          cluster=1, keys=700, slots=2, groups=1,
                          group_warps=1, step=1, **kw)
    got = emulate_decode(q.double(), k.double(), v.double(), lengths,
                         cluster=cluster, keys=keys, slots=slots, groups=2,
                         group_warps=4, step=4, **kw)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(
        got.float(), decode_ref(q, k, v, lengths, **kw), **F32)


@pytest.mark.parametrize("fault", ["drop_rank", "stale_slot", "drop_tail"])
def test_emulated_faults_change_the_output(fault):
    """Each fault ``chip_smoke.py`` plants on the card changes the output
    of a decomposition where it can occur by more than the kernel's
    tolerance there: a rank left out of the merge, a stale ring slot, a
    ragged last tile dropped."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_normal(rng, s))
               for s in ((1, 4, 64), (1, 2, 1000, 64), (1, 2, 1000, 64)))
    lengths = torch.tensor([1000], dtype=torch.int32)
    geo = dict(cluster=4, keys=64, slots=3, groups=2, group_warps=4, step=8)
    want = emulate_decode(q, k, v, lengths, **geo)
    got = emulate_decode(q, k, v, lengths, faults=(fault,), **geo)
    assert float((got - want).abs().max()) > 1e-2
    np.testing.assert_allclose(_np(want), _np(decode_ref(q, k, v, lengths)),
                               **F32)


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
    assert wgmma == {"registers": 168, "stack_frame": 0, "spill_stores": 0,
                     "spill_loads": 0}
    assert usage["_Z8fwd_rowsPf"] == {"registers": 255, "stack_frame": 8,
                                      "spill_stores": 4, "spill_loads": 12}
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


def _decode_inputs(device, b, hq, hkv, s_max, d, dtype, lens, shift=0,
                   seed=0):
    """q and caches from the numpy seed on ``device``; the caches' data
    start ``shift`` bytes past a 16-byte boundary (views into larger
    tensors)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(_normal(rng, (b, hq, d))).to(device, dt)
    n = b * hkv * s_max * d
    caches = []
    for _ in range(2):
        flat = torch.from_numpy(_normal(rng, (n + 16,))).to(device, dt)
        off = shift // flat.element_size()
        caches.append(flat[off:off + n].view(b, hkv, s_max, d))
    lengths = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, caches[0], caches[1], lengths


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4096, None])
def test_cuda_decode_on_gemmas_layer_shapes(cuda_device, window):
    """Gemma 2 9B's decode at its first step after an 8,192-token prompt:
    q (1, 16, 256), caches (1, 8, 8208, 256), length 8,193, softcap 50,
    a windowed and a global layer."""
    q, k, v, lens = _decode_inputs(cuda_device, 1, 16, 8, 8208, 256,
                                   "bfloat16", [8193])
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, lens, window=window, softcap=50.0)
    assert ops.decode_attention.launches == before + 1
    want = decode_ref(q, k, v, lens, window=window, softcap=50.0)
    torch.cuda.synchronize()
    _assert_kernel_close(got, want, "bfloat16", "decode")


@pytest.mark.cuda
def test_cuda_decode_repeats_bit_for_bit_across_shapes_and_clusters(
        cuda_device):
    """The kernel keeps nothing between calls: the same call gives the
    same bits after calls of another shape (another cluster size from the
    library's rule) and at a forced cluster size."""
    a = _decode_inputs(cuda_device, 1, 16, 8, 8208, 256, "bfloat16",
                       [8193])
    b = _decode_inputs(cuda_device, 16, 16, 8, 1000, 256, "bfloat16",
                       list(range(60, 1000, 60))[:16], seed=1)
    assert ops.decode_geometry(a[0], a[1])[0] != \
        ops.decode_geometry(b[0], b[1])[0]
    kw = dict(window=None, softcap=50.0)
    first = ops.decode_attention(*a, **kw)
    ops.decode_attention(*b, **kw)
    forced = ops._decode_cuda(*a, None, 50.0, 256 ** -0.5, cluster=2)
    again = [ops.decode_attention(*a, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, x) for x in again)
    _assert_kernel_close(forced, decode_ref(*a, **kw), "bfloat16", "decode")


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 12, 16])
def test_cuda_decode_at_each_cluster_size(cuda_device, cluster):
    """Any cluster size the card launches gives the plain version's
    result; one it cannot launch (16 is non-portable) raises."""
    q, k, v, lens = _decode_inputs(cuda_device, 3, 32, 4, 3000, 128,
                                   "bfloat16", [3000, 1, 1777])
    try:
        got = ops._decode_cuda(q, k, v, lens, 1000, 50.0, 128 ** -0.5,
                               cluster=cluster)
    except RuntimeError as err:
        assert cluster == 16 and "CUDA error" in str(err)
        return
    want = decode_ref(q, k, v, lens, window=1000, softcap=50.0)
    torch.cuda.synchronize()
    _assert_kernel_close(got, want, "bfloat16", "decode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,shift", [("bfloat16", 256, 2),
                                           ("bfloat16", 128, 6),
                                           ("float32", 64, 4),
                                           ("float32", 33, 0)])
def test_cuda_decode_takes_caches_off_16_byte_boundaries(cuda_device, dtype,
                                                         d, shift):
    """Caches whose data start off a 16-byte boundary, or whose rows are
    not whole 16-byte vectors (D = 33 float32), go through the same bulk
    copies (the 16-byte envelope around the rows) and scalar reads."""
    q, k, v, lens = _decode_inputs(cuda_device, 4, 16, 8, 2000, d, dtype,
                                   [2000, 1, 999, 1500], shift=shift)
    assert k.data_ptr() % 16 == shift
    got = ops.decode_attention(q, k, v, lens, window=700, softcap=50.0)
    want = decode_ref(q, k, v, lens, window=700, softcap=50.0)
    torch.cuda.synchronize()
    _assert_kernel_close(got, want, dtype, "decode")


@pytest.mark.cuda
def test_cuda_decode_geometry_and_allocations(cuda_device):
    """The library's geometry: clusters of more than one block where B Hkv
    leaves the card idle, one block where it fills it; a call allocates
    its output and nothing else."""
    q, k, v, lens = _decode_inputs(cuda_device, 1, 16, 8, 8208, 256,
                                   "bfloat16", [8193])
    cluster, keys, slots = ops.decode_geometry(q, k)
    assert cluster == 8 and keys >= 8 and slots >= 3
    big = _decode_inputs(cuda_device, 64, 16, 8, 64, 256, "bfloat16",
                         [64] * 64)
    assert ops.decode_geometry(big[0], big[1])[0] == 1
    ops.decode_attention(q, k, v, lens, softcap=50.0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    ops.decode_attention(q, k, v, lens, softcap=50.0)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - \
        before == 1
