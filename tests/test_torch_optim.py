"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's (``repro.optim``), on the same numpy inputs from a seed.

Tolerances: schedules, AdamW's moments and updates within rtol 1e-6 /
atol 1e-9 in float32 (the same float32 operations, op for op; XLA and
torch may fuse or order the global norm's sums differently, observed
~1e-7 relative); bfloat16 parameters and updates within one bfloat16
step (rtol 2**-7) where a float32 difference straddles a rounding
boundary; int8 quantization bit for bit (round half to even in both);
the int8 all-reduce over 2-4 gloo ranks equal to the reference's under
``jax.vmap`` bit for bit (integer sums, one shared scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as RefAdamW
from repro.optim import apply_updates as ref_apply_updates
from repro.optim.adamw import global_norm as ref_global_norm
from repro.optim.compression import compress_int8 as ref_compress
from repro.optim.compression import compressed_psum as ref_compressed_psum
from repro.optim.compression import decompress_int8 as ref_decompress
from repro.optim.compression import ef_compress_update as ref_ef_update
from repro.optim.schedule import cosine_schedule as ref_cosine
from repro.optim.schedule import linear_warmup as ref_warmup

from repro_torch.optim import (AdamW, apply_updates, compress_int8,
                               cosine_schedule, decompress_int8,
                               ef_compress_update, global_norm,
                               linear_warmup)
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten

import _torch_ranks as ranks

TOL = dict(rtol=1e-6, atol=1e-9)
BF16 = dict(rtol=2 ** -7, atol=1e-6)


def _np_tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(dtype),
            "b": (rng.standard_normal((8,)) * 1e-3).astype(dtype),
            "layers": {"k": rng.standard_normal((3, 4, 4)).astype(dtype)}}


def _torch(tree, dtype=None):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype)
                    if dtype else torch.from_numpy(np.array(a)), tree)


def _jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _close(got_tree, want_tree, **tol):
    got = tree_leaves(got_tree)
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("kind", ["warmup", "cosine"])
def test_schedules_match(kind):
    if kind == "warmup":
        fns = ref_warmup(3e-4, 10), linear_warmup(3e-4, 10)
    else:
        fns = ref_cosine(1e-3, 10, 100), cosine_schedule(1e-3, 10, 100)
    steps = [0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150]
    want = [float(fns[0](jnp.int32(s))) for s in steps]
    got = [float(fns[1](torch.tensor(s, dtype=torch.int32))) for s in steps]
    np.testing.assert_allclose(got, want, **TOL)


def test_cosine_schedule_shape():
    fn = cosine_schedule(1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(fn(torch.tensor(s))) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[2] > lrs[3] > lrs[4]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-2)


def test_global_norm_matches():
    tree = _np_tree(0)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(ref_global_norm(_jax(tree))), **TOL)


@pytest.mark.parametrize("clip", [None, 1.0, 1e-3])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_float32_updates_match(clip, schedule):
    """Five updates with fresh gradients each: updates, moments, count
    and stats, then the parameters (``apply_updates``)."""
    lr = (lambda: ref_cosine(1e-2, 2, 5), lambda: cosine_schedule(
        1e-2, 2, 5)) if schedule else (lambda: 1e-2, lambda: 1e-2)
    ref_opt = RefAdamW(lr=lr[0](), clip_norm=clip)
    opt = AdamW(lr=lr[1](), clip_norm=clip)
    ref_p, p = _jax(_np_tree(1)), _torch(_np_tree(1))
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for i in range(5):
        g = _np_tree(10 + i)
        ref_u, ref_s, ref_stats = ref_opt.update(_jax(g), ref_s, ref_p)
        u, s, stats = opt.update(_torch(g), s, p)
        _close(u, ref_u, **TOL)
        _close(s.m, ref_s.m, **TOL)
        _close(s.v, ref_s.v, **TOL)
        assert int(s.count) == int(ref_s.count) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(stats[k]),
                                       float(ref_stats[k]), **TOL)
        ref_p, p = ref_apply_updates(ref_p, ref_u), apply_updates(p, u)
        _close(p, ref_p, **TOL)


def test_adamw_bfloat16_parameters_match():
    """bfloat16 parameters and gradients: float32 moments, updates cast
    to bfloat16 and added in bfloat16, as the reference does."""
    ref_opt, opt = RefAdamW(lr=1e-2), AdamW(lr=1e-2)
    ref_p = _jax(_np_tree(2), jnp.bfloat16)
    p = _torch(_np_tree(2), torch.bfloat16)
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    assert all(t.dtype == torch.float32 for t in tree_leaves(s.m))
    for i in range(4):
        g = _np_tree(20 + i)
        ref_u, ref_s, _ = ref_opt.update(_jax(g, jnp.bfloat16), ref_s, ref_p)
        u, s, _ = opt.update(_torch(g, torch.bfloat16), s, p)
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(u))
        _close(s.m, ref_s.m, **TOL)
        _close(u, ref_u, **BF16)
        ref_p, p = ref_apply_updates(ref_p, ref_u), apply_updates(p, u)
        assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p))
        _close(p, ref_p, **BF16)


def test_grad_clipping_bounds_update():
    opt = AdamW(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    params = {"x": torch.zeros(4)}
    state = opt.init(params)
    huge = {"x": torch.full((4,), 1e6)}
    _, new, stats = opt.update(huge, state, params)
    assert float(stats["grad_norm"]) > 1e5   # reported pre-clip
    # the clipped gradient has norm 1: m = (1 - b1) · g_clipped
    np.testing.assert_allclose(float(global_norm(new.m)), 0.1, rtol=1e-6)


def test_adamw_converges_on_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0, clip_norm=None)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt.init(params)
    for _ in range(150):
        x = params["x"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(x ** 2), [x])
        upd, state, _ = opt.update({"x": g}, state, params)
        params = apply_updates(params, upd)
    assert float(torch.sum(params["x"] ** 2)) < 1e-3


def test_tree_helpers_keep_structure():
    tree = {"z": [torch.ones(2), torch.zeros(3)], "a": torch.tensor(1.0)}
    leaves = tree_leaves(tree)
    assert [t.shape for t in leaves] == [(), (2,), (3,)]   # sorted keys
    back = tree_unflatten(tree, [t + 1 for t in leaves])
    assert list(back) == ["z", "a"] and isinstance(back["z"], list)
    assert float(back["a"]) == 2.0


# -- int8 compression -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_compress_decompress_bit_for_bit(dtype):
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    ref_x = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)
    t = torch.from_numpy(x)
    t = t.to(torch.bfloat16) if dtype == "bfloat16" else t
    ref_q, ref_s = ref_compress(ref_x)
    q, s = compress_int8(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert float(s) == float(ref_s)
    np.testing.assert_array_equal(decompress_int8(q, s).numpy(),
                                  np.asarray(ref_decompress(ref_q, ref_s)))
    assert float(np.max(np.abs(x - decompress_int8(q, s).numpy()))) <= \
        float(s) * 0.5 + 1e-2 * (dtype == "bfloat16") + 1e-6


def test_round_half_to_even_in_both():
    """Values at exact halves of the scale: both packages round half to
    even (2.5 → 2, -0.5 → -0, 1.5 → 2), so the int8 codes agree."""
    x = np.array([127.0, 2.5, -0.5, 1.5, 0.5, -2.5, 3.5, -126.5],
                 np.float32)               # scale = 127 / 127 = 1
    q, _ = compress_int8(torch.from_numpy(x))
    ref_q, _ = ref_compress(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(q.numpy(),
                                  [127, 2, 0, 2, 0, -2, 4, -126])


def test_ef_compress_update_matches():
    tree = _np_tree(4)
    ref_g, ref_r = ref_ef_update(_jax(tree), None)
    g, r = ef_compress_update(_torch(tree), None)
    _close(g, ref_g, rtol=0, atol=0)
    _close(r, ref_r, rtol=0, atol=0)
    tree2 = _np_tree(5)
    ref_g, ref_r = ref_ef_update(_jax(tree2), ref_r)
    g, r = ef_compress_update(_torch(tree2), r)
    _close(g, ref_g, rtol=0, atol=0)
    _close(r, ref_r, rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_compressed_psum_over_gloo_ranks_matches_vmap(world, tmp_path):
    """Each rank's gradients all-reduced in int8 over ``world`` gloo ranks
    (``DistributedAxis``) against the reference's ``compressed_psum``
    under ``jax.vmap`` on the same per-worker gradients: every rank holds
    the reference's result, bit for bit, in the gradient's dtype."""
    rng = np.random.default_rng(world)
    grads = {"g": rng.standard_normal((world, 256)).astype(np.float32),
             "h": (rng.standard_normal((world, 3, 5)) *
                   np.arange(1, world + 1)[:, None, None]).astype(np.float32)}
    want = jax.vmap(lambda t: ref_compressed_psum(t, "w"), axis_name="w")(
        {k: jnp.asarray(v) for k, v in grads.items()})
    outs = ranks.spawn(ranks.compressed_psum_body, world, tmp_path, grads)
    for rank, out in enumerate(outs):
        for k, (dtype, got) in out.items():
            assert dtype == torch.float32
            np.testing.assert_array_equal(got, np.asarray(want[k][rank]))
    # every worker sees the same reduced value, near the exact mean
    scale = float(np.max(np.abs(grads["g"]))) / 127
    assert np.max(np.abs(outs[0]["g"][1] - grads["g"].mean(0))) <= \
        scale * 1.01


@pytest.mark.parametrize("compress", [False, True])
def test_shardmap_train_step_over_two_gloo_ranks(compress, tmp_path):
    """``make_shardmap_train_step`` on 2 gloo ranks, each taking half of
    the global batch, against ``make_train_step`` on the whole batch in
    one process (every label kept: the mean of the halves' losses is the
    whole batch's).  With the mean all-reduce, two steps' parameters
    within rtol 1e-5 / atol 1e-6 and the same metrics (``tokens`` is the
    ranks' mean, half the batch's, as the reference's ``pmean`` gives).
    With the int8 all-reduce, the first step's loss equal and its
    parameters within the int8 error as AdamW carries it: the first step
    is ``lr`` times about the sign of each gradient element, which
    quantization keeps or rounds to 0, so at most ``lr`` an element (plus
    float32 noise).  Both ranks hold the same parameters, bit for bit."""
    from repro_torch import configs
    from repro_torch.runtime import init_train_state, make_train_step
    arch = "qwen3-32b"
    cfg = configs.get_reduced(arch)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab, (4, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    outs = ranks.spawn(ranks.shardmap_train_body, 2, tmp_path, arch, batch,
                       compress)
    opt = AdamW(lr=1e-3)
    state = init_train_state(0, cfg, opt, device="cpu")
    step = make_train_step(cfg, opt)
    params, metrics = [], []
    for _ in range(2):
        state, m = step(state, batch)
        params.append([p.numpy() for p in tree_leaves(state.params)])
        metrics.append({k: float(v) for k, v in m.items()})
    for out in outs:
        np.testing.assert_allclose(out["metrics"][0]["loss"],
                                   metrics[0]["loss"], rtol=1e-6)
        if compress:
            for got, w in zip(out["params"][0], params[0]):
                assert np.max(np.abs(got - w)) <= 1e-3 + 1e-6
            continue
        for i in range(2):
            for got, w in zip(out["params"][i], params[i]):
                np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
            mine, theirs = out["metrics"][i], metrics[i]
            assert mine["tokens"] * 2 == theirs["tokens"]
            for k in set(mine) - {"tokens"}:
                np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5,
                                           atol=1e-7)
    for a, b in zip(outs[0]["params"][1], outs[1]["params"][1]):
        np.testing.assert_array_equal(a, b)
