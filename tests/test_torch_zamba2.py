"""The port's zamba2-1.2b (``repro_torch.models.mamba``'s Mamba-2 half,
the mamba2 and shared-attention branches of ``models.transformer``,
``launch.serve`` on a hybrid cache) against the reference's, on the
reduced zamba2 (6 Mamba-2 layers, the shared attention block after layers
2 and 5).

The reference's own parameters (``repro.models.init_params``, handed over
by ``params_from_reference``) run at float32 on the CPU, where the
attention wrappers run their plain versions.  Tolerances are
``test_torch_lm.TOL``: float32 logits, states and caches within rtol
1e-4, atol 1e-5; served token streams exactly equal.  Two tests state
their own: the SSD on raw standard-normal inputs (``SSD_TOL``) and the
gradient (``GRAD_REL_L2``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.launch import serve as ref_serve
from repro.models import mamba as ref_mamba
from repro_torch import configs
from repro_torch.checkpoint import snapshot
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, loss_fn, prefill,
                                prefill_forward)
from repro_torch.models import mamba
from repro_torch.models.convert import params_from_reference
from repro_torch.models.transformer import check_ported
from repro_torch.runtime.train_step import value_and_grad

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-5)
# the SSD on standard-normal x, B and C: each output sums up to a chunk's
# products of size max|y| (~30), so float32 rounding in either package's
# order is ~chunk * 2**-24 * max|y|.  Against a float64 run of the same
# function, the reference's float32 output is off by up to 4.1e-6 of
# max|y| and the port's by 1.4e-6; so atol is 1e-5 of max|y|
SSD_TOL = dict(rtol=1e-4, atol_of_max=1e-5)
# every gradient leaf within this relative L2 of the reference's, as
# ``test_torch_train.GRAD_REL_L2``
GRAD_REL_L2 = 1e-5
B, S = 2, 24


@pytest.fixture(scope="module")
def model():
    """(reference config, reference params, port config, port params) —
    the port's parameters are the reference's, handed over."""
    ref_cfg = ref_configs.get_reduced(ARCH)
    ref_params = ref_models.init_params(jax.random.PRNGKey(11), ref_cfg)
    cfg = configs.get_reduced(ARCH)
    params = params_from_reference(jax.device_get(ref_params), cfg,
                                   device="cpu")
    return ref_cfg, ref_params, cfg, params


@pytest.fixture(scope="module")
def no_shared():
    """The same reduced zamba2 without the shared block (a plain Mamba-2
    stack), reference and port."""
    ref_cfg = ref_configs.get_reduced(ARCH).replace(shared_attn_every=0)
    ref_params = ref_models.init_params(jax.random.PRNGKey(12), ref_cfg)
    cfg = configs.get_reduced(ARCH).replace(shared_attn_every=0)
    params = params_from_reference(jax.device_get(ref_params), cfg,
                                   device="cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _ref_layer(ref_params, i):
    return jax.tree.map(lambda a: a[i], ref_params["layers"])


def _cache_close(cache, ref_cache):
    """Every entry of a port cache against the reference's: the same
    keys and shapes, values within ``TOL``, lengths equal."""
    assert set(cache) == set(ref_cache)
    for name in ("sa_k", "sa_v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        _close(cache[name], ref_cache[name])
    for name in ("conv", "ssm"):
        assert tuple(cache["mamba"][name].shape) == \
            ref_cache["mamba"][name].shape
        _close(cache["mamba"][name], ref_cache["mamba"][name])
    assert cache["lengths"].tolist() == np.asarray(
        ref_cache["lengths"]).tolist()


# -- configuration and parameters ----------------------------------------------

def test_config_copies_the_reference():
    for get, ref_get in ((configs.get, ref_configs.get),
                         (configs.get_reduced, ref_configs.get_reduced)):
        cfg, ref = get(ARCH), ref_get(ARCH)
        for f in dataclasses.fields(ref):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
        assert cfg.n_params() == ref.n_params()
    assert configs.get(ARCH).n_params() == 1_170_308_864
    assert configs.get(ARCH).param_dtype_ == torch.bfloat16
    assert set(configs.all_configs()) == set(ref_configs.ARCHS)
    assert ARCH in configs.all_configs()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_bit_for_bit(dtype):
    """Every leaf of a reference tree comes across bit for bit: the
    layers unstacked, ``shared_attn`` (not stacked) as it is, the mamba2
    mixer's A_log, D and dt_bias float32 whatever ``param_dtype`` is."""
    ref_cfg = ref_configs.get_reduced(ARCH).replace(param_dtype=dtype)
    cfg = configs.get_reduced(ARCH).replace(param_dtype=dtype)
    tree = jax.device_get(ref_models.init_params(jax.random.PRNGKey(3),
                                                 ref_cfg))
    params = params_from_reference(tree, cfg, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    want = jax.tree.leaves(tree)
    got = snapshot(params).arrays
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    mixer = params["layers"][cfg.n_layers - 1]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert mixer[name].dtype == torch.float32
        assert tuple(mixer[name].shape) == (cfg.d_inner_ //
                                            cfg.mamba_head_dim,)
    shared = params["shared_attn"]
    assert set(shared) == {"norm1", "attn", "norm2", "ffn"}
    assert str(shared["attn"]["wq"].dtype).split(".")[-1] == dtype
    np.testing.assert_array_equal(
        shared["ffn"]["w_down"].float().numpy(),
        np.asarray(tree["shared_attn"]["ffn"]["w_down"], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_init_has_the_reference_tree_layout(dtype):
    """The port's own random init (a torch.Generator) gives the leaves
    the reference's init gives, in the reference's leaf order, by shape
    and dtype."""
    cfg = configs.get_reduced(ARCH).replace(param_dtype=dtype)
    ref_cfg = ref_configs.get_reduced(ARCH).replace(param_dtype=dtype)
    want = jax.eval_shape(lambda k: ref_models.init_params(k, ref_cfg),
                          jax.random.PRNGKey(0))
    params = init_params(0, cfg, device="cpu")
    got = snapshot(params)
    assert len(got.arrays) == len(jax.tree.leaves(want))
    for a, dt, w in zip(got.arrays, got.dtypes, jax.tree.leaves(want)):
        assert a.shape == w.shape
        assert dt == w.dtype.name
    mixer = params["layers"][0]["mixer"]
    nh = cfg.d_inner_ // cfg.mamba_head_dim
    assert torch.equal(mixer["A_log"], torch.log(
        torch.arange(1, nh + 1, dtype=torch.float32)))
    assert mixer["dt_bias"].eq(0).all() and mixer["D"].eq(1).all()
    assert torch.equal(params["shared_attn"]["attn"]["wq"],
                       init_params(0, cfg, device="cpu")["shared_attn"]
                       ["attn"]["wq"])


# -- the SSD and the mixer ---------------------------------------------------------

def _ssd_inputs(seed, b, slen, h, p, n, a_scale=1.0, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, slen, h, p), dtype=np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.standard_normal((b, slen, h))))
          ).astype(np.float32)
    a = (-a_scale * np.arange(1, h + 1)).astype(np.float32)
    bm = rng.standard_normal((b, slen, n), dtype=np.float32)
    cm = rng.standard_normal((b, slen, n), dtype=np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("slen,chunk,a_scale,dt_scale", [
    (8, 8, 1.0, 1.0), (64, 64, 1.0, 1.0), (128, 64, 1.0, 1.0),
    (320, 64, 1.0, 1.0), (40, 8, 1.0, 1.0), (1024, 8, 0.05, 0.02)])
def test_ssd_chunked_matches_reference(slen, chunk, a_scale, dt_scale):
    """y and the final state over 1 to 128 chunks: the recurrence between
    chunks in closed form against the reference's scan, the last case
    with a memory longer than the sequence (|A| dt ~ 1e-3 a step, each
    chunk's decay ~0.99), so every state carries through all 128."""
    x = _ssd_inputs(slen, 2, slen, 3, 8, 5, a_scale, dt_scale)
    want_y, want_s = ref_mamba._ssd_chunked(*map(jnp.asarray, x), chunk)
    y, s = mamba._ssd_chunked(*map(torch.from_numpy, x), chunk)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == want_y.shape and tuple(s.shape) == want_s.shape
    for got, want in ((y, want_y), (s, want_s)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=SSD_TOL["rtol"],
            atol=SSD_TOL["atol_of_max"] * float(np.abs(want).max()))


def test_ssd_masks_the_exponent_before_exp():
    """|A| Σ dt far past 88 inside a chunk: the reference's exponent
    above the diagonal overflows to inf before its mask; the port masks
    it with -inf first.  Both outputs are finite and agree, and the
    port's intra-chunk term forms no inf."""
    x, dt, a, bm, cm = _ssd_inputs(5, 1, 64, 4, 4, 4, a_scale=30.0)
    dt_cum = np.cumsum(dt * a, axis=1)
    assert float(np.max(dt_cum[:, 0] - dt_cum[:, -1])) > 88.0
    want_y, want_s = ref_mamba._ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bm, cm)), 64)
    args = [torch.from_numpy(t) for t in (x, dt, a, bm, cm)]
    y, s = mamba._ssd_chunked(*args, 64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-5 * float(np.abs(want_y).max()))
    xt, dtt, at, bt, ct = args
    dA_cum = torch.cumsum(dtt.reshape(1, 1, 64, 4) * at, dim=2)
    seen = []
    real_exp = torch.exp

    def exp(t):
        seen.append(bool(torch.isinf(real_exp(t)).any()))
        return real_exp(t)

    torch.exp = exp
    try:
        mamba._ssd_intra(xt.reshape(1, 1, 64, 4, 4), dtt.reshape(1, 1, 64, 4),
                         dA_cum, bt.reshape(1, 1, 64, 4),
                         ct.reshape(1, 1, 64, 4))
    finally:
        torch.exp = real_exp
    assert seen == [False]


@pytest.mark.parametrize("slen", [1, 5, 63, 64, 65, 130])
def test_mixer_forward_matches_reference(model, slen):
    """``mamba2_forward`` with and without ``return_state``, at lengths
    inside one chunk, at and past its edge and past two (the last chunk
    padded after the softplus, as the reference pads it)."""
    ref_cfg, ref_params, cfg, params = model
    x = np.random.default_rng(slen).normal(
        size=(B, slen, cfg.d_model)).astype(np.float32)
    ref_p = _ref_layer(ref_params, 2)["mixer"]
    p = params["layers"][2]["mixer"]
    y_r, st_r = ref_mamba.mamba2_forward(ref_p, jnp.asarray(x), ref_cfg,
                                         return_state=True)
    y, st = mamba.mamba2_forward(p, torch.from_numpy(x), cfg,
                                 return_state=True)
    _close(y, y_r)
    for name in ("conv", "ssm"):
        assert tuple(st[name].shape) == st_r[name].shape
        _close(st[name], st_r[name])
    assert st["ssm"].dtype == torch.float32
    assert st["conv"].is_contiguous()
    _close(mamba.mamba2_forward(p, torch.from_numpy(x), cfg), y_r)


def test_padding_after_the_softplus_keeps_the_final_state(model):
    """A 65-token prompt's state is the state after its last token: the
    same as a 64-token forward (no padding) continued by one decode step.
    Padding before the softplus (dt = softplus(dt_bias) on the pad) would
    decay it through the pad."""
    _, _, cfg, params = model
    p = params["layers"][1]["mixer"]
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(B, 65, cfg.d_model)).astype(np.float32))
    _, full = mamba.mamba2_forward(p, x, cfg, return_state=True)
    _, st = mamba.mamba2_forward(p, x[:, :64], cfg, return_state=True)
    _, st = mamba.mamba2_decode(p, x[:, 64:], st, cfg)
    _close(full["ssm"], st["ssm"].numpy())
    _close(full["conv"], st["conv"].numpy())


def test_mixer_decode_matches_reference(model):
    """Five ``mamba2_decode`` steps from a prefill state, each output and
    state against the reference's; and the zeroed cache's shapes."""
    ref_cfg, ref_params, cfg, params = model
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32)
    ref_p = _ref_layer(ref_params, 4)["mixer"]
    p = params["layers"][4]["mixer"]
    _, st_r = ref_mamba.mamba2_forward(ref_p, jnp.asarray(x), ref_cfg,
                                       return_state=True)
    _, st = mamba.mamba2_forward(p, torch.from_numpy(x), cfg,
                                 return_state=True)
    for _ in range(5):
        xt = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        y_r, st_r = ref_mamba.mamba2_decode(ref_p, jnp.asarray(xt), st_r,
                                            ref_cfg)
        y, st = mamba.mamba2_decode(p, torch.from_numpy(xt), st, cfg)
        _close(y, y_r)
        for name in ("conv", "ssm"):
            _close(st[name], st_r[name])
    cache = mamba.mamba2_init_cache(cfg, 3, device="cpu")
    ref_cache = ref_mamba.mamba2_init_cache(ref_cfg, 3)
    for name in ("conv", "ssm"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        assert str(cache[name].dtype).split(".")[-1] == \
            ref_cache[name].dtype.name
        assert cache[name].eq(0).all()


# -- the model ------------------------------------------------------------------

@pytest.mark.parametrize("shared", [True, False])
def test_forward_and_loss_match_reference(model, no_shared, shared):
    ref_cfg, ref_params, cfg, params = model if shared else no_shared
    toks = _tokens(cfg, 4, (B, S + 1))
    want, _ = ref_models.forward(ref_params, jnp.asarray(toks[:, :-1]),
                                 ref_cfg)
    got, aux = forward(params, torch.from_numpy(toks[:, :-1]), cfg)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)
    labels = toks[:, 1:].copy()
    labels[:, :3] = -1
    batch = {"inputs": toks[:, :-1], "labels": labels}
    ref_loss, ref_m = ref_models.loss_fn(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    loss, m = loss_fn(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    assert float(m["tokens"]) == float(ref_m["tokens"]) == B * (S - 3)


def test_shared_block_runs_with_one_set_of_weights(model):
    """Scaling the shared block's output projection changes the logits
    (the block runs), and the tree holds one copy of its weights."""
    _, _, cfg, params = model
    toks = torch.from_numpy(_tokens(cfg, 5, (1, 9)))
    base, _ = forward(params, toks, cfg)
    shared = dict(params["shared_attn"],
                  attn=dict(params["shared_attn"]["attn"],
                            wo=params["shared_attn"]["attn"]["wo"] * 0))
    moved, _ = forward(dict(params, shared_attn=shared), toks, cfg)
    assert not torch.allclose(base, moved)
    assert all("shared_attn" not in layer for layer in params["layers"])


def test_gradient_matches_reference(model):
    """``loss_fn`` under autograd, every leaf against
    ``jax.value_and_grad`` at a length where |A| Σ dt stays below 88
    inside the one chunk, so the reference's gradient is finite."""
    ref_cfg, ref_params, cfg, params = model
    check_ported(cfg, train_on="cpu")
    toks = _tokens(cfg, 6, (B, 13))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    (ref_loss, _), ref_grads = jax.value_and_grad(
        ref_models.loss_fn, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    (loss, _), grads = value_and_grad(
        loss_fn, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        cfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    want = jax.tree.leaves(jax.device_get(ref_grads))
    got = snapshot(grads).arrays
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.all(np.isfinite(w)) and np.any(w != 0)
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= GRAD_REL_L2


def test_gradient_is_finite_past_a_chunk(model):
    """At 64 tokens |A| Σ dt passes 88 inside a chunk: the reference's
    gradient is NaN there (the gradient of its masked inf), the port's is
    finite (the exponent masked before the exp)."""
    ref_cfg, ref_params, cfg, params = model
    toks = _tokens(cfg, 7, (B, 65))
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    _, ref_grads = jax.value_and_grad(ref_models.loss_fn, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    assert any(bool(jnp.isnan(g).any())
               for g in jax.tree.leaves(ref_grads["layers"]["mixer"]))
    _, grads = value_and_grad(
        loss_fn, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        cfg)
    assert all(np.isfinite(g).all() for g in snapshot(grads).arrays)


def test_mamba2_training_on_the_card_is_not_ported():
    cfg = configs.get_reduced(ARCH)
    check_ported(cfg, train_on="cpu")
    with pytest.raises(NotImplementedError, match="#13f"):
        check_ported(cfg, train_on="cuda")
    with pytest.raises(ValueError, match="shared attention"):
        check_ported(configs.get_reduced("yi-34b").replace(
            shared_attn_every=2))


def test_init_cache_matches_reference_layout(model):
    ref_cfg, _, cfg, _ = model
    cache = init_cache(cfg, 3, 20, device="cpu")
    ref_cache = ref_models.init_cache(ref_cfg, 3, 20)
    assert set(cache) == set(ref_cache) == {"lengths", "mamba", "sa_k",
                                            "sa_v"}
    for name in ("sa_k", "sa_v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape == \
            (2, 3, cfg.n_kv_heads, 20, cfg.head_dim_)
    for name in ("conv", "ssm"):
        assert tuple(cache["mamba"][name].shape) == \
            ref_cache["mamba"][name].shape


@pytest.mark.parametrize("prompt", [S - 5, 7])
def test_prefill_then_decode_match_reference(model, prompt):
    """prefill_forward's last logits and whole cache (mamba states, every
    shared-block call's k and v, lengths), then a run of decode_step
    logits and caches, against the reference's; the caches written in
    place; the last logits against the full forward."""
    ref_cfg, ref_params, cfg, params = model
    toks = _tokens(cfg, 5, (B, S))
    max_len = S + 8
    ref_last, ref_cache = ref_models.prefill_forward(
        ref_params, jnp.asarray(toks[:, :prompt]), ref_cfg, max_len)
    last, cache = prefill_forward(params, torch.from_numpy(toks[:, :prompt]),
                                  cfg, max_len)
    _close(last, ref_last)
    _cache_close(cache, ref_cache)
    assert cache["sa_k"][:, :, :, prompt:].eq(0).all()
    ssm, sa_k = cache["mamba"]["ssm"], cache["sa_k"]
    for t in range(prompt, S):
        ref_logits, ref_cache = ref_models.decode_step(
            ref_params, ref_cache, jnp.asarray(toks[:, t:t + 1]), ref_cfg)
        logits, cache = decode_step(params, cache,
                                    torch.from_numpy(toks[:, t:t + 1]), cfg)
        _close(logits, ref_logits)
    assert cache["mamba"]["ssm"] is ssm and cache["sa_k"] is sa_k
    _cache_close(cache, ref_cache)
    full, _ = forward(params, torch.from_numpy(toks), cfg)
    _close(logits, full[:, -1].numpy(), rtol=1e-3, atol=2e-4)


def test_token_prefill_matches_reference(model):
    """``prefill`` (decode steps over the prompt) from an empty cache."""
    ref_cfg, ref_params, cfg, params = model
    toks = _tokens(cfg, 6, (B, 10))
    ref_logits, ref_cache = ref_models.prefill(
        ref_params, ref_models.init_cache(ref_cfg, B, 16), jnp.asarray(toks),
        ref_cfg)
    logits, cache = prefill(params, init_cache(cfg, B, 16, device="cpu"),
                            torch.from_numpy(toks), cfg)
    _close(logits, ref_logits)
    _cache_close(cache, ref_cache)


@pytest.mark.parametrize("slots,requests", [(2, 5), (3, 4)])
def test_batched_server_streams_equal_reference(model, slots, requests):
    """More requests than slots, so slots are reused: a reused slot starts
    from the states its lanes hold and idle slots advance on token 0, in
    both packages.  Every token stream equals the reference's, and the
    final caches agree."""
    ref_cfg, ref_params, cfg, params = model
    rng = np.random.default_rng(slots * 10 + requests)
    prompts = [rng.integers(0, cfg.vocab, 5 + i % 3, dtype=np.int32)
               for i in range(requests)]
    ref_server = ref_serve.BatchedServer(ref_cfg, ref_params, slots, 32)
    server = serve.BatchedServer(cfg, params, slots, 32, device="cpu")
    for i, p in enumerate(prompts):
        ref_server.submit(ref_serve.Request(id=i, prompt=p, max_new=4 + i))
        server.submit(serve.Request(id=i, prompt=p, max_new=4 + i))
    ref_reqs, reqs = list(ref_server.queue), list(server.queue)
    served = steps = 0
    while any(server.slots) or server.queue:
        served += server.step()
        ref_server.step()
        steps += 1
        assert steps < 100
    assert not any(ref_server.slots) and not ref_server.queue
    assert served == sum(4 + i for i in range(requests))
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
    assert all(r.done for r in reqs)
    _cache_close(server.cache, ref_server.cache)


def test_admission_keeps_only_the_admitted_slot_lanes(model):
    """One admission step over a hybrid cache changes only the admitted
    slot's lanes of the conv and ssm states and of every shared-block
    call's k and v."""
    _, _, cfg, params = model
    server = serve.BatchedServer(cfg, params, 3, 16, device="cpu")
    server.cache = init_cache(cfg, 3, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tensors = dict(server.cache["mamba"], sa_k=server.cache["sa_k"],
                   sa_v=server.cache["sa_v"])
    for t in tensors.values():
        t.normal_(generator=gen)
    server.cache["lengths"].copy_(torch.tensor([4, 2, 9], dtype=torch.int32))
    before = {n: t.clone() for n, t in tensors.items()}
    server._admit_step(7, 1)
    for name, t in tensors.items():
        assert torch.equal(t[:, [0, 2]], before[name][:, [0, 2]]), name
        assert not torch.equal(t[:, 1], before[name][:, 1]), name
    for name in ("sa_k", "sa_v"):
        changed = (server.cache[name] != before[name]).any(dim=(0, 2, 4))
        assert changed.nonzero().tolist() == [[1, 2]], name
    assert server.cache["lengths"].tolist() == [4, 3, 9]


def test_serve_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--requests", "3", "--slots", "2",
        "--prompt-len", "4", "--max-new", "2", "--device", "cpu"])
    before = (ops.attention.launches, ops.decode_attention.launches)
    serve.main()
    assert f"[serve] {ARCH}: 3 requests, 6 tokens" in capsys.readouterr().out
    assert (ops.attention.launches, ops.decode_attention.launches) == before
