"""The port's mixture-of-experts layers (``repro_torch.models.moe``,
``models.shardctx``) against the reference's (``repro.models.moe``).

Both MoE architectures run at their reduced float32 size with the
reference's own parameters (``repro.models.init_params``, handed over by
``params_from_reference``) on the CPU.  The dispatch is compared element
for element (the same routing into both packers), the layer's output
and aux loss within rtol 1e-4, atol 1e-5 — the tolerance of
``test_torch_lm.py``: the two frameworks compute the same float32
operations in other orders — at capacity factors 0.5 (tokens dropped),
1.25 (the published) and 8.0 (none dropped), on one data shard and on
two (``activation_sharding(..., dp_size=2)``, where each shard packs its
own capacity rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.models import moe as ref_moe
from repro.models.shardctx import activation_sharding as ref_sharding
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill, prefill_forward)
from repro_torch.models import moe
from repro_torch.models.convert import params_from_reference
from repro_torch.models.shardctx import activation_sharding, dp_shards

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 24


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference config, reference params, port config, port
    params) — the port's parameters are the reference's, handed over."""
    out = {}
    for i, arch in enumerate(ARCHS):
        ref_cfg = ref_configs.get_reduced(arch)
        ref_params = ref_models.init_params(jax.random.PRNGKey(10 + i),
                                            ref_cfg)
        cfg = configs.get_reduced(arch)
        params = params_from_reference(jax.device_get(ref_params), cfg,
                                       device="cpu")
        out[arch] = (ref_cfg, ref_params, cfg, params)
    return out


def _layer(models, arch, i=0):
    """Layer ``i``'s FFN parameters in both packages."""
    ref_cfg, ref_params, cfg, params = models[arch]
    ref_ffn = jax.tree.map(lambda a: a[i], ref_params["layers"])["ffn"]
    return ref_cfg, ref_ffn, cfg, params["layers"][i]["ffn"]


def _hidden(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _tokens(cfg, seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _sharding(ctx, cfg, dp):
    return ctx(("data",), None, 1, B, cfg.d_model, cfg.vocab, dp_size=dp)


def _ref_dispatch(x, weights, experts, e, cap, ns):
    """The reference's per-shard packing, vmapped over ``ns`` shards."""
    t, d = x.shape
    k = weights.shape[-1]
    return jax.vmap(lambda xs, ws, es: ref_moe._pack_one_shard(
        xs, ws, es, e, cap))(jnp.asarray(x).reshape(ns, t // ns, d),
                             jnp.asarray(weights).reshape(ns, t // ns, k),
                             jnp.asarray(experts).reshape(ns, t // ns, k))


def _port_dispatch(x, weights, experts, e, cap, ns):
    t, d = x.shape
    k = weights.shape[-1]
    return moe._dispatch(torch.tensor(x).reshape(ns, t // ns, d),
                         torch.tensor(weights).reshape(ns, t // ns, k),
                         torch.tensor(experts).long()
                         .reshape(ns, t // ns, k), e, cap)


def _assert_dispatch_equal(got, want):
    xb, buf_tok, buf_valid, buf_w = (np.asarray(a) for a in want)
    assert np.array_equal(got.buf_tok.numpy(), buf_tok)
    assert np.array_equal(got.buf_valid.numpy(), buf_valid)
    assert np.array_equal(got.buf_w.numpy(), buf_w)
    assert np.array_equal(got.xb.numpy(), xb)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_reference(models, arch, cf, dp):
    ref_cfg, ref_ffn, cfg, ffn = _layer(models, arch)
    ref_cfg = ref_cfg.replace(capacity_factor=cf)
    cfg = cfg.replace(capacity_factor=cf)
    x = _hidden(cfg, 1)
    with _sharding(ref_sharding, ref_cfg, dp):
        want, want_aux = ref_moe.moe_forward(ref_ffn, jnp.asarray(x),
                                             ref_cfg)
    with _sharding(activation_sharding, cfg, dp):
        assert dp_shards() == dp
        got, aux = moe.moe_forward(ffn, torch.from_numpy(x), cfg)
    assert dp_shards() == 1                       # the context is closed
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)
    # how many pairs each shard dropped: some at 0.5, none at 8.0
    weights, experts, _ = moe._route(ffn["router"],
                                     torch.from_numpy(x).reshape(-1,
                                                                 cfg.d_model),
                                     cfg)
    cap = moe.expert_capacity(cfg, B * S // dp)
    counts = torch.stack([torch.bincount(e.flatten(),
                                         minlength=cfg.n_experts)
                          for e in experts.reshape(dp, -1)])
    dropped = int((counts - cap).clamp(min=0).sum())
    if cf == 0.5:
        assert dropped > 0
    if cf == 8.0:
        assert dropped == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_data_shards_change_the_function_as_in_the_reference(models, arch):
    """Under a tight capacity each shard drops its own late tokens, so
    ``dp_size=2`` gives another output than one shard — in both
    packages, by the same amount."""
    ref_cfg, ref_ffn, cfg, ffn = _layer(models, arch)
    ref_cfg = ref_cfg.replace(capacity_factor=0.5)
    cfg = cfg.replace(capacity_factor=0.5)
    x = _hidden(cfg, 2)
    outs = {}
    for dp in (1, 2):
        with _sharding(ref_sharding, ref_cfg, dp):
            want = np.asarray(ref_moe.moe_forward(ref_ffn, jnp.asarray(x),
                                                  ref_cfg)[0])
        with _sharding(activation_sharding, cfg, dp):
            got = moe.moe_forward(ffn, torch.from_numpy(x), cfg)[0].numpy()
        outs[dp] = want, got
    ref_gap = np.abs(outs[2][0] - outs[1][0]).max()
    gap = np.abs(outs[2][1] - outs[1][1]).max()
    assert ref_gap > 1e-3
    np.testing.assert_allclose(gap, ref_gap, rtol=1e-4)
    # batch_axes None: dp_size does not count, as in the reference
    with activation_sharding(None, None, 1, B, cfg.d_model, cfg.vocab,
                             dp_size=2):
        assert dp_shards() == 1
    # B·S not a multiple of the shards: one shard
    with _sharding(activation_sharding, cfg, 2):
        odd = moe.moe_forward(ffn, torch.from_numpy(x[:1, :7]), cfg)[0]
    _close(odd, moe.moe_forward(ffn, torch.from_numpy(x[:1, :7]), cfg)[0],
           rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference_with_lower_index_first_on_ties(models,
                                                                 arch):
    ref_cfg, ref_ffn, cfg, ffn = _layer(models, arch)
    x = _hidden(cfg, 3).reshape(-1, cfg.d_model)
    w_ref, e_ref, aux_ref = ref_moe._route(ref_ffn["router"],
                                           jnp.asarray(x), ref_cfg)
    w, e, aux = moe._route(ffn["router"], torch.from_numpy(x), cfg)
    assert np.array_equal(e.numpy(), np.asarray(e_ref))
    _close(w, w_ref)
    _close(aux, aux_ref)
    # ties: a router whose logits tie experts pairwise
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[0, ::-1] = np.repeat(np.arange(cfg.n_experts // 2), 2)
    _, e_ref, _ = ref_moe._route(jnp.asarray(router), jnp.asarray(x),
                                 ref_cfg)
    _, e, _ = moe._route(torch.from_numpy(router), torch.from_numpy(x), cfg)
    assert np.array_equal(e.numpy(), np.asarray(e_ref))
    tied = np.asarray(e_ref)[x[:, 0] > 0]
    assert (tied[:, 0] < tied[:, 1]).all()         # the lower index first


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_drops_the_reference_tokens(models, arch, dp):
    """A zero router ties every expert for every token: the reference
    routes each to experts 0..k-1, so those experts overflow and the
    later tokens of each shard drop — the same tokens in the port."""
    ref_cfg, ref_ffn, cfg, ffn = _layer(models, arch)
    ref_ffn = dict(ref_ffn, router=jnp.zeros_like(ref_ffn["router"]))
    ffn = dict(ffn, router=torch.zeros_like(ffn["router"]))
    x = _hidden(cfg, 4)
    flat = x.reshape(-1, cfg.d_model)
    w_ref, e_ref, _ = ref_moe._route(ref_ffn["router"], jnp.asarray(flat),
                                     ref_cfg)
    w, e, _ = moe._route(ffn["router"], torch.from_numpy(flat), cfg)
    assert (np.asarray(e_ref) == np.arange(cfg.top_k)).all()
    assert np.array_equal(e.numpy(), np.asarray(e_ref))
    cap = moe.expert_capacity(cfg, B * S // dp)
    assert cap < B * S // dp                       # some tokens drop
    want = _ref_dispatch(flat, np.asarray(w_ref), np.asarray(e_ref),
                         cfg.n_experts, cap, dp)
    got = _port_dispatch(flat, w.numpy(), e.numpy(), cfg.n_experts, cap, dp)
    _assert_dispatch_equal(got, want)
    kept = got.buf_tok.view(dp, cfg.n_experts, cap)[:, 0]
    assert (kept == torch.arange(cap)).all()       # the earliest tokens
    with _sharding(ref_sharding, ref_cfg, dp):
        y_ref, _ = ref_moe.moe_forward(ref_ffn, jnp.asarray(x), ref_cfg)
    with _sharding(activation_sharding, cfg, dp):
        y, _ = moe.moe_forward(ffn, torch.from_numpy(x), cfg)
    _close(y, y_ref)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_buffers_match_reference(models, arch, cf, dp):
    """The reference's routing into both packers: buf_tok, buf_valid,
    buf_w and the packed rows equal element for element; every kept pair
    is found at its slot, every dropped one at the dump slot."""
    ref_cfg, ref_ffn, cfg, _ = _layer(models, arch)
    cfg = cfg.replace(capacity_factor=cf)
    x = _hidden(cfg, 5).reshape(-1, cfg.d_model)
    w_ref, e_ref, _ = ref_moe._route(ref_ffn["router"], jnp.asarray(x),
                                     ref_cfg)
    w_ref, e_ref = np.asarray(w_ref), np.asarray(e_ref)
    e, cap = cfg.n_experts, moe.expert_capacity(cfg, B * S // dp)
    got = _port_dispatch(x, w_ref, e_ref, e, cap, dp)
    _assert_dispatch_equal(got, _ref_dispatch(x, w_ref, e_ref, e, cap, dp))
    slots = got.pair_slot.reshape(dp, -1)
    kept = slots < e * cap
    assert int(kept.sum()) == int(got.buf_valid.sum())
    rows = torch.gather(got.buf_tok, 1, slots.clamp(max=e * cap - 1))
    tok = torch.arange(B * S // dp).repeat_interleave(cfg.top_k)
    assert (rows[kept] == tok.expand(dp, -1)[kept]).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_reference(arch):
    for cf in (0.5, 1.0, 1.25, 4.0, 8.0, 15.0):
        cfg = configs.get(arch).replace(capacity_factor=cf)
        ref = ref_configs.get(arch).replace(capacity_factor=cf)
        for n in (1, 2, 7, 8, 24, 100, 127, 128, 1000, 8191, 8192, 32768):
            assert moe.expert_capacity(cfg, n) == \
                ref_moe.expert_capacity(ref, n), (cf, n)
    qwen = configs.get("qwen2-moe-a2.7b")
    assert moe.expert_capacity(qwen, 8192) == 688
    assert moe.expert_capacity(qwen, 1) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """The port of ``tests/test_archs.py``'s case for the MoE archs, at
    capacity_factor 8.0 (no drops, so stepping decode equals the full
    forward), with the reference's parameters."""
    _, _, cfg, params = models[arch]
    cfg = cfg.replace(capacity_factor=8.0)
    toks = torch.from_numpy(_tokens(cfg, 6, (B, 16)))
    logits_par, _ = forward(params, toks, cfg)
    cache = init_cache(cfg, B, 20, device="cpu")
    outs = []
    for t in range(16):
        lg, cache = decode_step(params, cache, toks[:, t:t + 1], cfg)
        outs.append(lg)
    err = float((logits_par - torch.stack(outs, 1)).abs().max())
    assert err < 2e-3, err


def test_moe_capacity_drops_degrade_gracefully(models):
    """The port of ``tests/test_archs.py``'s case: mixtral at
    capacity_factor 0.5 drops tokens and stays finite — and equals the
    reference's logits and aux."""
    ref_cfg, ref_params, cfg, params = models["mixtral-8x7b"]
    ref_cfg = ref_cfg.replace(capacity_factor=0.5)
    cfg = cfg.replace(capacity_factor=0.5)
    toks = _tokens(cfg, 7, (B, 16))
    logits, aux = forward(params, torch.from_numpy(toks), cfg)
    assert bool(torch.isfinite(logits).all())      # drops zero-fill, no NaN
    want, want_aux = ref_models.forward(ref_params, jnp.asarray(toks),
                                        ref_cfg)
    _close(logits, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_forward_with_drops_matches_reference(models, arch):
    """prefill_forward at capacity_factor 0.5 (the prompt's late tokens
    drop) then a decode step: logits and caches as the reference's."""
    ref_cfg, ref_params, cfg, params = models[arch]
    ref_cfg = ref_cfg.replace(capacity_factor=0.5)
    cfg = cfg.replace(capacity_factor=0.5)
    toks = _tokens(cfg, 8, (B, S))
    ref_last, ref_cache = ref_models.prefill_forward(
        ref_params, jnp.asarray(toks[:, :-1]), ref_cfg, S + 4)
    last, cache = prefill_forward(params, torch.from_numpy(toks[:, :-1]),
                                  cfg, S + 4)
    _close(last, ref_last)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    ref_logits, _ = ref_models.decode_step(ref_params, ref_cache,
                                           jnp.asarray(toks[:, -1:]), ref_cfg)
    logits, _ = decode_step(params, cache, torch.from_numpy(toks[:, -1:]),
                            cfg)
    _close(logits, ref_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_prefill_matches_reference(models, arch):
    """``prefill`` (decode steps over the prompt) from an empty cache."""
    ref_cfg, ref_params, cfg, params = models[arch]
    toks = _tokens(cfg, 9, (B, 10))
    ref_logits, ref_cache = ref_models.prefill(
        ref_params, ref_models.init_cache(ref_cfg, B, 16), jnp.asarray(toks),
        ref_cfg)
    logits, cache = prefill(params, init_cache(cfg, B, 16, device="cpu"),
                            torch.from_numpy(toks), cfg)
    _close(logits, ref_logits)
    _close(cache["k"], ref_cache["k"])
    _close(cache["v"], ref_cache["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    for get, ref_get in ((configs.get, ref_configs.get),
                         (configs.get_reduced, ref_configs.get_reduced)):
        cfg, ref = get(arch), ref_get(arch)
        for f in dataclasses.fields(ref):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
        assert cfg.n_params() == ref.n_params()
    assert set(configs.all_configs()) == set(ref_configs.ARCHS)
    assert arch in configs.all_configs()
    assert configs.get("qwen2-moe-a2.7b").n_params() == 14_315_634_688
    assert configs.get("mixtral-8x7b").n_params() == 46_702_788_608


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_moe_tree_bit_for_bit(arch, dtype):
    """The router, the stacked (L, E, d, f) expert weights, the shared
    expert and its gate come across unstacked, bit for bit."""
    ref_cfg = ref_configs.get_reduced(arch).replace(param_dtype=dtype)
    cfg = configs.get_reduced(arch).replace(param_dtype=dtype)
    tree = jax.device_get(ref_models.init_params(jax.random.PRNGKey(3),
                                                 ref_cfg))
    params = params_from_reference(tree, cfg, device="cpu")
    names = ["router", "w_gate", "w_up", "w_down"]
    if cfg.n_shared_experts:
        names += ["shared_gate", "shared/w_gate", "shared/w_up",
                  "shared/w_down"]
    for i in range(cfg.n_layers):
        for name in names:
            want, got = tree["layers"]["ffn"], params["layers"][i]["ffn"]
            for part in name.split("/"):
                want, got = want[part], got[part]
            want = np.asarray(want[i])
            assert tuple(got.shape) == want.shape, name
            if want.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16
                assert np.array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16)), name
            else:
                assert np.array_equal(got.numpy(), want), name


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_has_the_reference_shapes_and_scales(arch):
    cfg = configs.get_reduced(arch)
    params = init_params(0, cfg, device="cpu")
    ref = jax.eval_shape(lambda: ref_models.init_params(
        jax.random.PRNGKey(0), ref_configs.get_reduced(arch)))
    flat = jax.tree_util.tree_flatten_with_path(ref["layers"]["ffn"])[0]
    for path, leaf in flat:
        got = params["layers"][0]["ffn"]
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == leaf.shape[1:], path
        assert str(got.dtype).removeprefix("torch.") == leaf.dtype.name
    ffn = params["layers"][0]["ffn"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    assert ffn["router"].dtype == torch.float32
    assert ("shared" in ffn) == (cfg.n_shared_experts > 0)
    for name, fan_in in (("router", d), ("w_gate", d), ("w_up", d),
                         ("w_down", f)):
        std = float(ffn[name].std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.1, (name, std)
    assert ffn["w_gate"].shape == (e, d, f)
    again = init_params(0, cfg, device="cpu")["layers"][0]["ffn"]
    assert torch.equal(ffn["w_down"], again["w_down"])


def test_combine_is_repeatable_and_drops_add_nothing(models):
    """Two identical calls give the same bits; a dropped pair adds
    nothing to its token (all-dropped tokens come back as the shared
    expert alone)."""
    _, _, cfg, ffn = _layer(models, "qwen2-moe-a2.7b")
    x = torch.from_numpy(_hidden(cfg, 11))
    cfg = cfg.replace(capacity_factor=0.25)
    a, _ = moe.moe_forward(ffn, x, cfg)
    b, _ = moe.moe_forward(ffn, x, cfg)
    assert torch.equal(a, b)
    zero = dict(ffn, router=torch.zeros_like(ffn["router"]))
    y, _ = moe.moe_forward(zero, x, cfg)
    cap = moe.expert_capacity(cfg, B * S)
    shared = moe._shared_expert(ffn, x.reshape(-1, cfg.d_model), cfg)
    torch.testing.assert_close(y.reshape(-1, cfg.d_model)[cap:], shared[cap:],
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_moe_archs_on_the_cpu(monkeypatch, capsys, arch):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--requests", "3", "--slots", "2",
        "--prompt-len", "4", "--max-new", "2", "--device", "cpu"])
    serve.main()
    assert f"[serve] {arch}: 3 requests, 6 tokens" in \
        capsys.readouterr().out
