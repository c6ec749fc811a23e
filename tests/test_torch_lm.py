"""The port's LM serving path (``repro_torch.models``,
``repro_torch.launch.serve``) against the reference's.

Each attention architecture the port serves — gemma2-9b (windows,
softcaps, sandwich norms, GeGLU, (1 + w) norms, tied embeddings),
qwen3-32b (qk-norm), stablelm-12b (partial rotary, LayerNorm), yi-34b
(plain GQA), and the mixture-of-experts qwen2-moe-a2.7b (a shared expert
behind a sigmoid gate) and mixtral-8x7b (windows on every layer) — runs
at its reduced float32 size with the reference's own
parameters (``repro.models.init_params``, handed over by
``params_from_reference``) on the CPU, where the attention wrappers run
their plain versions.

Tolerances: float32 logits and caches within rtol 1e-4, atol 1e-5 — the
two frameworks compute the same float32 operations in other orders (the
observed difference is under 1e-5); served token streams exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro import configs as ref_configs
from repro import models as ref_models
from repro.launch import serve as ref_serve
from repro.models.attention import attn_decode as ref_attn_decode
from repro.models.attention import window_schedule as ref_windows
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, loss_fn, prefill,
                                prefill_forward)
from repro_torch.models.attention import (attn_decode, cache_write_pos,
                                          window_schedule)
from repro_torch.models.convert import params_from_reference

ARCHS = ["gemma2-9b", "qwen3-32b", "stablelm-12b", "yi-34b",
         "qwen2-moe-a2.7b", "mixtral-8x7b"]
TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 24


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference config, reference params, port config, port
    params) — the port's parameters are the reference's, handed over."""
    out = {}
    for i, arch in enumerate(ARCHS):
        ref_cfg = ref_configs.get_reduced(arch)
        ref_params = ref_models.init_params(jax.random.PRNGKey(i), ref_cfg)
        cfg = configs.get_reduced(arch)
        params = params_from_reference(jax.device_get(ref_params), cfg,
                                       device="cpu")
        out[arch] = (ref_cfg, ref_params, cfg, params)
    return out


def _tokens(cfg, seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss_match(models, arch):
    ref_cfg, ref_params, cfg, params = models[arch]
    toks = _tokens(cfg, 1, (B, S))
    want, ref_aux = ref_models.forward(ref_params, jnp.asarray(toks),
                                       ref_cfg)
    got, aux = forward(params, torch.from_numpy(toks), cfg)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert (float(aux) > 0) == cfg.is_moe       # the router losses, summed
    _close(aux, ref_aux)
    _close(got, want)
    labels = toks.copy()
    labels[:, :3] = -1
    ref_loss, _ = ref_models.loss_fn(
        ref_params, {"inputs": jnp.asarray(toks),
                     "labels": jnp.asarray(labels)}, ref_cfg)
    loss, metrics = loss_fn(params, {"inputs": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(labels)},
                            cfg)
    _close(loss, ref_loss)
    assert float(metrics["tokens"]) == B * (S - 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match(models, arch):
    """prefill_forward's last logits and k/v caches, then a run of
    decode_step logits, against the reference's.  An MoE model runs at
    capacity_factor 8.0, where nothing drops, so that the full forward's
    last logits equal decoding's too."""
    ref_cfg, ref_params, cfg, params = models[arch]
    if cfg.is_moe:
        ref_cfg = ref_cfg.replace(capacity_factor=8.0)
        cfg = cfg.replace(capacity_factor=8.0)
    toks = _tokens(cfg, 2, (B, S))
    prompt, max_len = S - 4, S + 8
    ref_last, ref_cache = ref_models.prefill_forward(
        ref_params, jnp.asarray(toks[:, :prompt]), ref_cfg, max_len)
    last, cache = prefill_forward(params, torch.from_numpy(toks[:, :prompt]),
                                  cfg, max_len)
    _close(last, ref_last)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == tuple(ref_cache[name].shape)
        _close(cache[name], ref_cache[name])
    assert cache["lengths"].tolist() == [prompt] * B
    for t in range(prompt, S):
        ref_logits, ref_cache = ref_models.decode_step(
            ref_params, ref_cache, jnp.asarray(toks[:, t:t + 1]), ref_cfg)
        logits, cache = decode_step(params, cache,
                                    torch.from_numpy(toks[:, t:t + 1]), cfg)
        _close(logits, ref_logits)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    assert cache["lengths"].tolist() == np.asarray(
        ref_cache["lengths"]).tolist()
    # the full-sequence forward's logits at the last position agree too
    full, _ = forward(params, torch.from_numpy(toks), cfg)
    _close(logits, full[:, -1].numpy(), rtol=1e-3, atol=2e-3)


def test_token_prefill_matches_reference(models):
    """``prefill`` (decode steps over the prompt) from an empty cache."""
    ref_cfg, ref_params, cfg, params = models["gemma2-9b"]
    toks = _tokens(cfg, 3, (B, 10))
    ref_logits, ref_cache = ref_models.prefill(
        ref_params, ref_models.init_cache(ref_cfg, B, 16), jnp.asarray(toks),
        ref_cfg)
    logits, cache = prefill(params, init_cache(cfg, B, 16, device="cpu"),
                            torch.from_numpy(toks), cfg)
    _close(logits, ref_logits)
    _close(cache["k"], ref_cache["k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_streams_equal_reference(models, arch):
    """Five requests through two slots of 24 positions: the third request
    on a slot runs past max_len, where both packages clamp the cache
    write.  Every request's token stream equals the reference's."""
    ref_cfg, ref_params, cfg, params = models[arch]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 6, dtype=np.int32)
               for _ in range(5)]
    ref_server = ref_serve.BatchedServer(ref_cfg, ref_params, 2, 24)
    server = serve.BatchedServer(cfg, params, 2, 24, device="cpu")
    ref_reqs = [ref_serve.Request(id=i, prompt=p, max_new=5)
                for i, p in enumerate(prompts)]
    reqs = [serve.Request(id=i, prompt=p, max_new=5)
            for i, p in enumerate(prompts)]
    for r_ref, r in zip(ref_reqs, reqs):
        ref_server.submit(r_ref)
        server.submit(r)
    served = steps = 0
    while any(server.slots) or server.queue:
        served += server.step()
        ref_server.step()
        steps += 1
        assert steps < 100
    assert not any(ref_server.slots) and not ref_server.queue
    assert served == 5 * 5
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
    assert all(r.done and len(r.tokens) == 6 for r in reqs)
    assert int(server.cache["lengths"].max()) > 24     # clamped writes ran
    assert server.cache["lengths"].tolist() == np.asarray(
        ref_server.cache["lengths"]).tolist()


def test_merge_slot_keeps_only_the_slot_lane():
    old = torch.zeros(3, 4, 2)
    new = torch.ones(3, 4, 2)
    out = serve._merge_slot(new, old, 2)
    assert out[:, 2].eq(1).all() and out[:, [0, 1, 3]].eq(0).all()
    assert old.eq(0).all()
    lens = serve._merge_slot(torch.tensor([5, 6]), torch.tensor([1, 2]), 0)
    assert lens.tolist() == [5, 2]


def test_cache_write_clamps_past_max_len(models):
    """attn_decode writes the new k and v at each row's length in place;
    a length at or past the cache's end writes at its last position, as
    the reference's ``dynamic_update_slice`` clamps it."""
    ref_cfg, ref_params, cfg, params = models["gemma2-9b"]
    rng = np.random.default_rng(5)
    s_max, hd = 8, cfg.head_dim_
    shape = (3, cfg.n_kv_heads, s_max, hd)
    kc = rng.normal(size=shape).astype(np.float32)
    vc = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    lens = np.array([3, 8, 11], np.int32)
    ref_layer = jax.tree.map(lambda a: a[0], ref_params["layers"])["attn"]
    y_ref, k_ref, v_ref = ref_attn_decode(
        ref_layer, jnp.asarray(x), ref_cfg, window=0, k_cache=jnp.asarray(kc),
        v_cache=jnp.asarray(vc), lengths=jnp.asarray(lens))
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    y, k_out, v_out = attn_decode(params["layers"][0]["attn"],
                                  torch.from_numpy(x), cfg, window=0,
                                  k_cache=k_t, v_cache=v_t,
                                  lengths=torch.from_numpy(lens))
    assert k_out is k_t and v_out is v_t                 # written in place
    _close(k_t, k_ref)
    _close(v_t, v_ref)
    _close(y, y_ref)
    changed = (k_t.numpy() != kc).any(axis=(1, 3))
    assert changed.tolist() == [[p == w for p in range(s_max)]
                                for w in (3, 7, 7)]
    # the server's admission restores exactly the cells this position names
    assert cache_write_pos(torch.from_numpy(lens), s_max).tolist() == [3, 7, 7]


def test_window_schedule_matches_reference():
    for arch in ARCHS:
        for get, ref_get in ((configs.get, ref_configs.get),
                             (configs.get_reduced, ref_configs.get_reduced)):
            assert window_schedule(get(arch)) == \
                np.asarray(ref_windows(ref_get(arch))).tolist()
    ws = window_schedule(configs.get("gemma2-9b"))
    assert ws[0] == 4096 and ws[1] == 0 and len(ws) == 42


def test_configs_copy_the_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    for arch in ARCHS:
        cfg, ref = configs.get(arch), ref_configs.get(arch)
        assert cfg.n_params() == ref.n_params()
        assert cfg.param_dtype_ == torch.bfloat16
        assert configs.get_reduced(arch).compute_dtype_ == torch.float32
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim_", "d_ff", "vocab", "sliding_window",
                  "attn_softcap", "final_softcap", "rope_pct", "qk_norm",
                  "n_experts", "top_k", "expert_d_ff", "n_shared_experts",
                  "shared_expert_d_ff", "capacity_factor"):
            assert getattr(cfg, f) == getattr(ref, f), (arch, f)
    assert configs.get("gemma2-9b").n_params() == 9_241_401_344


def test_port_init_serves_on_the_cpu():
    """The port's own random init (a torch.Generator from the seed) gives
    finite logits and a server that drains, with no kernel launched."""
    cfg = configs.get_reduced("gemma2-9b")
    params = init_params(0, cfg, device="cpu")
    again = init_params(0, cfg, device="cpu")
    assert torch.equal(params["embed"], again["embed"])
    assert not torch.equal(params["embed"],
                           init_params(1, cfg, device="cpu")["embed"])
    assert len(params["layers"]) == cfg.n_layers
    assert params["layers"][0]["norm1"]["w"].eq(0).all()    # (1 + w) norms
    before = (ops.attention.launches, ops.decode_attention.launches)
    server = serve.BatchedServer(cfg, params, 2, 32, device="cpu")
    for i in range(3):
        server.submit(serve.Request(id=i, prompt=np.arange(4, dtype=np.int32)
                                    + i, max_new=3))
    while any(server.slots) or server.queue:
        server.step()
    assert (ops.attention.launches, ops.decode_attention.launches) == before


@pytest.mark.cuda
def test_cuda_model_matches_cpu(cuda_device, models):
    """The reduced gemma2 on the card (the CUDA kernels) against the same
    model on the CPU (the plain versions)."""
    _, _, cfg, params = models["gemma2-9b"]
    dev_params = _to(params, cuda_device)
    toks = torch.from_numpy(_tokens(cfg, 6, (B, S)))
    before = (ops.attention.launches, ops.decode_attention.launches)
    last, cache = prefill_forward(dev_params, toks[:, :-1].to(cuda_device),
                                  cfg, S + 4)
    logits, _ = decode_step(dev_params, cache, toks[:, -1:].to(cuda_device),
                            cfg)
    assert (ops.attention.launches - before[0],
            ops.decode_attention.launches - before[1]) == (cfg.n_layers,) * 2
    want_last, want_cache = prefill_forward(params, toks[:, :-1], cfg, S + 4)
    want, _ = decode_step(params, want_cache, toks[:, -1:], cfg)
    torch.testing.assert_close(last.cpu(), want_last, **TOL)
    torch.testing.assert_close(logits.cpu(), want, **TOL)


def test_serve_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "gemma2-9b", "--requests", "3", "--slots", "2",
        "--prompt-len", "4", "--max-new", "2", "--device", "cpu"])
    serve.main()
    assert "[serve] gemma2-9b: 3 requests, 6 tokens" in capsys.readouterr().out
