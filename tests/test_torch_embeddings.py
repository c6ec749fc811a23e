"""The port's last two architectures against the reference's, on their
reduced configurations: internvl2-2b, whose inputs are precomputed patch
embeddings (``input_mode="embeddings"``: (B, S, d) in ``forward`` and
``prefill_forward``, (B, 1, d) or (B, 1) ids in ``decode_step``), and
musicgen-medium, a token model with LayerNorm (weight and bias, eps
1e-5), a GELU GLU and an untied head.

The reference's own parameters (``repro.models.init_params``, handed over
by ``params_from_reference``) run at float32 on the CPU, where the
attention wrappers run their plain versions.  Inputs are drawn with
numpy from a seed.  Tolerances: logits, caches and layer outputs within
rtol 1e-4, atol 1e-5 (``TOL``, as ``test_torch_lm.py``); the loss within
rtol 1e-6 and every gradient leaf within relative L2 1e-5
(``GRAD_REL_L2``, as ``test_torch_train.py``); a train step's parameters
and moments within relative L2 1e-4 (``STATE_REL_L2``); served token
streams exactly equal.
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
from repro.launch import train as ref_train
from repro.models import layers as ref_layers
from repro.optim import AdamW as RefAdamW
from repro.runtime.train_step import init_train_state as ref_init_state
from repro.runtime.train_step import make_train_step as ref_train_step
from repro_torch import configs
from repro_torch.checkpoint import snapshot
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, loss_fn, prefill,
                                prefill_forward)
from repro_torch.models import layers
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference)
from repro_torch.optim import AdamW
from repro_torch.runtime import make_train_step
from repro_torch.runtime.train_step import value_and_grad

VLM, AUDIO = "internvl2-2b", "musicgen-medium"
ARCHS = [VLM, AUDIO]
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_L2 = 1e-5
STATE_REL_L2 = 1e-4
LR = 1e-3
B, S = 2, 20


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference config, reference params, port config, port
    params) — the port's parameters are the reference's, handed over."""
    out = {}
    for i, arch in enumerate(ARCHS):
        ref_cfg = ref_configs.get_reduced(arch)
        ref_params = ref_models.init_params(jax.random.PRNGKey(30 + i),
                                            ref_cfg)
        cfg = configs.get_reduced(arch)
        params = params_from_reference(jax.device_get(ref_params), cfg,
                                       device="cpu")
        out[arch] = (ref_cfg, ref_params, cfg, params)
    return out


def _inputs(cfg, seed, lead):
    """An embeddings config's (lead..., d) float32 standard-normal
    inputs, a token config's (lead...) int32 ids."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return rng.standard_normal(lead + (cfg.d_model,)).astype(np.float32)
    return rng.integers(0, cfg.vocab, lead).astype(np.int32)


def _ids(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _cache_close(cache, ref_cache):
    assert set(cache) == set(ref_cache) == {"k", "v", "lengths"}
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        _close(cache[name], ref_cache[name])
    assert cache["lengths"].tolist() == np.asarray(
        ref_cache["lengths"]).tolist()


# -- configuration and parameters ----------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference_field_by_field(arch):
    for get, ref_get in ((configs.get, ref_configs.get),
                         (configs.get_reduced, ref_configs.get_reduced)):
        cfg, ref = get(arch), ref_get(arch)
        for f in dataclasses.fields(ref):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
        assert cfg.n_params() == ref.n_params()
    assert configs.get(VLM).n_params() == 1_889_144_832
    assert configs.get(AUDIO).n_params() == 1_818_378_240
    assert configs.get(VLM).input_mode == "embeddings"
    assert configs.get(AUDIO).input_mode == "tokens"
    assert configs.ARCHS == ref_configs.ARCHS
    assert set(configs.all_configs()) == set(ref_configs.ARCHS)
    assert not hasattr(configs, "NOT_PORTED")
    with pytest.raises(KeyError):
        configs.get("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_reference_bit_for_bit(models, arch):
    """Every leaf comes across bit for bit — musicgen's LayerNorm biases
    and both models' untied heads among them — and the port's own init
    builds the same tree."""
    _, ref_params, cfg, params = models[arch]
    want = jax.tree.leaves(jax.device_get(ref_params))
    got = snapshot(params).arrays
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert params["lm_head"].shape == (cfg.d_model, cfg.vocab)
    if cfg.norm == "layernorm":
        assert set(params["final_norm"]) == {"w", "b"}
        assert set(params["layers"][0]["norm2"]) == {"w", "b"}
    own = init_params(0, cfg, device="cpu")
    assert [a.shape for a in snapshot(own).arrays] == [w.shape for w in want]


def test_layernorm_and_gelu_glu_match_reference(models):
    """musicgen's parts: LayerNorm with its bias at eps 1e-5 and the
    tanh-approximated GELU GLU, on the reference's parameters."""
    ref_cfg, ref_params, cfg, params = models[AUDIO]
    assert cfg.norm_eps == 1e-5 and cfg.activation == "gelu"
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, 7, cfg.d_model)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(cfg.d_model).astype(np.float32)
    b = rng.standard_normal(cfg.d_model).astype(np.float32)
    _close(layers.layernorm(torch.from_numpy(w), torch.from_numpy(b),
                            torch.from_numpy(x), cfg.norm_eps),
           ref_layers.layernorm(jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(x), ref_cfg.norm_eps))
    ffn = jax.tree.map(lambda a: a[0], ref_params["layers"]["ffn"])
    _close(layers.glu_mlp(params["layers"][0]["ffn"], torch.from_numpy(x),
                          "gelu", torch.float32),
           ref_layers.glu_mlp(ffn, jnp.asarray(x), "gelu", jnp.float32))


def test_rope_at_theta_1e6_over_8k_positions():
    """internvl2's rope (θ = 1e6, head dim 128) at positions 0-8191,
    where the angles reach 8,191 radians.  The two packages' float32
    ``pow`` differ by one ulp in 4 of the 64 frequencies, which moves an
    angle at position 8,191 by up to 6.1e-5 rad and a rotated element by
    up to 6.1e-5 |x| (|x| < 5.5 here): atol 5e-4 holds that, not more."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8192, 128)).astype(np.float32)
    pos = np.arange(8192, dtype=np.int32)
    theta = configs.get(VLM).rope_theta
    assert theta == 1e6
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=1e-4, atol=5e-4)


# -- forward, loss, gradient ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(models, arch):
    ref_cfg, ref_params, cfg, params = models[arch]
    inputs = _inputs(cfg, 5, (B, S))
    want, _ = ref_models.forward(ref_params, jnp.asarray(inputs), ref_cfg)
    got, aux = forward(params, torch.from_numpy(inputs), cfg)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)
    labels = _ids(cfg, 6, (B, S))
    labels[:, :3] = -1
    batch = {"inputs": inputs, "labels": labels}
    ref_loss, ref_m = ref_models.loss_fn(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)
    loss, m = loss_fn(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    assert float(m["tokens"]) == float(ref_m["tokens"]) == B * (S - 3)


def test_embeddings_take_no_embed_scale(models):
    """An embeddings input is only cast: scaling it moves the logits as
    scaling the first residual would, and the embed table is unused."""
    _, _, cfg, params = models[VLM]
    x = torch.from_numpy(_inputs(cfg, 7, (1, 6)))
    base, _ = forward(params, x, cfg)
    zero_table = dict(params, embed=torch.zeros_like(params["embed"]))
    same, _ = forward(zero_table, x, cfg)
    assert torch.equal(base, same)
    moved, _ = forward(params, x * 2, cfg)
    assert not torch.allclose(base, moved)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_matches_reference(models, arch):
    """``loss_fn`` under autograd, every leaf against
    ``jax.value_and_grad``; internvl2's embed table gets a zero gradient
    in both (its inputs are embeddings)."""
    ref_cfg, ref_params, cfg, params = models[arch]
    batch = {"inputs": _inputs(cfg, 8, (B, S)), "labels": _ids(cfg, 9,
                                                               (B, S))}
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
        assert g.shape == w.shape and np.all(np.isfinite(g))
        if not np.any(w != 0):
            assert not np.any(g != 0)
            continue
        assert _rel_l2(g, w) <= GRAD_REL_L2
    embed_grad = grads["embed"]
    assert bool(embed_grad.eq(0).all()) == (cfg.input_mode == "embeddings")


@pytest.mark.parametrize("arch,microbatches", [(VLM, 1), (VLM, 2),
                                               (AUDIO, 1)])
def test_train_steps_match_reference(arch, microbatches):
    """Two steps of ``make_train_step`` against the reference's jitted
    step on the same batches — internvl2's inputs (B, S, d), or (mb,
    B/mb, S, d) with microbatches — its parameters, moments and every
    metric."""
    ref_cfg = ref_configs.get_reduced(arch)
    ref_state = ref_init_state(jax.random.PRNGKey(40), ref_cfg,
                               RefAdamW(lr=LR))
    cfg = configs.get_reduced(arch)
    state = train_state_from_reference(jax.device_get(ref_state), cfg,
                                       device="cpu")
    ref_step = jax.jit(ref_train_step(ref_cfg, RefAdamW(lr=LR),
                                      microbatches))
    step = make_train_step(cfg, AdamW(lr=LR), microbatches)
    lead = (microbatches, B // microbatches) if microbatches > 1 else (B,)
    for i in range(2):
        batch = {"inputs": _inputs(cfg, 20 + i, lead + (S,)),
                 "labels": _ids(cfg, 30 + i, lead + (S,))}
        ref_state, ref_m = ref_step(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        assert set(m) == set(ref_m)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5, atol=1e-7)
    for ref_tree, tree in ((ref_state.params, state.params),
                           (ref_state.opt_state.m, state.opt_state.m),
                           (ref_state.opt_state.v, state.opt_state.v)):
        for g, w in zip(snapshot(tree).arrays,
                        jax.tree.leaves(jax.device_get(ref_tree))):
            assert _rel_l2(g, w) <= STATE_REL_L2
    assert int(state.step) == int(ref_state.step) == 2


# -- serving --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_reference(models, arch):
    """prefill_forward's last logits and cache, then decode steps against
    the reference's: internvl2 decodes two positions as (B, 1, d)
    embeddings and two as (B, 1) ids through the embed table (the
    reference's two rules), musicgen four ids; the last logits against
    the full forward."""
    ref_cfg, ref_params, cfg, params = models[arch]
    prompt, max_len = S - 4, S + 4
    inputs = _inputs(cfg, 10, (B, S))
    ref_last, ref_cache = ref_models.prefill_forward(
        ref_params, jnp.asarray(inputs[:, :prompt]), ref_cfg, max_len)
    last, cache = prefill_forward(params, torch.from_numpy(
        inputs[:, :prompt]), cfg, max_len)
    _close(last, ref_last)
    _cache_close(cache, ref_cache)
    k = cache["k"]
    ids = _ids(cfg, 11, (B, 2))
    steps = [inputs[:, t:t + 1] for t in range(prompt, S)]
    if cfg.input_mode == "embeddings":
        steps = steps[:2] + [ids[:, :1], ids[:, 1:]]
    for tok in steps:
        ref_logits, ref_cache = ref_models.decode_step(
            ref_params, ref_cache, jnp.asarray(tok), ref_cfg)
        logits, cache = decode_step(params, cache, torch.from_numpy(tok),
                                    cfg)
        _close(logits, ref_logits)
    assert cache["k"] is k
    _cache_close(cache, ref_cache)
    if cfg.input_mode == "tokens":
        full, _ = forward(params, torch.from_numpy(inputs), cfg)
        _close(logits, full[:, -1].numpy(), rtol=1e-3, atol=2e-4)


def test_decode_on_ids_is_decode_on_their_table_rows(models):
    """internvl2's two decode branches agree: (B, 1) ids give the logits
    and cache of their embed-table rows handed in as (B, 1, d)."""
    _, _, cfg, params = models[VLM]
    assert not cfg.embed_scale
    inputs = torch.from_numpy(_inputs(cfg, 12, (B, 9)))
    ids = torch.from_numpy(_ids(cfg, 13, (B, 1)))
    outs = []
    for tok in (ids, params["embed"][ids.long()]):
        _, cache = prefill_forward(params, inputs, cfg, 12)
        logits, cache = decode_step(params, cache, tok, cfg)
        outs.append((logits, cache["k"], cache["v"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_embedding_prefill_by_decode_steps_matches_reference(models):
    """``prefill`` (decode steps over the prompt) on (B, S, d)
    embeddings, from an empty cache, against the reference's
    ``decode_step`` over the same positions.  (The reference's ``prefill``
    scans ``tokens.T``, which takes (B, S) ids only.)"""
    ref_cfg, ref_params, cfg, params = models[VLM]
    inputs = _inputs(cfg, 14, (B, 8))
    ref_cache = ref_models.init_cache(ref_cfg, B, 12)
    for t in range(inputs.shape[1]):
        ref_logits, ref_cache = ref_models.decode_step(
            ref_params, ref_cache, jnp.asarray(inputs[:, t:t + 1]), ref_cfg)
    logits, cache = prefill(params, init_cache(cfg, B, 12, device="cpu"),
                            torch.from_numpy(inputs), cfg)
    _close(logits, ref_logits)
    _cache_close(cache, ref_cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_streams_equal_reference(models, arch):
    """``BatchedServer`` serves both configs as the reference's class
    does: token prompts through the embed table, more requests than
    slots; every token stream and the final cache equal the reference's."""
    ref_cfg, ref_params, cfg, params = models[arch]
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, cfg.vocab, 4 + i % 3, dtype=np.int32)
               for i in range(5)]
    ref_server = ref_serve.BatchedServer(ref_cfg, ref_params, 2, 32)
    server = serve.BatchedServer(cfg, params, 2, 32, device="cpu")
    for i, p in enumerate(prompts):
        ref_server.submit(ref_serve.Request(id=i, prompt=p, max_new=3 + i))
        server.submit(serve.Request(id=i, prompt=p, max_new=3 + i))
    ref_reqs, reqs = list(ref_server.queue), list(server.queue)
    steps = 0
    while any(server.slots) or server.queue:
        server.step()
        ref_server.step()
        steps += 1
        assert steps < 100
    assert not any(ref_server.slots) and not ref_server.queue
    assert [r.tokens for r in reqs] == [r.tokens for r in ref_reqs]
    _cache_close(server.cache, ref_server.cache)


# -- the command lines -------------------------------------------------------------

@pytest.mark.parametrize("cli,ref_cli,argv", [
    (serve.main, ref_serve.main, ["--arch", VLM]),
    (train_cli.main, ref_train.main, ["--arch", VLM, "--reduced",
                                      "--steps", "1"])])
def test_clis_refuse_an_embeddings_arch_as_the_reference(monkeypatch, cli,
                                                         ref_cli, argv):
    """Both launchers refuse internvl2 with the reference's
    ``SystemExit``, word for word, before building anything."""
    monkeypatch.setattr("sys.argv", ["prog"] + argv)
    with pytest.raises(SystemExit) as ref_exit:
        ref_cli()
    with pytest.raises(SystemExit) as port_exit:
        cli(argv + ["--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value)
    assert VLM in str(port_exit.value)


def test_serve_main_runs_musicgen_on_the_cpu(capsys):
    serve.main(["--arch", AUDIO, "--requests", "3", "--slots", "2",
                "--prompt-len", "4", "--max-new", "2", "--device", "cpu"])
    assert f"[serve] {AUDIO}: 3 requests, 6 tokens" in \
        capsys.readouterr().out
