"""The port's Mamba-1 serving path (``repro_torch.models.mamba``, the
mamba1 branches of ``models.transformer``, ``launch.serve``) against the
reference's, on the reduced falcon-mamba-7b.

The reference's own parameters (``repro.models.init_params``, handed over
by ``params_from_reference``) run at float32 on the CPU, where the scan
wrapper runs its plain version.  Tolerances are ``test_torch_lm.TOL``:
float32 logits, states and caches within rtol 1e-4, atol 1e-5 (the two
frameworks compute the same float32 operations in other orders); served
token streams exactly equal.
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
from repro.models import mamba as ref_mamba
from repro_torch import configs
from repro_torch.kernels.mamba_scan import ops
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, prefill, prefill_forward)
from repro_torch.models import mamba
from repro_torch.models.convert import params_from_reference

ARCH = "falcon-mamba-7b"
TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 24


@pytest.fixture(scope="module")
def model():
    """(reference config, reference params, port config, port params) —
    the port's parameters are the reference's, handed over."""
    ref_cfg = ref_configs.get_reduced(ARCH)
    ref_params = ref_models.init_params(jax.random.PRNGKey(7), ref_cfg)
    cfg = configs.get_reduced(ARCH)
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


def test_params_from_reference_keep_the_float32_leaves():
    """A bfloat16 falcon-mamba tree hands over leaf for leaf: projections
    stay bfloat16, dt_bias, A_log and D stay float32."""
    ref_cfg = ref_configs.get_reduced(ARCH).replace(param_dtype="bfloat16")
    tree = jax.device_get(ref_models.init_params(jax.random.PRNGKey(1),
                                                 ref_cfg))
    cfg = configs.get_reduced(ARCH).replace(param_dtype="bfloat16")
    params = params_from_reference(tree, cfg, device="cpu")
    assert len(params["layers"]) == cfg.n_layers
    for i in (0, cfg.n_layers - 1):
        mixer = params["layers"][i]["mixer"]
        for name, leaf in tree["layers"]["mixer"].items():
            want = np.asarray(leaf[i])
            got = mixer[name]
            assert tuple(got.shape) == want.shape, name
            assert str(got.dtype).split(".")[-1] == want.dtype.name, name
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
        for name in ("dt_bias", "A_log", "D"):
            assert mixer[name].dtype == torch.float32


def test_port_init_has_the_reference_tree_layout():
    """The port's own random init (a torch.Generator) gives the leaves the
    reference's init gives, by shape and dtype, in bfloat16 too."""
    for dtype in ("float32", "bfloat16"):
        cfg = configs.get_reduced(ARCH).replace(param_dtype=dtype)
        ref_cfg = ref_configs.get_reduced(ARCH).replace(param_dtype=dtype)
        want = jax.eval_shape(lambda k: ref_models.init_params(k, ref_cfg),
                              jax.random.PRNGKey(0))
        params = init_params(0, cfg, device="cpu")
        mixer = params["layers"][0]["mixer"]
        assert set(mixer) == set(want["layers"]["mixer"])
        for name, leaf in want["layers"]["mixer"].items():
            assert tuple(mixer[name].shape) == leaf.shape[1:], name
            assert str(mixer[name].dtype).split(".")[-1] == leaf.dtype.name
        assert torch.equal(mixer["A_log"][3], torch.log(
            torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32)))
        dt = torch.nn.functional.softplus(mixer["dt_bias"])
        assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
        assert torch.equal(params["embed"],
                           init_params(0, cfg, device="cpu")["embed"])


def test_causal_conv_with_and_without_state_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32)
    for state in (None, st):
        y_r, s_r = ref_mamba._causal_conv(
            *map(jnp.asarray, (x, w, b)),
            None if state is None else jnp.asarray(state))
        y, s = mamba._causal_conv(
            *map(torch.from_numpy, (x, w, b)),
            None if state is None else torch.from_numpy(state))
        _close(y, y_r)
        _close(s, s_r)
        assert s.is_contiguous() and s.shape == (2, 3, 16)


def test_mixer_forward_and_decode_match_reference(model):
    ref_cfg, ref_params, cfg, params = model
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    ref_p = _ref_layer(ref_params, 1)["mixer"]
    p = params["layers"][1]["mixer"]
    y_r, st_r = ref_mamba.mamba1_forward(ref_p, jnp.asarray(x), ref_cfg,
                                         return_state=True)
    y, st = mamba.mamba1_forward(p, torch.from_numpy(x), cfg)
    _close(y, y_r)
    for name in ("conv", "ssm"):
        _close(st[name], st_r[name])
    assert st["ssm"].dtype == torch.float32
    xt = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    y_r, st_r = ref_mamba.mamba1_decode(ref_p, jnp.asarray(xt), st_r,
                                        ref_cfg)
    y, st = mamba.mamba1_decode(p, torch.from_numpy(xt), st, cfg)
    _close(y, y_r)
    for name in ("conv", "ssm"):
        _close(st[name], st_r[name])
    cache = mamba.mamba1_init_cache(cfg, 3, device="cpu")
    ref_cache = ref_mamba.mamba1_init_cache(ref_cfg, 3)
    for name in ("conv", "ssm"):
        assert tuple(cache[name].shape) == ref_cache[name].shape
        assert cache[name].eq(0).all()


def test_forward_logits_match_reference(model):
    ref_cfg, ref_params, cfg, params = model
    toks = _tokens(cfg, 4, (B, S))
    want, _ = ref_models.forward(ref_params, jnp.asarray(toks), ref_cfg)
    got, aux = forward(params, torch.from_numpy(toks), cfg)
    assert got.shape == (B, S, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_then_decode_match_reference(model):
    """prefill_forward's last logits and conv/ssm caches, then a run of
    decode_step logits and caches, against the reference's."""
    ref_cfg, ref_params, cfg, params = model
    toks = _tokens(cfg, 5, (B, S))
    prompt, max_len = S - 5, S + 8
    ref_last, ref_cache = ref_models.prefill_forward(
        ref_params, jnp.asarray(toks[:, :prompt]), ref_cfg, max_len)
    last, cache = prefill_forward(params, torch.from_numpy(toks[:, :prompt]),
                                  cfg, max_len)
    _close(last, ref_last)
    assert set(cache) == {"lengths", "mamba"}
    for name in ("conv", "ssm"):
        assert tuple(cache["mamba"][name].shape) == \
            ref_cache["mamba"][name].shape
        _close(cache["mamba"][name], ref_cache["mamba"][name])
    assert cache["lengths"].tolist() == [prompt] * B
    ssm = cache["mamba"]["ssm"]
    for t in range(prompt, S):
        ref_logits, ref_cache = ref_models.decode_step(
            ref_params, ref_cache, jnp.asarray(toks[:, t:t + 1]), ref_cfg)
        logits, cache = decode_step(params, cache,
                                    torch.from_numpy(toks[:, t:t + 1]), cfg)
        _close(logits, ref_logits)
    assert cache["mamba"]["ssm"] is ssm                  # written in place
    for name in ("conv", "ssm"):
        _close(cache["mamba"][name], ref_cache["mamba"][name])
    assert cache["lengths"].tolist() == np.asarray(
        ref_cache["lengths"]).tolist()
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
    for name in ("conv", "ssm"):
        _close(cache["mamba"][name], ref_cache["mamba"][name])


@pytest.mark.parametrize("slots,requests", [(2, 5), (3, 4)])
def test_batched_server_streams_equal_reference(model, slots, requests):
    """More requests than slots, so slots are reused: a reused slot starts
    from the state its lanes hold and idle slots advance on token 0, in
    both packages.  Every token stream equals the reference's."""
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
    for name in ("conv", "ssm"):
        _close(server.cache["mamba"][name], ref_server.cache["mamba"][name])


def test_admission_keeps_only_the_admitted_slot_lanes(model):
    """One admission step over a mamba cache changes only the admitted
    slot's lanes of conv and ssm."""
    _, _, cfg, params = model
    server = serve.BatchedServer(cfg, params, 3, 16, device="cpu")
    server.cache = init_cache(cfg, 3, 16, device="cpu")
    for t in server.cache["mamba"].values():
        t.normal_(generator=torch.Generator().manual_seed(0))
    before = {n: t.clone() for n, t in server.cache["mamba"].items()}
    server._admit_step(7, 1)
    for name, t in server.cache["mamba"].items():
        assert torch.equal(t[:, [0, 2]], before[name][:, [0, 2]]), name
        assert not torch.equal(t[:, 1], before[name][:, 1]), name
    assert server.cache["lengths"].tolist() == [0, 1, 0]


def test_serve_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--requests", "3", "--slots", "2",
        "--prompt-len", "4", "--max-new", "2", "--device", "cpu"])
    before = ops.scan.launches
    serve.main()
    assert f"[serve] {ARCH}: 3 requests, 6 tokens" in capsys.readouterr().out
    assert ops.scan.launches == before


def test_config_copies_the_reference():
    cfg, ref = configs.get(ARCH), ref_configs.get(ARCH)
    assert cfg.n_params() == ref.n_params() == 7_273_709_568
    assert cfg.param_dtype_ == torch.bfloat16
    for f in ("n_layers", "d_model", "d_inner_", "ssm_state", "conv_kernel",
              "vocab", "layer_kind", "tie_embeddings", "norm", "norm_eps"):
        assert getattr(cfg, f) == getattr(ref, f), f
    red, ref_red = configs.get_reduced(ARCH), ref_configs.get_reduced(ARCH)
    assert red.compute_dtype_ == torch.float32
    for f in ("n_layers", "d_model", "d_inner_", "ssm_state", "vocab"):
        assert getattr(red, f) == getattr(ref_red, f), f
    assert ARCH in configs.all_configs()


@pytest.mark.cuda
def test_cuda_model_matches_cpu(cuda_device, model):
    """The reduced falcon-mamba on the card (the CUDA scan) against the
    same model on the CPU (the plain version): one scan launch per layer
    in a prefill and none in a decode step."""
    _, _, cfg, params = model

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda_device)

    dev_params = to(params)
    toks = torch.from_numpy(_tokens(cfg, 8, (B, S)))
    before = ops.scan.launches
    last, cache = prefill_forward(dev_params, toks[:, :-1].to(cuda_device),
                                  cfg, S + 4)
    assert ops.scan.launches - before == cfg.n_layers
    logits, cache = decode_step(dev_params, cache,
                                toks[:, -1:].to(cuda_device), cfg)
    assert ops.scan.launches - before == cfg.n_layers
    want_last, want_cache = prefill_forward(params, toks[:, :-1], cfg, S + 4)
    want, want_cache = decode_step(params, want_cache, toks[:, -1:], cfg)
    torch.testing.assert_close(last.cpu(), want_last, **TOL)
    torch.testing.assert_close(logits.cpu(), want, **TOL)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(cache["mamba"][name].cpu(),
                                   want_cache["mamba"][name], **TOL)
