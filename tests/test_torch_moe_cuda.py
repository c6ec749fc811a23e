"""The mixture-of-experts models on the card (``cuda`` marker; skipped
where torch sees no CUDA device).

The reduced MoE models with the attention kernels against the same
models built with ``device="cpu"`` (the plain versions), within rtol
1e-4, atol 1e-5 as ``test_torch_lm.py``'s card test; the dispatch on
CUDA tensors against the CPU's bit for bit, for a random router and for
a zero router (every token tied); two identical bfloat16 calls equal bit
for bit (the combine gathers, it does not scatter with atomics); and a
bfloat16 layer against the same layer in float32 on the card — the
routing identical (the router is float32 in both), the output within a
relative L2 of 1e-2 (bfloat16 rounds the buffers, the gate and up
products and their product, each at most 2^-9 relative).
"""

import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import decode_step, init_params, prefill_forward
from repro_torch.models import moe

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_moe_model_matches_cpu(cuda_device, arch):
    cfg = configs.get_reduced(arch)
    params = init_params(0, cfg, device="cpu")
    dev_params = _to(params, cuda_device)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    before = (ops.attention.launches, ops.decode_attention.launches)
    last, cache = prefill_forward(dev_params, toks[:, :-1].to(cuda_device),
                                  cfg, 28)
    logits, _ = decode_step(dev_params, cache, toks[:, -1:].to(cuda_device),
                            cfg)
    assert (ops.attention.launches - before[0],
            ops.decode_attention.launches - before[1]) == (cfg.n_layers,) * 2
    want_last, want_cache = prefill_forward(params, toks[:, :-1], cfg, 28)
    want, _ = decode_step(params, want_cache, toks[:, -1:], cfg)
    torch.testing.assert_close(last.cpu(), want_last, **TOL)
    torch.testing.assert_close(logits.cpu(), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_on_the_card_equals_cpu(cuda_device, arch, zero_router):
    cfg = configs.get_reduced(arch)
    ffn = init_params(0, cfg, device="cpu")["layers"][0]["ffn"]
    router = torch.zeros_like(ffn["router"]) if zero_router \
        else ffn["router"]
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    flat = x.reshape(-1, cfg.d_model)
    weights, experts, _ = moe._route(router, flat, cfg)
    dev_w, dev_e, _ = moe._route(router.to(cuda_device),
                                 flat.to(cuda_device), cfg)
    if zero_router:           # every token tied: experts 0..k-1 everywhere
        assert (dev_e.cpu() == torch.arange(cfg.top_k)).all()
        assert torch.equal(dev_e.cpu(), experts)
    for ns in (1, 2):
        cap = moe.expert_capacity(cfg, flat.shape[0] // ns)
        shape = (ns, flat.shape[0] // ns)
        want = moe._dispatch(flat.reshape(*shape, -1),
                             weights.reshape(*shape, -1),
                             experts.reshape(*shape, -1), cfg.n_experts, cap)
        got = moe._dispatch(flat.to(cuda_device).reshape(*shape, -1),
                            weights.to(cuda_device).reshape(*shape, -1),
                            experts.to(cuda_device).reshape(*shape, -1),
                            cfg.n_experts, cap)
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a.cpu(), b), (ns, name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_layer_on_the_card(cuda_device, arch):
    cfg = configs.get_reduced(arch)
    f32 = cfg.replace(capacity_factor=0.5)
    bf16 = f32.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    ffn = init_params(0, bf16, device="cuda")["layers"][0]["ffn"]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    h = torch.randn((2, 64, cfg.d_model), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    a, aux = moe.moe_forward(ffn, h, bf16)
    b, _ = moe.moe_forward(ffn, h, bf16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    flat = h.reshape(-1, cfg.d_model)
    _, experts, _ = moe._route(ffn["router"], flat, bf16)
    _, experts32, _ = moe._route(ffn["router"], flat.float(), f32)
    assert torch.equal(experts, experts32)
    want, want_aux = moe.moe_forward(_to_float(ffn), h.float(), f32)
    rel = float((a.float() - want).norm() / want.norm())
    assert rel < 1e-2, rel
    torch.testing.assert_close(aux, want_aux, rtol=0, atol=0)


def _to_float(tree):
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    return tree.float()
