"""zamba2-1.2b on the card (``cuda`` marker; skipped where torch sees no
CUDA device).

The reduced zamba2 (float32: the shared block's attention through
``fwd_rows`` and ``decode_cluster``) against the same model built with
``device="cpu"`` (the plain versions), within rtol 1e-4, atol 1e-5 as
``test_torch_lm.py``'s card test; zamba2 at full width in bfloat16 —
the shared block's attention at head dim 64, GQA group 1, through
``fwd_wgmma`` and ``decode_cluster`` — with its depth cut to 12 layers
(two calls of the shared block), the kernel path against the plain
versions in the kernels' places, the last logits within a relative L2 of
0.04 (``chip_smoke.LOGIT_TOL``'s: the plain and the kernel attention
round bfloat16 at other places); the whole model's launches, six of
each kernel a prefill and a decode step; and the SSD in float32 on the
card against the CPU at the full model's head shape, within a relative
L2 of 1e-5 (float32 sums in other orders, no TF32).
"""

import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (chunked_attention,
                                                     decode_ref)
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode_step, init_params, prefill_forward
from repro_torch.models import mamba

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-5)
FULL_WIDTH_REL_L2 = 0.04
SSD_REL_L2 = 1e-5


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _launches():
    return ops.attention.launches, ops.decode_attention.launches


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.cuda
def test_reduced_zamba2_on_the_card_matches_cpu(cuda_device):
    cfg = configs.get_reduced(ARCH)
    params = init_params(0, cfg, device="cpu")
    dev_params = _to(params, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 70)))
    before = _launches()
    last, cache = prefill_forward(dev_params, toks[:, :-1].to(cuda_device),
                                  cfg, 76)
    logits, cache = decode_step(dev_params, cache,
                                toks[:, -1:].to(cuda_device), cfg)
    calls = cfg.n_layers // cfg.shared_attn_every
    assert tuple(a - b for a, b in zip(_launches(), before)) == (calls,) * 2
    want_last, want_cache = prefill_forward(params, toks[:, :-1], cfg, 76)
    want, want_cache = decode_step(params, want_cache, toks[:, -1:], cfg)
    torch.testing.assert_close(last.cpu(), want_last, **TOL)
    torch.testing.assert_close(logits.cpu(), want, **TOL)
    for name in ("sa_k", "sa_v"):
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   **TOL)
    for name in ("conv", "ssm"):
        torch.testing.assert_close(cache["mamba"][name].cpu(),
                                   want_cache["mamba"][name], **TOL)


@pytest.mark.cuda
def test_full_width_kernel_path_against_plain(cuda_device):
    cfg = configs.get(ARCH).replace(n_layers=12)
    assert ops.forward_kernel(torch.bfloat16, cfg.head_dim_) == "fwd_wgmma"
    params = init_params(0, cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, 301))).to(cuda_device)
    before = _launches()
    last, cache = prefill_forward(params, toks[:, :-1], cfg, 320)
    logits, _ = decode_step(params, cache, toks[:, -1:], cfg)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (2, 2)
    calls = attn_mod.attention, attn_mod.decode_attention
    attn_mod.attention, attn_mod.decode_attention = (chunked_attention,
                                                     decode_ref)
    try:
        plain_last, plain_cache = prefill_forward(params, toks[:, :-1], cfg,
                                                  320)
        plain, _ = decode_step(params, plain_cache, toks[:, -1:], cfg)
    finally:
        attn_mod.attention, attn_mod.decode_attention = calls
    for got, want in ((last, plain_last), (logits, plain)):
        assert bool(torch.isfinite(got).all())
        assert _rel_l2(got, want) <= FULL_WIDTH_REL_L2


@pytest.mark.cuda
def test_full_model_launches_six_of_each_kernel(cuda_device):
    cfg = configs.get(ARCH)
    params = init_params(0, cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 200))).to(cuda_device)
    before = _launches()
    last, cache = prefill_forward(params, toks, cfg, 210)
    after_prefill = _launches()
    assert after_prefill[0] - before[0] == 6
    assert after_prefill[1] == before[1]
    token = last.argmax(dim=-1, keepdim=True)
    for _ in range(2):
        logits, cache = decode_step(params, cache, token, cfg)
        token = logits.argmax(dim=-1, keepdim=True)
    assert _launches() == (after_prefill[0], after_prefill[1] + 12)
    assert bool(torch.isfinite(logits).all())
    assert cache["lengths"].tolist() == [202]


@pytest.mark.cuda
def test_ssd_on_the_card_matches_cpu(cuda_device):
    gen = torch.Generator().manual_seed(4)
    b, slen, h, p, n = 1, 1024, 64, 64, 64
    x = torch.randn((b, slen, h, p), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, slen, h),
                                                  generator=gen))
    a = -torch.arange(1, h + 1, dtype=torch.float32)
    bm = torch.randn((b, slen, n), generator=gen)
    cm = torch.randn((b, slen, n), generator=gen)
    args = (x, dt, a, bm, cm)
    want_y, want_s = mamba._ssd_chunked(*args, 64)
    y, s = mamba._ssd_chunked(*(t.to(cuda_device) for t in args), 64)
    assert _rel_l2(y.cpu(), want_y) <= SSD_REL_L2
    assert _rel_l2(s.cpu(), want_s) <= SSD_REL_L2
