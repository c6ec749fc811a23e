"""internvl2-2b and musicgen-medium on the card (``cuda`` marker; skipped
where torch sees no CUDA device).

Per model, one prefill and one decode step at reduced size:

* the reduced config (float32: attention through ``fwd_rows`` and
  ``decode_cluster``) against the same model built with ``device="cpu"``
  (the plain versions), within rtol 1e-4, atol 1e-5 as
  ``test_torch_lm.py``'s card test — internvl2's prefill on (B, S, d)
  patch embeddings and its decode step on (B, 1, d) embeddings,
  musicgen's on token ids;
* full width in bfloat16 with the depth cut to 4 layers — internvl2's
  attention at head dim 128, GQA group 2, musicgen's at head dim 64,
  group 1, through ``fwd_wgmma`` and ``decode_cluster`` — the kernel
  path against the plain versions in the kernels' places, the last
  logits within a relative L2 of 0.04 (``chip_smoke.LOGIT_TOL``'s: the
  plain and the kernel attention round bfloat16 at other places), one
  launch of each kernel a layer.
"""

import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (chunked_attention,
                                                     decode_ref)
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode_step, init_params, prefill_forward

ARCHS = ["internvl2-2b", "musicgen-medium"]
TOL = dict(rtol=1e-4, atol=1e-5)
FULL_WIDTH_REL_L2 = 0.04


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


def _inputs(cfg, seed, s, device):
    """(1, s, d) standard-normal embeddings for an embeddings config,
    (1, s) ids otherwise, and the decode step's input: (1, 1, d) or
    (1, 1)."""
    gen = torch.Generator().manual_seed(seed)
    if cfg.input_mode == "embeddings":
        x = torch.randn((1, s + 1, cfg.d_model), generator=gen)
    else:
        x = torch.randint(0, cfg.vocab, (1, s + 1), generator=gen)
    return x[:, :-1].to(device), x[:, -1:].to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_model_on_the_card_matches_cpu(cuda_device, arch):
    cfg = configs.get_reduced(arch)
    params = init_params(0, cfg, device="cpu")
    dev_params = _to(params, cuda_device)
    prompt, step = _inputs(cfg, 1, 70, "cpu")
    before = _launches()
    last, cache = prefill_forward(dev_params, prompt.to(cuda_device), cfg,
                                  76)
    logits, cache = decode_step(dev_params, cache, step.to(cuda_device), cfg)
    assert tuple(a - b for a, b in zip(_launches(), before)) == \
        (cfg.n_layers,) * 2
    want_last, want_cache = prefill_forward(params, prompt, cfg, 76)
    want, want_cache = decode_step(params, want_cache, step, cfg)
    torch.testing.assert_close(last.cpu(), want_last, **TOL)
    torch.testing.assert_close(logits.cpu(), want, **TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(cache[name].cpu(), want_cache[name],
                                   **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_kernel_path_against_plain(cuda_device, arch):
    cfg = configs.get(arch).replace(n_layers=4)
    assert ops.forward_kernel(torch.bfloat16, cfg.head_dim_) == "fwd_wgmma"
    params = init_params(0, cfg, device=cuda_device)
    prompt, step = _inputs(cfg, 2, 300, cuda_device)
    before = _launches()
    last, cache = prefill_forward(params, prompt, cfg, 320)
    logits, _ = decode_step(params, cache, step, cfg)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (4, 4)
    calls = attn_mod.attention, attn_mod.decode_attention
    attn_mod.attention, attn_mod.decode_attention = (chunked_attention,
                                                     decode_ref)
    try:
        plain_last, plain_cache = prefill_forward(params, prompt, cfg, 320)
        plain, _ = decode_step(params, plain_cache, step, cfg)
    finally:
        attn_mod.attention, attn_mod.decode_attention = calls
    for got, want in ((last, plain_last), (logits, plain)):
        assert bool(torch.isfinite(got).all())
        assert _rel_l2(got, want) <= FULL_WIDTH_REL_L2
