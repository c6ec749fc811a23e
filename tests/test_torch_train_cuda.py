"""Training on the card (``cuda`` marker; skipped where torch sees no
CUDA device).

* The attention wrapper under autograd: forward through the kernel
  (``fwd_wgmma`` for bfloat16 at head dims 64/128/256, ``fwd_rows``
  otherwise) and the gradient of the chunked path, against the plain
  version (``chunked_attention`` under autograd, the keys in one block)
  on the same card tensors, one case with the wrapper's backward in
  blocks of 256 of 1,100 keys.  float32: output and gradients within rtol 1e-4 / atol 1e-5
  relative L2 1e-4; bfloat16: relative L2 2e-2 — the forward's P rounds
  to bfloat16 in the tensor cores, and the gradients are computed from
  the plain path's own bfloat16 output in both.
* ``scan`` and ``decode_attention`` raise on CUDA inputs that require
  grad, and run under ``torch.no_grad()``.
* A reduced bfloat16 gemma2 step on the card with remat: finite loss,
  two forward launches a layer (the forward and the recompute), none of
  decode; and its gradients against the same step with the plain
  attention swapped in, within relative L2 2e-2 a leaf.
"""

import numpy as np
import pytest
import torch

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import chunked_attention
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import loss_fn
from repro_torch.optim import AdamW
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import init_train_state, make_train_step
from repro_torch.runtime.train_step import value_and_grad


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


CASES = [  # b, hq, hkv, s, d, window, softcap, dtype, chunk
    (1, 4, 2, 300, 256, None, 50.0, torch.bfloat16, 1024),
    (2, 8, 8, 777, 128, 64, None, torch.bfloat16, 1024),
    (1, 4, 1, 129, 64, None, 30.0, torch.bfloat16, 1024),
    (1, 2, 1, 200, 96, 50, 50.0, torch.float32, 1024),
    (1, 4, 2, 1100, 128, None, 50.0, torch.bfloat16, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_attention_gradient_matches_plain(cuda_device, case):
    """The wrapper's gradient (its backward in blocks of ``chunk`` keys)
    against the plain version's with the keys in one block: one softmax,
    no rescaling between blocks."""
    b, hq, hkv, s, d, window, cap, dtype, chunk = case
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device,
                           dtype=torch.float32).mul_(2.0).to(dtype)

    q, k, v = rand(b, hq, s, d), rand(b, hkv, s, d), rand(b, hkv, s, d)
    dout = rand(b, hq, s, d)
    kw = dict(causal=True, window=window, softcap=cap)
    outs = []
    for fn, blocks in ((ops.attention, chunk), (chunked_attention, s)):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        before = ops.attention.launches
        out = fn(*leaves, chunk=blocks, **kw)
        grads = torch.autograd.grad(out, leaves, dout)
        outs.append((out.detach(), grads, ops.attention.launches - before))
    (out, grads, n), (want, want_grads, n_plain) = outs
    assert n == 1 and n_plain == 0       # the backward launches no kernel
    limit = 1e-4 if dtype == torch.float32 else 2e-2
    assert _rel_l2(out.float(), want.float()) <= limit
    for g, w in zip(grads, want_grads):
        assert g.dtype == w.dtype
        assert _rel_l2(g.float(), w.float()) <= limit


@pytest.mark.cuda
def test_attention_has_a_grad_fn_on_the_card(cuda_device):
    q = torch.randn(1, 2, 64, 64, device=cuda_device,
                    dtype=torch.bfloat16, requires_grad=True)
    out = ops.attention(q, q.detach(), q.detach(), causal=True)
    assert out.grad_fn is not None
    with pytest.raises(ValueError, match="q_offset"):
        ops.attention(q, q, q, q_offset=3)


@pytest.mark.cuda
def test_scan_and_decode_raise_on_inputs_that_require_grad(cuda_device):
    b, length, d, n = 1, 16, 32, 4
    u = torch.randn(b, length, d, device=cuda_device)
    delta = torch.rand(b, length, d, device=cuda_device) * 0.1
    a = -torch.rand(d, n, device=cuda_device)
    bb = torch.randn(b, length, n, device=cuda_device)
    dd = torch.randn(d, device=cuda_device)
    with pytest.raises(RuntimeError, match="no gradient"):
        scan_ops.scan(u.requires_grad_(True), delta, a, bb, bb, dd)
    with torch.no_grad():
        y, _ = scan_ops.scan(u, delta, a, bb, bb, dd)
    assert y.shape == (b, length, d)
    q = torch.randn(2, 4, 64, device=cuda_device, requires_grad=True)
    cache = torch.randn(2, 2, 32, 64, device=cuda_device)
    lengths = torch.tensor([5, 32], device=cuda_device)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q, cache, cache, lengths)
    with torch.no_grad():
        assert ops.decode_attention(q, cache, cache, lengths).shape == \
            (2, 4, 64)


@pytest.mark.cuda
def test_reduced_gemma_trains_on_the_card(cuda_device, monkeypatch):
    cfg = configs.get_reduced("gemma2-9b").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16", remat=True)
    opt = AdamW(lr=1e-3)
    state = init_train_state(0, cfg, opt, device=cuda_device)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 65))
    batch = {"inputs": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    before = (ops.attention.launches, ops.decode_attention.launches)
    new, m = make_train_step(cfg, opt)(state, batch)
    assert ops.attention.launches - before[0] == 2 * cfg.n_layers
    assert ops.decode_attention.launches == before[1]
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert int(new.step) == 1
    dev_batch = {k: torch.from_numpy(v).to(cuda_device)
                 for k, v in batch.items()}
    _, grads = value_and_grad(loss_fn, state.params, dev_batch, cfg)
    monkeypatch.setattr(attn_mod, "attention", chunked_attention)
    _, plain = value_and_grad(loss_fn, state.params, dev_batch, cfg)
    for g, w in zip(tree_leaves(grads), tree_leaves(plain)):
        assert _rel_l2(g.float(), w.float()) <= 2e-2
