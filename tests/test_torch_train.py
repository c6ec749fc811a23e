"""The port's training plane (``repro_torch.models.loss_fn`` under
autograd, ``runtime.train_step``, ``runtime.Trainer``,
``launch.train``) against the reference's.

Four reduced float32 architectures run on the CPU with the reference's
own parameters (``repro.models.init_params``, handed over by
``params_from_reference`` / ``train_state_from_reference``): gemma2-9b
(softcaps, windows, tied embeddings), qwen3-32b (qk-norm),
qwen2-moe-a2.7b (the router's aux loss in the loss) and falcon-mamba-7b
(autograd through the plain scan).

Tolerances, stated once:

* loss within rtol 1e-6 (observed differences ~1e-7 relative);
* every gradient leaf within a relative L2 error ``||port - ref|| /
  ||ref||`` of 1e-5 — the two frameworks sum the same float32 products in
  other orders (observed at most 2e-6);
* parameters and moments after 1 and 3 AdamW steps (lr 1e-3) within a
  relative L2 error of 1e-4 per leaf (observed at most 1.5e-5) and the
  parameters, element by element, within ``lr`` per step: Adam divides
  each element's first moment by the root of its second, so an element
  whose gradient is no bigger than the float32 noise between the
  frameworks can take a step of another size (up to ``lr``) in each —
  which is also why a leaf that starts at zero (gemma's norm weights)
  differs by more, relatively, than the gradients.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro import models as ref_models
from repro.checkpoint import save_checkpoint as ref_save_checkpoint
from repro.data import HashTokenizer as RefTokenizer
from repro.data import PackedLMDataset as RefDataset
from repro.data.pipeline import make_store_with_corpus as ref_corpus
from repro.kernels.flash_attention.ops import \
    chunked_attention as ref_chunked_attention
from repro.optim import AdamW as RefAdamW
from repro.runtime import Trainer as RefTrainer
from repro.runtime import TrainerConfig as RefTrainerConfig
from repro.runtime.train_step import init_train_state as ref_init_state
from repro.runtime.train_step import make_train_step as ref_train_step

from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.checkpoint import snapshot
from repro_torch.core.storage import MemoryStore
from repro_torch.data import HashTokenizer, PackedLMDataset
from repro_torch.data.pipeline import make_store_with_corpus
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import train as train_cli
from repro_torch.models import loss_fn
from repro_torch.models.convert import train_state_from_reference
from repro_torch.models.transformer import check_ported
from repro_torch.optim import AdamW
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import (PreemptionError, Trainer, TrainerConfig,
                                 init_train_state, make_eval_step,
                                 make_train_step)
from repro_torch.runtime.train_step import value_and_grad

ARCHS = ["gemma2-9b", "qwen3-32b", "qwen2-moe-a2.7b", "falcon-mamba-7b"]
LR = 1e-3
GRAD_REL_L2 = 1e-5
STATE_REL_L2 = 1e-4
B, S = 4, 16


@pytest.fixture(scope="module")
def states():
    """Per arch: (reference config, reference TrainState, port config,
    port TrainState) — the port's state is the reference's, handed
    over."""
    out = {}
    for i, arch in enumerate(ARCHS):
        ref_cfg = ref_configs.get_reduced(arch)
        ref_state = ref_init_state(jax.random.PRNGKey(i), ref_cfg,
                                   RefAdamW(lr=LR))
        cfg = configs.get_reduced(arch)
        state = train_state_from_reference(jax.device_get(ref_state), cfg,
                                           device="cpu")
        out[arch] = (ref_cfg, ref_state, cfg, state)
    return out


def _batch(cfg, seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, lead + (S + 1,)).astype(np.int32)
    labels = toks[..., 1:].copy()
    labels[..., :2] = -1                       # ignored positions
    return {"inputs": toks[..., :-1], "labels": labels}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _port_leaves(tree):
    """The port's tree as numpy leaves in the reference's order (its
    per-layer lists stacked), as a checkpoint holds them."""
    return snapshot(tree).arrays


def _gradient_parity(ref_cfg, ref_state, cfg, state):
    """``loss_fn``'s loss, metrics and every gradient leaf against
    ``jax.value_and_grad(repro.models.loss_fn)`` on the same batch; the
    port's gradient leaves, in the reference's order."""
    batch = _batch(cfg, 1)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(
        ref_models.loss_fn, has_aux=True)(
        ref_state.params, {k: jnp.asarray(v) for k, v in batch.items()},
        ref_cfg)
    (loss, metrics), grads = value_and_grad(
        loss_fn, state.params,
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["aux"]),
                               float(ref_metrics["aux"]), rtol=1e-5,
                               atol=1e-7)
    assert (float(metrics["aux"]) > 0) == cfg.is_moe
    assert float(metrics["tokens"]) == B * (S - 2)
    want = jax.tree.leaves(jax.device_get(ref_grads))
    got = _port_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.any(w != 0)
        assert _rel_l2(g, w) <= GRAD_REL_L2
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match(states, arch):
    _gradient_parity(*states[arch])


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-32b"])
def test_gradient_matches_reference_across_attention_chunks(states, arch):
    """Attention in chunks of 4 keys (``cfg.attn_chunk`` in both
    packages; S = 16, so four chunks): the gradient through the online
    softmax's rescaling between chunks holds against the reference's at
    the same chunk, with the tolerances above — and differs in its bits
    from the one-chunk gradient, so the chunk reached the attention."""
    ref_cfg, ref_state, cfg, state = states[arch]
    got = _gradient_parity(ref_cfg.replace(attn_chunk=4), ref_state,
                           cfg.replace(attn_chunk=4), state)
    one = _port_leaves(value_and_grad(
        loss_fn, state.params,
        {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()},
        cfg)[1])
    assert any(not np.array_equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen2-moe-a2.7b",
                                  "falcon-mamba-7b"])
def test_remat_on_equals_remat_off(states, arch):
    """``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``): the same loss and gradients, bit for
    bit, on the CPU."""
    _, _, cfg, state = states[arch]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    out = [value_and_grad(loss_fn, state.params, batch,
                          cfg.replace(remat=remat)) for remat in (False, True)]
    assert torch.equal(out[0][0][0], out[1][0][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, b)


def _params_close(ref_params, params, steps):
    want = jax.tree.leaves(jax.device_get(ref_params))
    got = _port_leaves(params)
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= STATE_REL_L2
        assert np.max(np.abs(g - w)) <= LR * steps


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(states, arch, microbatches):
    """1 and 3 steps of ``make_train_step`` against the reference's
    jitted step on the same batches: parameters, moments, count, step and
    every metric."""
    ref_cfg, ref_state, cfg, state = states[arch]
    ref_step = jax.jit(ref_train_step(ref_cfg, RefAdamW(lr=LR),
                                      microbatches))
    step = make_train_step(cfg, AdamW(lr=LR), microbatches)
    lead = (microbatches, B // microbatches) if microbatches > 1 else (B,)
    for i in range(3):
        batch = _batch(cfg, 10 + i, lead)
        ref_state, ref_m = ref_step(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        assert set(m) == set(ref_m)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-5, atol=1e-7)
        if i in (0, 2):
            _params_close(ref_state.params, state.params, i + 1)
            for ref_mom, mom in ((ref_state.opt_state.m, state.opt_state.m),
                                 (ref_state.opt_state.v, state.opt_state.v)):
                for g, w in zip(_port_leaves(mom),
                                jax.tree.leaves(jax.device_get(ref_mom))):
                    assert _rel_l2(g, w) <= STATE_REL_L2
    assert int(state.step) == int(ref_state.step) == 3
    assert int(state.opt_state.count) == 3


def test_eval_step_matches_loss(states):
    ref_cfg, ref_state, cfg, state = states["gemma2-9b"]
    batch = _batch(cfg, 3)
    _, ref_m = ref_models.loss_fn(
        ref_state.params, {k: jnp.asarray(v) for k, v in batch.items()},
        ref_cfg)
    m = make_eval_step(cfg)(state.params, batch)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-6)
    assert not m["loss"].requires_grad


def test_attention_q_offset_matches_reference():
    """The wrapper's ``q_offset`` (query row 0 at that position) against
    the reference's ``chunked_attention(..., q_offset=k)``, causal and
    windowed, within rtol 1e-5 / atol 1e-6 (float32, other orders)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 5, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    for offset, window in ((7, None), (3, 4), (0, 5)):
        want = ref_chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True,
                                     window=window, softcap=20.0,
                                     q_offset=offset, chunk=4)
        got = fa.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, window=window,
                           softcap=20.0, q_offset=offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_mamba_training_on_the_card_is_not_ported():
    cfg = configs.get_reduced("falcon-mamba-7b")
    check_ported(cfg, train_on="cpu")
    with pytest.raises(NotImplementedError, match="#13f"):
        check_ported(cfg, train_on="cuda")
    check_ported(configs.get_reduced("gemma2-9b"), train_on="cuda")


# -- the Trainer ----------------------------------------------------------------

CFG = "qwen3-32b"


def _batches(cfg, seed=0, batch=4, microbatches=1):
    """The synthetic corpus's ``(batch, 16)`` batches — as ``(microbatches,
    batch / microbatches, 16)`` for the combiner when ``microbatches > 1``
    (the Trainer passes batches on as they come, as the reference's
    does)."""
    store, prefix = make_store_with_corpus(20_000, vocab_words=300,
                                           seed=seed)
    it = iter(PackedLMDataset(store, prefix, HashTokenizer(cfg.vocab),
                              batch=batch, seq_len=16, seed=seed))
    if microbatches == 1:
        return it
    return ({k: v.reshape((microbatches, -1) + v.shape[1:])
             for k, v in b.items()} for b in it)


def test_trainer_matches_reference_trainer(states):
    """The port's Trainer, started from the reference's initial state (a
    checkpoint the reference wrote at step 0), against the reference's
    Trainer over the same 6 batches: the metrics log, the metadata and the
    parameters."""
    ref_cfg, _, cfg, _ = states[CFG]
    tc = dict(checkpoint_every=4, log_every=2)
    ref = RefTrainer(ref_cfg, RefAdamW(lr=LR), _RefStore(),
                     tcfg=RefTrainerConfig(**tc), seed=5)
    store = MemoryStore()
    ref_save_checkpoint(store, "ckpt", 0, ref.state)
    port = Trainer(cfg, AdamW(lr=LR), store, tcfg=TrainerConfig(**tc),
                   device="cpu")
    assert port.start_step == 0
    store_r, prefix = ref_corpus(20_000, vocab_words=300, seed=0)
    ref_state = ref.run(iter(RefDataset(store_r, prefix,
                                        RefTokenizer(ref_cfg.vocab),
                                        batch=4, seq_len=16)), 6)
    state = port.run(_batches(cfg), 6)
    _params_close(ref_state.params, state.params, 6)
    assert [m["step"] for m in port.metrics_log] == \
        [m["step"] for m in ref.metrics_log] == [2, 4, 6]
    for mine, theirs in zip(port.metrics_log, ref.metrics_log):
        for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5)
    assert port.meta.get("train:step") == 6
    np.testing.assert_allclose(port.meta.get("train:loss"),
                               ref.meta.get("train:loss"), rtol=1e-5)
    assert sorted(m.key.split("/")[1] for m in store.list_objects("ckpt/")
                  if m.key.endswith("MANIFEST.json")) == \
        ["step-00000000", "step-00000004", "step-00000006"]


class _RefStore:
    """A reference ``MemoryStore``, imported lazily so that the port's
    ``MemoryStore`` name stays the port's in this module."""

    def __new__(cls):
        from repro.core.storage import MemoryStore as RefMemoryStore
        return RefMemoryStore()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_preempt_restore_bitexact_continuation(microbatches):
    """Preempted at step 3, resumed by a fresh Trainer from the
    checkpoint: the same parameters, moments and losses as an
    uninterrupted run, bit for bit (bfloat16 parameters: the restored
    leaves are the saved bytes)."""
    cfg = configs.get_reduced(CFG).replace(param_dtype="bfloat16",
                                           compute_dtype="bfloat16")
    opt = AdamW(lr=LR)
    tc = TrainerConfig(checkpoint_every=2, log_every=1,
                       microbatches=microbatches)
    ref = Trainer(cfg, opt, MemoryStore(), tcfg=tc, seed=0, device="cpu")
    ref_state = ref.run(_batches(cfg, microbatches=microbatches), 6)

    store = MemoryStore()
    t1 = Trainer(cfg, opt, store, tcfg=tc, seed=0, device="cpu")
    with pytest.raises(PreemptionError):
        t1.run(_batches(cfg, microbatches=microbatches), 6, preempt_at=3)
    t2 = Trainer(cfg, opt, store, tcfg=tc, seed=0, device="cpu")
    assert t2.start_step == 3
    it = _batches(cfg, microbatches=microbatches)
    for _ in range(3):                      # data-cursor replay
        next(it)
    state = t2.run(it, 6)
    assert state.params["embed"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(ref_state), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [m["loss"] for m in ref.metrics_log[3:]] == \
        [m["loss"] for m in t2.metrics_log]


def test_checkpoint_cadence_matches_reference_trainer(states):
    """The steps the Trainer checkpoints, in order, are the reference
    Trainer's: every ``checkpoint_every`` steps and once more when ``run``
    ends (so a run that ends on a boundary writes its last step twice,
    the same state under the same keys), and a resumed Trainer with no
    step left writes its step again."""
    ref_cfg, _, cfg, _ = states[CFG]
    tc = dict(checkpoint_every=2)
    ref_saves: list[int] = []

    def spy(trainer):
        save = trainer.ckpt.save
        trainer.ckpt.save = lambda step, tree: (ref_saves.append(step),
                                                save(step, tree))
        return trainer

    ref_store = _RefStore()
    store_r, prefix = ref_corpus(20_000, vocab_words=300, seed=0)
    spy(RefTrainer(ref_cfg, RefAdamW(lr=LR), ref_store,
                   tcfg=RefTrainerConfig(**tc))).run(
        iter(RefDataset(store_r, prefix, RefTokenizer(ref_cfg.vocab),
                        batch=4, seq_len=16)), 4)
    spy(RefTrainer(ref_cfg, RefAdamW(lr=LR), ref_store,
                   tcfg=RefTrainerConfig(**tc))).run(iter(()), 4)
    store = MemoryStore()
    t = Trainer(cfg, AdamW(lr=LR), store, tcfg=TrainerConfig(**tc),
                device="cpu")
    t.run(_batches(cfg), 4)
    t2 = Trainer(cfg, AdamW(lr=LR), store, tcfg=TrainerConfig(**tc),
                 device="cpu")
    assert t2.start_step == 4
    t2.run(_batches(cfg), 4)
    mine = [r["step"] for r in t.ckpt.timings + t2.ckpt.timings]
    assert mine == ref_saves == [2, 4, 4, 4]
    t.close()
    t2.close()


def test_transient_fault_is_retried():
    cfg = configs.get_reduced(CFG)
    faults = {3}

    def hook(step):
        if step in faults:
            faults.discard(step)
            raise RuntimeError("flaky worker")

    t = Trainer(cfg, AdamW(lr=LR), MemoryStore(),
                tcfg=TrainerConfig(max_step_retries=2, checkpoint_every=100),
                fault_hook=hook, device="cpu")
    state = t.run(_batches(cfg), 5)
    assert int(state.step) == 5 and not faults
    t.close()
    t.ckpt._thread.join(timeout=10)
    assert not t.ckpt._thread.is_alive()


def test_fault_budget_exhaustion_raises():
    cfg = configs.get_reduced(CFG)
    calls = []

    def hook(step):
        if step == 2:
            calls.append(step)
            raise RuntimeError("dead node")

    t = Trainer(cfg, AdamW(lr=LR), MemoryStore(),
                tcfg=TrainerConfig(max_step_retries=1, checkpoint_every=100),
                fault_hook=hook, device="cpu")
    with pytest.raises(RuntimeError, match="dead node"):
        t.run(_batches(cfg), 5)
    assert calls == [2, 2]                  # the first try and one retry


def test_elastic_remesh_restore():
    """A state saved by 8 'hosts' restores onto 3 and training continues
    from it."""
    cfg = configs.get_reduced(CFG)
    opt = AdamW(lr=LR)
    state = init_train_state(0, cfg, opt, device="cpu")
    store = MemoryStore()
    save_checkpoint(store, "ckpt", 42, state, n_shards=8)
    restored, step = restore_checkpoint(store, "ckpt", state)
    assert step == 42
    save_checkpoint(store, "ckpt2", step, restored, n_shards=3)
    r2, _ = restore_checkpoint(store, "ckpt2", state)
    for a, b in zip(tree_leaves(state), tree_leaves(r2)):
        assert torch.equal(a, b)
    new, _ = make_train_step(cfg, opt)(r2, next(_batches(cfg)))
    assert int(new.step) == 1


def test_cli_on_the_cpu(capsys):
    train_cli.main(["--arch", "gemma2-9b", "--reduced", "--device", "cpu",
                    "--steps", "4", "--batch", "4", "--seq", "16",
                    "--corpus-words", "20000", "--ckpt-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] gemma2-9b: ")
    assert out[0].endswith("resuming from step 0")
    last = json.loads(out[-1])
    assert last["step"] == 4 and np.isfinite(last["loss"])
