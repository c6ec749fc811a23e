"""The training step as a MapReduce round.

The partner of ``repro/runtime/train_step.py``:

  map      — forward and backward on this worker's batch (autograd through
             ``models.loss_fn``; on the card the attention forward is the
             ``fwd_wgmma`` kernel, its gradient the chunked path's);
  combine  — local microbatch gradient accumulation in float32, the
             paper's combiner: pre-reduce before any communication;
  shuffle+reduce — the gradient all-reduce over a worker axis
             (``make_shardmap_train_step``): a mean, or the int8
             ``compressed_psum`` (smaller spill files);
  finalize — the optimizer update (+ the async checkpoint, in the
             Trainer).

The steps are functions of (state, batch) that return a new state and
leave the old one as it was, as the reference's jitted steps do.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..engine.plan import resolve_device
from ..models import ModelConfig, init_params, loss_fn
from ..models.transformer import check_ported
from ..optim import AdamW, TrainState, apply_updates
from ..optim.compression import compressed_psum
from ..optim.tree import tree_leaves, tree_map, tree_unflatten


def init_train_state(seed: int, cfg: ModelConfig, opt: AdamW,
                     device="cuda") -> TrainState:
    """Random parameters from ``seed`` (``models.init_params``), zero
    moments and step 0, on ``device``."""
    dev = resolve_device(device)
    check_ported(cfg, train_on=dev)
    params = init_params(seed, cfg, device=dev)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def value_and_grad(loss: Callable, params, batch, cfg: ModelConfig):
    """``((loss, metrics), grads)`` of ``loss(params, batch, cfg)`` — the
    gradient of every parameter leaf in its own dtype (zeros for a leaf
    the loss does not reach), metrics detached."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        value, metrics = loss(tree_unflatten(params, live), batch, cfg)
        grads = torch.autograd.grad(value, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return (value.detach(), metrics), tree_unflatten(params, grads)


def _on_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on ``device`` (numpy int32 batches
    from the data pipeline, or tensors already there)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _device(state: TrainState) -> torch.device:
    return tree_leaves(state.params)[0].device


def _finalize(opt: AdamW, state: TrainState, grads, metrics):
    updates, opt_state, stats = opt.update(grads, state.opt_state,
                                           state.params)
    params = apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), \
        {**metrics, **stats}


def make_train_step(cfg: ModelConfig, opt: AdamW, microbatches: int = 1,
                    loss: Callable | None = None):
    """``train_step(state, batch) -> (state, metrics)``.

    ``microbatches > 1``: the batch's leading axis is (microbatches,
    B/mb, S) and the gradients accumulate locally, in float32, before
    their mean — the combiner; the metrics are the last microbatch's."""
    loss = loss or loss_fn

    def train_step(state: TrainState, batch: dict):
        device = _device(state)
        check_ported(cfg, train_on=device)
        batch = _on_device(batch, device)
        if microbatches == 1:
            (_, metrics), grads = value_and_grad(loss, state.params, batch,
                                                 cfg)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            for i in range(microbatches):
                mb = {k: v[i] for k, v in batch.items()}
                (_, metrics), g = value_and_grad(loss, state.params, mb, cfg)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.float())
                del g
            for acc in tree_leaves(grads):
                acc.div_(microbatches)
        return _finalize(opt, state, grads, metrics)

    return train_step


def make_shardmap_train_step(cfg: ModelConfig, opt: AdamW, axis,
                             compress_grads: bool = False,
                             loss: Callable | None = None):
    """Explicit-collective train step over a worker axis
    (``engine.compile.DistributedAxis``: one ``torch.distributed`` rank a
    worker).  Every rank calls ``train_step(state, batch)`` with the same
    replicated state and the global batch; each takes its contiguous
    ``B / W`` rows, computes its gradients, and all-reduces them — a mean,
    or with ``compress_grads`` the int8 ``compressed_psum`` — and the
    metrics (a mean) before the same update."""
    loss = loss or loss_fn

    def pmean(x: torch.Tensor) -> torch.Tensor:
        return axis.psum(x) / axis.size

    def train_step(state: TrainState, batch: dict):
        device = _device(state)
        check_ported(cfg, train_on=device)
        batch = {k: axis.shard(v) for k, v in
                 _on_device(batch, device).items()}
        (_, metrics), grads = value_and_grad(loss, state.params, batch, cfg)
        grads = compressed_psum(grads, axis) if compress_grads \
            else tree_map(pmean, grads)
        metrics = {k: pmean(v) for k, v in metrics.items()}
        return _finalize(opt, state, grads, metrics)

    return train_step


def make_eval_step(cfg: ModelConfig, loss: Callable | None = None):
    """``eval_step(params, batch) -> metrics``, without gradients."""
    loss = loss or loss_fn

    def eval_step(params, batch: dict):
        device = tree_leaves(params)[0].device
        with torch.no_grad():
            _, metrics = loss(params, _on_device(batch, device), cfg)
        return metrics

    return eval_step


__all__ = ["init_train_state", "make_eval_step", "make_shardmap_train_step",
           "make_train_step", "value_and_grad"]
