"""Trainer — the fault-tolerant training driver.

The partner of ``repro/runtime/trainer.py``: the Coordinator pattern
(paper §III-A.1) applied to training.  All durable state (model and
optimizer checkpoint, step counter) lives in the storage and metadata
layers; the Trainer process itself is stateless and restartable:

  * **checkpoint/restart** — async sharded checkpoints every
    ``checkpoint_every`` steps and at the end of a run; on construction
    the Trainer resumes from the newest manifest (commit-point semantics,
    see ``checkpoint/checkpoint.py``), in the dtypes the manifest states;
  * **preemption simulation** — ``run(..., preempt_at=k)`` checkpoints and
    raises ``PreemptionError`` at step k; a fresh Trainer continues;
  * **fault injection** — a hook called every step may raise transient
    errors; the step is retried (idempotent: the step is a function of
    state and batch, and the batch is re-used), up to
    ``max_step_retries`` times, as the Coordinator retries a task.

Batches come as the caller yields them (numpy int32, ``(B, S)`` from
the data pipeline, or ``(microbatches, B, S)`` for the combiner); the
step moves them to the parameters' device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..core.metadata import MetadataStore
from ..core.storage import ObjectStore
from ..models import ModelConfig
from ..optim import AdamW, TrainState
from .train_step import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    """Checkpoint cadence and layout, the retry budget, the combiner's
    microbatches and the metrics cadence."""

    checkpoint_every: int = 50
    checkpoint_prefix: str = "ckpt"
    n_ckpt_shards: int = 4
    max_step_retries: int = 2
    microbatches: int = 1
    log_every: int = 10


class PreemptionError(RuntimeError):
    """Raised by ``Trainer.run`` at ``preempt_at``, after its checkpoint."""


class Trainer:
    """Restore-or-init, then ``run`` steps with retries, metrics and
    async checkpoints."""

    def __init__(self, cfg: ModelConfig, opt: AdamW, store: ObjectStore,
                 meta: MetadataStore | None = None,
                 tcfg: TrainerConfig | None = None, seed: int = 0,
                 fault_hook: Callable[[int], None] | None = None,
                 device="cuda") -> None:
        self.cfg = cfg
        self.opt = opt
        self.store = store
        self.meta = meta or MetadataStore()
        self.tcfg = tcfg or TrainerConfig()
        self.fault_hook = fault_hook
        self._step_fn = make_train_step(cfg, opt, self.tcfg.microbatches)
        self.ckpt = AsyncCheckpointer(store, self.tcfg.checkpoint_prefix,
                                      self.tcfg.n_ckpt_shards)
        # restore-or-init (the restart path)
        self.state: TrainState = init_train_state(seed, cfg, opt, device)
        self.start_step = 0
        last = latest_step(store, self.tcfg.checkpoint_prefix)
        if last is not None:
            self.state, _ = restore_checkpoint(
                store, self.tcfg.checkpoint_prefix, self.state, last)
            self.start_step = int(self.state.step)
        self.metrics_log: list[dict[str, float]] = []

    # -- the loop -------------------------------------------------------------
    def run(self, batches: Iterator[dict[str, np.ndarray]], num_steps: int,
            preempt_at: int | None = None) -> TrainState:
        """Train from ``start_step`` to ``num_steps`` on ``batches`` (the
        caller skips the batches a restored run already consumed);
        checkpoint at the end and return the state."""
        it = iter(batches)
        step = self.start_step
        t0 = time.perf_counter()
        while step < num_steps:
            batch = next(it)
            if preempt_at is not None and step >= preempt_at:
                self.ckpt.save(step, self.state)
                self.ckpt.wait()
                raise PreemptionError(f"preempted at step {step}")
            # task retry loop (transient worker failure → re-run, idempotent)
            attempt = 0
            while True:
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                    new_state, metrics = self._step_fn(self.state, batch)
                    break
                except PreemptionError:
                    raise
                except Exception:
                    attempt += 1
                    if attempt > self.tcfg.max_step_retries:
                        raise
            self.state = new_state
            step += 1
            if step % self.tcfg.log_every == 0 or step == num_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["steps_per_s"] = (step - self.start_step) / max(
                    1e-9, time.perf_counter() - t0)
                self.metrics_log.append(m)
                self.meta.set("train:step", step)
                self.meta.set("train:loss", m.get("loss"))
            if step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state)
        self.ckpt.save(step, self.state)
        self.ckpt.wait()
        return self.state

    def close(self) -> None:
        """Stop the checkpoint writer (after the queued writes); its
        thread holds the store until then."""
        self.ckpt.close()


__all__ = ["PreemptionError", "Trainer", "TrainerConfig"]
