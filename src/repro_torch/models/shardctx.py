"""Activation-sharding context: the partner of ``repro/models/shardctx.py``.

Distribution policy belongs to the launcher: it opens
``activation_sharding(...)`` around a call, and the model reads
``dp_shards()``, the number of data shards a mixture-of-experts layer
packs its dispatch buffers per (``models/moe.py``).  That number is part
of the function, not only a layout: each shard fills its own capacity
rows, so under a tight ``capacity_factor`` the tokens dropped change with
it.  The rule is the reference's: ``dp_size`` counts only when
``batch_axes`` is not None.

The reference's ``shard_act`` (a ``with_sharding_constraint`` on the
residuals, logits and dispatch buffers) is not ported: on one card it
has no effect, and it waits for a multi-card model run (``ROADMAP.md``
Queue A #11).
"""

from __future__ import annotations

import contextlib
import contextvars

_DP: contextvars.ContextVar[int] = contextvars.ContextVar(
    "repro_torch_dp_shards", default=1)


@contextlib.contextmanager
def activation_sharding(batch_axes, tp_axis: str, tp_size: int,
                        batch_size: int, d_model: int, vocab: int,
                        seq_axis: str | None = None, dp_size: int = 1):
    """The reference's signature.  Only ``dp_size`` (kept where
    ``batch_axes`` is not None) is stored: the tensor-parallel, vocab and
    sequence arguments decide ``shard_act``'s constraints there and are
    unused here until it is ported (Queue A #11)."""
    token = _DP.set(dp_size if batch_axes is not None else 1)
    try:
        yield
    finally:
        _DP.reset(token)


def dp_shards() -> int:
    """Number of data shards for locality-aware token dispatch (MoE);
    1 when no sharding context is active."""
    return int(_DP.get())


__all__ = ["activation_sharding", "dp_shards"]
