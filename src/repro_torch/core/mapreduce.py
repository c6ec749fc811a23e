"""Device-parallel MapReduce helpers — a thin façade over
``repro_torch.engine``, with the reference's ``repro.core.mapreduce``
names and signatures.

``wordcount_map_factory`` is the paper's word-count mapper as a torch UDF
for an array pipeline::

    Pipeline.from_source(shards=tokens).map(wordcount_map_factory(V))
        .reduce("sum").build(num_buckets=V, n_workers=W)

The streaming helpers keep the reference's original device-engine call
signatures: ``DeviceJobConfig``, ``make_incremental_step`` (a host-wire
fold step, ``backend="vmap"`` by default, as in the reference) and the
window-slot carry helpers ``init_window_carry`` / ``read_window_slot`` /
``clear_window_slot``.  The carry is the backend's layout: ``(W, n_slots
* num_buckets / W, C)`` under ``"vmap"``, the flat ``(n_slots *
num_buckets, C)`` slab under ``"fused"``, this rank's ``(n_slots *
num_buckets / W, C)`` share under ``"shard_map"`` (read a window of that
one through the compiled plan, which gathers it).  Steps fold in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..engine.plan import (ExecutionPlan, KeySpace, ReduceSpec, WindowSpec,
                           streaming_record_map)
from ..engine.stages import INT32_MAX, segment_reduce

__all__ = [
    "DeviceJobConfig", "segment_reduce", "streaming_record_map",
    "make_incremental_step", "init_window_carry", "read_window_slot",
    "clear_window_slot", "wordcount_map_factory", "INT32_MAX",
]


@dataclass(frozen=True)
class DeviceJobConfig:
    """Device-engine analogue of the paper's JSON job config (§III-C).

    num_buckets    — key-id space size (aggregate mode's dense width)
    n_workers      — the worker axis: the paper's n_mappers == n_reducers
                     here, every worker plays both roles (map, then own a
                     partition)
    capacity       — per-partition record capacity for the grouping
                     exchange (the spill-file size bound)
    axis_name      — the reference's mesh-axis name; accepted for its
                     signature and unused (a worker axis here is a tensor
                     dimension or a process group, not a named axis)
    run_combiner   — pre-reduce locally before shuffling (paper default:
                     on); the fused fold always combines, so a step refuses
                     ``False``
    """

    num_buckets: int
    n_workers: int
    capacity: int = 0
    axis_name: str = "workers"
    run_combiner: bool = True


def _compile(cfg: DeviceJobConfig, n_slots: int, n_channels: int = 2, *,
             combine_fn=None, backend: str, device, group):
    """The host-wire aggregate plan both helpers build, compiled."""
    window = WindowSpec(size=0.0, n_slots=n_slots, fanout_on_device=False)
    plan = ExecutionPlan(
        key_space=KeySpace.dense(cfg.num_buckets),
        reduce=ReduceSpec(mode="aggregate", combine_fn=combine_fn,
                          capacity=cfg.capacity, channels=n_channels),
        n_workers=cfg.n_workers, window=window)
    return plan.compile(backend=backend, device=device, group=group)


def make_incremental_step(cfg: DeviceJobConfig, n_slots: int, *,
                          map_fn: Callable = streaming_record_map,
                          combine_fn: Callable | None = None,
                          backend: str = "vmap", device="cuda",
                          group=None) -> Callable:
    """Build the streaming hot path: ``step(batch, carry) -> carry``.

    ``batch`` is host-wire rows ``[window_slot, key, value, valid]`` in
    the backend's wire layout (``(W, per, 4)`` under ``"vmap"``); ``carry``
    comes from ``init_window_carry`` with the same backend and is folded in
    place by one ``fused_fold`` launch.  ``map_fn`` and ``combine_fn`` are
    the reference's hooks: the fold decodes the standard wire and combines
    in the kernel, so only ``streaming_record_map`` and ``None`` apply.
    ``device`` and ``group`` (the ``shard_map`` process group) are the
    port's; the reference's ``mesh`` and ``jit`` have no counterpart."""
    if map_fn is not streaming_record_map:
        raise ValueError("the fused fold decodes the standard host wire "
                         "in-kernel; a custom map_fn does not apply")
    if not cfg.run_combiner:
        raise ValueError("the fused fold combines in-kernel; "
                         "run_combiner=False does not apply")
    compiled = _compile(cfg, n_slots, combine_fn=combine_fn,
                        backend=backend, device=device, group=group)

    def step(batch, carry):
        new_carry, _stats = compiled.step(batch, carry)
        return new_carry

    return step


def init_window_carry(cfg: DeviceJobConfig, n_slots: int,
                      n_channels: int = 2, backend: str = "vmap",
                      dtype=torch.float32, device="cuda",
                      group=None) -> torch.Tensor:
    """Zeroed carried window state in the layout ``step`` expects: the
    compiled plan's own ``init_carry``."""
    return _compile(cfg, n_slots, n_channels, backend=backend, device=device,
                    group=group).init_carry().to(dtype)


def _flat(carry: torch.Tensor) -> torch.Tensor:
    """A ``(W, per, C)`` or flat carry as its flat ``(rows, C)`` view."""
    return carry.view(-1, carry.shape[-1])


def read_window_slot(carry: torch.Tensor, slot: int,
                     num_buckets: int) -> np.ndarray:
    """One finalized window's dense ``(num_buckets, channels)`` aggregate
    from a ``"vmap"`` or flat carry; only the window's rows cross to the
    host."""
    rows = _flat(carry)[slot * num_buckets:(slot + 1) * num_buckets]
    return rows.to("cpu", copy=True).numpy()


def clear_window_slot(carry: torch.Tensor, slot: int,
                      num_buckets: int) -> torch.Tensor:
    """Zero a finalized window's slice (in place) so its ring slot can be
    reused; returns the carry."""
    _flat(carry)[slot * num_buckets:(slot + 1) * num_buckets].zero_()
    return carry


def wordcount_map_factory(num_buckets: int):
    """Device word count map UDF: a worker's shard is a (records, 2)
    integer tensor of (token_id, 1) pairs with -1 padding — the data layer
    tokenizes text into ids.  Mirrors the paper's Fig. 5 mapper and the
    reference's UDF of the same name: keys ``token % num_buckets`` (0 for
    padding), float32 values, and ``valid = token >= 0``."""

    def map_fn(shard):
        keys = shard[:, 0]
        values = shard[:, 1].to(torch.float32)
        valid = keys >= 0
        keys = torch.where(valid, keys, 0) % num_buckets
        return keys, values, valid

    return map_fn
