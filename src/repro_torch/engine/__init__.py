"""Execution-plan layer: ``KeySpace`` × ``WindowSpec`` × ``ReduceSpec``
describe a device MapReduce job; ``ExecutionPlan.compile(device=...)``
lowers a streaming plan to a ``CompiledStreamAggregate`` folded by the
fused fold kernel, and a batch plan (``window=None``) to a
``CompiledBatchPlan`` combined by the hash_combine kernel."""

from .plan import (CompiledBatchPlan, CompiledStreamAggregate, ExecutionPlan,
                   KeySpace, ReduceSpec, WindowSpec, resolve_device)
from .stages import (ShuffleStats, bucketize, device_hash,
                     distinct_keys_per_bucket, fold_key24, host_bucket,
                     local_combine_dense, resolve_combine_fn,
                     shuffle_aggregate, top_k_buckets)

__all__ = [
    "ExecutionPlan", "KeySpace", "ReduceSpec", "WindowSpec",
    "CompiledBatchPlan", "CompiledStreamAggregate", "resolve_device",
    "ShuffleStats", "bucketize", "device_hash",
    "distinct_keys_per_bucket", "fold_key24", "host_bucket",
    "local_combine_dense", "resolve_combine_fn", "shuffle_aggregate",
    "top_k_buckets",
]
