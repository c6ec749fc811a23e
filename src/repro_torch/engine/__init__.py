"""Execution-plan layer: ``KeySpace`` × ``WindowSpec`` × ``ReduceSpec``
describe a streaming job; ``ExecutionPlan.compile(device=...)`` lowers it
to a ``CompiledStreamAggregate`` folded by the fused fold kernel."""

from .plan import (CompiledStreamAggregate, ExecutionPlan, KeySpace,
                   ReduceSpec, WindowSpec, resolve_device)
from .stages import (bucketize, device_hash, fold_key24, host_bucket,
                     top_k_buckets)

__all__ = [
    "ExecutionPlan", "KeySpace", "ReduceSpec", "WindowSpec",
    "CompiledStreamAggregate", "resolve_device", "bucketize", "device_hash",
    "fold_key24", "host_bucket", "top_k_buckets",
]
