"""Execution-plan layer: ``KeySpace`` × ``WindowSpec`` × ``ReduceSpec``
describe a device MapReduce job; ``ExecutionPlan.compile(backend=...,
device=...)`` lowers a streaming plan to a ``CompiledStreamAggregate``
folded by the fused fold kernel (or a ``CompiledStreamGroup``), and a
batch plan (``window=None``) to a ``CompiledBatchPlan`` combined by the
hash_combine kernel.  ``compile`` holds the backends (``"fused"``,
``"vmap"``, ``"shard_map"``) and their worker axes."""

from .compile import (BACKENDS, DistributedAxis, SimulatedAxis,
                      process_group, worker_axis)
from .plan import (CompiledBatchPlan, CompiledStreamAggregate,
                   CompiledStreamGroup, ExecutionPlan, KeySpace, ReduceSpec,
                   WindowSpec, resolve_device, streaming_record_map)
from .stages import (ShuffleStats, bucket_owner, bucketize, device_hash,
                     distinct_keys_per_bucket, fold_key24, host_bucket,
                     local_combine_dense, resolve_combine_fn, segment_reduce,
                     shuffle_aggregate, top_k_buckets)

__all__ = [
    "ExecutionPlan", "KeySpace", "ReduceSpec", "WindowSpec",
    "CompiledBatchPlan", "CompiledStreamAggregate", "CompiledStreamGroup",
    "streaming_record_map", "resolve_device", "BACKENDS", "SimulatedAxis",
    "DistributedAxis", "process_group", "worker_axis",
    "ShuffleStats", "bucket_owner", "bucketize", "device_hash",
    "distinct_keys_per_bucket", "fold_key24", "host_bucket",
    "local_combine_dense", "resolve_combine_fn", "segment_reduce",
    "shuffle_aggregate", "top_k_buckets",
]
