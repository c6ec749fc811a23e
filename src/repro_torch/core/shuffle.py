"""Device-side shuffle — compatibility façade over ``engine.stages``.

The partner of ``repro/core/shuffle.py``: the paper's hash-partition +
sorted-spill + merge, re-expressed on the card, lives in the
execution-plan layer (``engine/stages.py``); this module keeps the
original import surface, the reference's ``__all__``.  See
``engine.stages`` for the stage bodies and ``engine.plan`` for how they
compose into execution plans.
"""

from ..engine.stages import (INVALID, ShuffleStats, bucket_owner,
                             build_send_buffers, device_hash, exchange,
                             hash_partition, local_combine_dense,
                             resolve_combine_fn, shuffle_aggregate,
                             shuffle_aggregate_windowed, shuffle_group,
                             sort_and_group)

__all__ = [
    "INVALID", "ShuffleStats", "bucket_owner", "build_send_buffers",
    "device_hash", "exchange", "hash_partition", "local_combine_dense",
    "resolve_combine_fn", "shuffle_aggregate", "shuffle_aggregate_windowed",
    "shuffle_group", "sort_and_group",
]
