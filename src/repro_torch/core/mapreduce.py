"""Device-parallel MapReduce helpers — the name of the reference's
``repro.core.mapreduce`` façade that the batch word count needs:
``wordcount_map_factory``, the paper's word-count mapper as a torch UDF
for an array pipeline::

    Pipeline.from_source(shards=tokens).map(wordcount_map_factory(V))
        .reduce("sum").build(num_buckets=V, n_workers=W)

The façade's streaming helpers (incremental steps, window-slot carries)
and ``DeviceJobConfig``, which only they read, belong to ROADMAP Queue A
#11 and are not copied.
"""

from __future__ import annotations

import torch

__all__ = ["wordcount_map_factory"]


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
