"""``wordcount-hibench-large`` — the paper's word count as an array job.

Source: HiBench ``micro/wordcount``, ``large`` profile
(``conf/workloads/micro/wordcount.conf``:
``hibench.wordcount.large.datasize`` = 3.2 GB of text written by Hadoop's
RandomTextWriter, which draws every word uniformly from a fixed list of
1,000 words).

The job is the device half of ``examples/quickstart.py``: token ids in
the ``(n_workers, n / n_workers, 2)`` int32 ``(token, 1)`` layout, one
shard per worker, through ``Pipeline.from_source(shards=...)
.map(wordcount_map_factory(1000)).reduce("sum")`` over a dense key space
of ``num_buckets = 1000``.  The full configuration is 2^28 = 268,435,456
tokens drawn uniformly over 1,000 ids from a seed, on 8 workers: 2 GiB of
shards on the device, about 2.5 GiB of UDF outputs, and a 4 KB result.

``reduced`` — what this configuration cuts from HiBench's:

* token ids are drawn directly, in place of RandomTextWriter's text and
  a tokenizer, which run on the host before the device path begins;
* 2^28 tokens stand for the 3.2e9 bytes, at about 12 bytes per word with
  its separator;
* the word list itself is not in the repository (only its size, 1,000).

Per-bucket counts stay near 2.7e5, far below 2^24, so float32 sums of
ones are exact in any order: the result must equal the ``np.bincount``
oracle exactly.

``group_pipeline`` is the same count with the combiner off — the job of
the paper's §IV-C run without its combiner (Fig. 6-8 measure the batch
job both ways): ``reduce("sum", mode="group", capacity=C)``, so every
token record crosses the grouping shuffle to its word's partition and is
summed there, in place of one combined count a word per worker.  ``C``
bounds what one worker sends to one partition; ``group_capacity`` sizes
it from the shards so that nothing is dropped.
"""

from __future__ import annotations

import numpy as np

from ..core.mapreduce import wordcount_map_factory
from ..engine.stages import host_bucket
from ..pipeline.graph import Pipeline

NAME = "wordcount-hibench-large"
SOURCE = ("HiBench micro/wordcount, large profile (conf/workloads/micro/"
          "wordcount.conf: hibench.wordcount.large.datasize = 3.2 GB of "
          "Hadoop RandomTextWriter text over 1,000 words)")
VOCAB = 1000                # RandomTextWriter's word list
N_WORKERS = 8

#: the full configuration the chip smoke drives
FULL = {"n_tokens": 1 << 28, "vocab": VOCAB, "n_workers": N_WORKERS}


def token_shards(seed: int, *, n_tokens: int, vocab: int = VOCAB,
                 n_workers: int = N_WORKERS) -> np.ndarray:
    """``n_tokens`` ids drawn uniformly over ``[0, vocab)`` as the
    ``(n_workers, n_tokens / n_workers, 2)`` int32 ``(token, 1)`` shards
    of ``examples/quickstart.py``; ``n_tokens`` must divide evenly."""
    if n_tokens % n_workers:
        raise ValueError(f"{n_tokens} tokens do not split over {n_workers} "
                         f"workers")
    rng = np.random.default_rng(seed)
    shards = np.empty((n_workers, n_tokens // n_workers, 2), np.int32)
    shards[..., 0] = rng.integers(0, vocab, shards.shape[:2], np.int32)
    shards[..., 1] = 1
    return shards


def pipeline(shards, vocab: int = VOCAB) -> Pipeline:
    """The word count as an array pipeline over ``shards``; build it with
    ``num_buckets=vocab, n_workers=len(shards)``."""
    return (Pipeline.from_source(shards=shards)
            .map(wordcount_map_factory(vocab)).reduce("sum"))


def oracle(shards: np.ndarray, vocab: int = VOCAB) -> np.ndarray:
    """Exact per-word counts of the valid (non-negative) tokens."""
    tokens = shards[..., 0].ravel()
    return np.bincount(tokens[tokens >= 0] % vocab, minlength=vocab)


def group_pipeline(shards, capacity: int, vocab: int = VOCAB) -> Pipeline:
    """The word count with the combiner off, as a group-mode array
    pipeline over ``shards``; build it with ``num_buckets=vocab,
    n_workers=len(shards)``."""
    return (Pipeline.from_source(shards=shards)
            .map(wordcount_map_factory(vocab))
            .reduce("sum", mode="group", capacity=capacity))


def group_capacity(shards: np.ndarray, vocab: int = VOCAB) -> int:
    """The capacity at which ``group_pipeline`` drops nothing: the most
    valid tokens one worker sends to one partition, where word ``w``'s
    partition is ``hash(w) % n_workers`` (``host_bucket``, the device's
    ``hash_partition``)."""
    n_workers = shards.shape[0]
    part = np.array([host_bucket(w, n_workers) for w in range(vocab)])
    most = 0
    for w in range(n_workers):
        tokens = shards[w, :, 0]
        per_word = np.bincount(tokens[tokens >= 0] % vocab, minlength=vocab)
        most = max(most, int(np.bincount(part, weights=per_word,
                                         minlength=n_workers).max()))
    return max(most, 1)
