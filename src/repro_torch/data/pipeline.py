"""Training-data pipeline: byte-range sharded reading → tokens → packed
(B, S) batches, with host-side prefetch; and the synthetic Zipf corpus.

The partner of ``repro/data/pipeline.py``.  The reader consumes the same
Splitter output as the MapReduce Mappers (``core.splitter.split_prefix``):
each data-parallel host owns a byte-range assignment fetched by ranged
GET, so adding hosts re-splits rather than re-copies.  Packing is
drop-remainder fixed-length next-token prediction.  Batches are numpy
int32 arrays, as the reference's are; the trainer moves them to the
device.  ``synth_corpus`` is byte for byte the reference's (numpy's seeded
Zipf draw), so both packages read the same text.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from ..core.splitter import ByteRange, split_prefix
from ..core.storage import MemoryStore, ObjectStore
from .tokenizer import HashTokenizer, preprocess


def synth_corpus(n_words: int, vocab_words: int = 1000, seed: int = 0,
                 zipf: float = 1.3) -> str:
    """Zipf-distributed synthetic corpus (stands in for the paper's
    preprocessed Wikipedia dump — same locality statistics shape)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf, size=n_words)
    ranks = np.clip(ranks, 1, vocab_words)
    return " ".join(f"w{r}" for r in ranks)


class PackedLMDataset:
    """Iterates (inputs, labels) int32 (B, S) batches for one data-parallel
    host, reading its byte-range shard through the object store."""

    def __init__(self, store: ObjectStore, prefix: str,
                 tokenizer: HashTokenizer, batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1,
                 read_chunk: int = 1 << 20, seed: int = 0,
                 sep: bytes = b" ") -> None:
        self.store = store
        self.tokenizer = tokenizer
        self.batch = batch
        self.seq_len = seq_len
        # preprocessed corpora (§IV-B) are single space-separated streams,
        # so the record separator for boundary extension is the space
        assignments = split_prefix(store, prefix, n_hosts, sep=sep)
        self.ranges: list[ByteRange] = assignments[host_id]
        if not self.ranges:
            raise ValueError(
                f"host {host_id}/{n_hosts} received no byte ranges — input "
                f"under {prefix!r} is too small or not splittable")
        self.read_chunk = read_chunk
        self.rng = np.random.default_rng(seed + host_id)

    def _token_stream(self) -> Iterator[int]:
        while True:  # epoch loop
            for r in self.ranges:
                lo = r.lo
                carry = ""
                while lo < r.hi:
                    hi = min(lo + self.read_chunk, r.hi)
                    text = carry + self.store.get(r.key, (lo, hi)).decode(
                        "utf-8", "replace")
                    lo = hi
                    # keep the trailing partial word for the next chunk
                    if lo < r.hi and not text[-1].isspace():
                        text, _, carry = text.rpartition(" ")
                    else:
                        carry = ""
                    yield from self.tokenizer.encode(text)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        stream = self._token_stream()
        need = self.batch * (self.seq_len + 1)
        buf: list[int] = []
        while True:
            while len(buf) < need:
                buf.append(next(stream))
            block = np.asarray(buf[:need], dtype=np.int32).reshape(
                self.batch, self.seq_len + 1)
            buf = buf[need:]
            yield {"inputs": block[:, :-1], "labels": block[:, 1:]}


class Prefetcher:
    """Host-side prefetch: overlaps data preparation with the device step —
    the download/processing overlap the paper measures, applied to
    training."""

    def __init__(self, it: Iterator, depth: int = 2) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_store_with_corpus(n_words: int, key: str = "input/corpus.txt",
                           **kw) -> tuple[MemoryStore, str]:
    """A ``MemoryStore`` holding one preprocessed ``synth_corpus`` of
    ``n_words`` words under ``key``, and the prefix to read it from."""
    store = MemoryStore()
    store.put(key, preprocess(synth_corpus(n_words, **kw)).encode())
    return store, "input/"


__all__ = ["PackedLMDataset", "Prefetcher", "make_store_with_corpus",
           "synth_corpus"]
