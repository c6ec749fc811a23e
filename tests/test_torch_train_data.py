"""The port's training data pipeline (``repro_torch.data``:
``PackedLMDataset``, ``Prefetcher``, ``make_store_with_corpus``) against
the reference's (``repro.data``): the same corpus bytes, and batch for
batch the same int32 arrays — exact equality, since both hash the same
words with the same FNV-1a and pack them the same way."""

import numpy as np
import pytest

from repro.core.storage import MemoryStore as RefMemoryStore
from repro.data import HashTokenizer as RefTokenizer
from repro.data import PackedLMDataset as RefDataset
from repro.data import Prefetcher as RefPrefetcher
from repro.data.pipeline import make_store_with_corpus as ref_corpus

from repro_torch.core.storage import MemoryStore
from repro_torch.data import (HashTokenizer, PackedLMDataset, Prefetcher,
                              make_store_with_corpus, synth_corpus)


def test_corpus_store_equals_reference():
    store, prefix = make_store_with_corpus(5_000, vocab_words=300, seed=2)
    ref_store, ref_prefix = ref_corpus(5_000, vocab_words=300, seed=2)
    assert prefix == ref_prefix == "input/"
    assert [m.key for m in store.list_objects(prefix)] == \
        [m.key for m in ref_store.list_objects(prefix)]
    assert store.get("input/corpus.txt") == ref_store.get("input/corpus.txt")


@pytest.mark.parametrize("n_hosts,batch,seq_len,read_chunk", [
    (1, 4, 32, 1 << 20),
    (1, 3, 17, 257),        # chunks end mid-word: the carried partial word
    (3, 2, 16, 4096),
    (4, 8, 64, 1000),
])
def test_batches_equal_reference(n_hosts, batch, seq_len, read_chunk):
    """Every host's first batches (past an epoch boundary at the smallest
    corpus) equal the reference's, array for array."""
    text = synth_corpus(6_000, vocab_words=400, seed=5).encode()
    store, ref_store = MemoryStore(), RefMemoryStore()
    for s in (store, ref_store):
        s.put("input/a.txt", text)
        s.put("input/b.txt", text[: len(text) // 3])
    for host in range(n_hosts):
        kw = dict(batch=batch, seq_len=seq_len, host_id=host,
                  n_hosts=n_hosts, read_chunk=read_chunk, seed=1)
        mine = iter(PackedLMDataset(store, "input/", HashTokenizer(512),
                                    **kw))
        theirs = iter(RefDataset(ref_store, "input/", RefTokenizer(512),
                                 **kw))
        for _ in range(12):
            a, b = next(mine), next(theirs)
            assert set(a) == {"inputs", "labels"}
            for k in a:
                assert a[k].dtype == np.int32 and a[k].shape == \
                    (batch, seq_len)
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a["inputs"][:, 1:],
                                          a["labels"][:, :-1])


def test_multi_host_shards_are_disjoint_work():
    store = MemoryStore()
    store.put("input/c.txt", synth_corpus(60_000, seed=4).encode())
    tok = HashTokenizer(50_000)
    rows, ranges = [], []
    for host in range(4):
        ds = PackedLMDataset(store, "input/", tok, batch=2, seq_len=16,
                             host_id=host, n_hosts=4)
        rows.append(next(iter(ds))["inputs"])
        ranges.append([(r.key, r.lo, r.hi) for r in ds.ranges])
    # different hosts read different byte ranges → different streams
    assert len({r.tobytes() for r in rows}) == 4
    spans = sorted(s for rs in ranges for s in rs)
    for (_, _, hi), (_, lo, _) in zip(spans, spans[1:]):
        assert hi <= lo                       # no byte read twice


def test_host_without_ranges_raises():
    store = MemoryStore()
    store.put("input/c.txt", b"one two")
    with pytest.raises(ValueError, match="no byte ranges"):
        PackedLMDataset(store, "input/", HashTokenizer(64), batch=1,
                        seq_len=2, host_id=1, n_hosts=2)


def test_prefetcher_preserves_order():
    it = Prefetcher(iter(range(100)), depth=4)
    assert list(it) == list(range(100))
    assert list(Prefetcher(iter(range(7)), depth=1)) == \
        list(RefPrefetcher(iter(range(7)), depth=1))


def test_prefetched_batches_equal_direct_ones():
    store, prefix = make_store_with_corpus(20_000, vocab_words=300)
    ds = PackedLMDataset(store, prefix, HashTokenizer(512), batch=4,
                         seq_len=16)
    direct, fetched = iter(ds), Prefetcher(iter(ds), depth=3)
    for _ in range(10):
        a, b = next(direct), next(fetched)
        np.testing.assert_array_equal(a["inputs"], b["inputs"])
