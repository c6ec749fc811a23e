"""Quickstart: the paper's word-count workflow (Fig. 5), end to end, on
the PyTorch/CUDA port.

Runs the full serverless pipeline — Coordinator → Splitter → Mappers
(sort+combine+spill) → Reducers (k-way merge) → Finalizer — against the
in-process S3/Redis/Kafka stand-ins, then the same job on the device
engine (the hash-partition shuffle, combined by the ``hash_combine``
kernel on the card), and checks they agree.

    PYTHONPATH=src python examples_torch/quickstart.py                # the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu   # plain versions
"""

import argparse
from collections import Counter

import numpy as np

from repro_torch.core import (Coordinator, MemoryStore, MetadataStore,
                              make_wordcount_job, read_final_output)
from repro_torch.core.mapreduce import wordcount_map_factory
from repro_torch.data.pipeline import synth_corpus
from repro_torch.pipeline import Pipeline


def build_pipelines():
    """Planlint hook (``python -m repro_torch.analysis.planlint``): the
    device-engine word count as ``main`` builds it, over a stub shard (the
    data shape does not change the plan), built for the CPU (nor does the
    device)."""
    shard = np.zeros((8, 4, 2), dtype=np.int32)
    return {"wordcount": (Pipeline.from_source(shards=shard)
                          .map(wordcount_map_factory(16))
                          .reduce("sum")
                          .build(num_buckets=16, n_workers=8,
                                 backend="vmap", job_id="wordcount",
                                 device="cpu"))}


def main(argv=None) -> dict:
    """Run both planes; returns the host plane's word counts and the
    device engine's counts by word."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    # 1. input data in the object store ("S3 bucket")
    corpus = synth_corpus(100_000, vocab_words=2000, seed=0)
    store = MemoryStore()
    store.put("input/corpus.txt", corpus.encode())

    # 2. the paper's JSON job: 4 mappers, 2 reducers, combiner + finalizer
    cfg = make_wordcount_job(n_mappers=4, n_reducers=2)
    coord = Coordinator(store, MetadataStore())
    report = coord.run_job(cfg)
    print(f"job {cfg.job_id}: {report.state.value} in {report.wall_time:.3f}s")
    print("  per-component avg seconds:",
          {k: round(v, 4) for k, v in report.component_times().items()})

    out = read_final_output(cfg, store)
    expected = Counter(corpus.split())
    assert out == dict(expected)
    print(f"  exact counts for {len(out)} distinct words ✓")

    # 3. same job on the device engine: the hash-partition shuffle over 8
    # workers, authored as the two-node array pipeline
    vocab = {w: i for i, w in enumerate(sorted(expected))}
    tok = np.array([vocab[w] for w in corpus.split()], dtype=np.int32)
    W = 8
    n = (len(tok) + W - 1) // W * W
    toks = np.concatenate([tok, np.full(n - len(tok), -1, np.int32)])
    shard = np.stack([toks.reshape(W, -1),
                      np.ones((W, n // W), np.int32)], axis=-1)
    built = (Pipeline.from_source(shards=shard)
             .map(wordcount_map_factory(len(vocab)))
             .reduce("sum")
             .build(num_buckets=len(vocab), n_workers=W, backend="vmap",
                    device=args.device))
    res, _stats = built.run_batch(data=shard)
    res = res.cpu().numpy()
    for w, c in expected.items():
        assert res[vocab[w]] == c
    print(f"  device engine ({args.device}) agrees across {W} workers ✓")
    return {"host": out, "device": {w: int(res[i]) for w, i in vocab.items()}}


if __name__ == "__main__":
    main()
