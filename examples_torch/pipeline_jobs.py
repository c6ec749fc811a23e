"""Paper Fig. 4, re-expressed on the port's declarative Pipeline API (every
windowed job folds through ``fused_fold`` on the card): the two
chained jobs become dataflow graphs — the second job's two map functions
are adjacent ``.map`` nodes that fuse into one stage at build time instead
of running as two consecutive MapReduce jobs (§III-D), a third graph
adds ``top_k`` to rank the hot words, and a fourth is a **two-phase
multi-stage chain** — count per key per minute, then top-k over those
counts per five minutes — where the paper would run two separate jobs
with an object-store round-trip between them, the chain continues past
the first reduce and the finalized windows hand off to the second plan
through the carry (on device: no re-serialization between stages).  A
fifth job is a **DAG fan-out**: a GPS stream's per-minute counts tee into
two concurrent consumers — a top-k branch and a per-region rollup branch
— off ONE shared intermediate (the Kafka-ML shape: one ingested stream,
many consumers), each tee edge picking its own handoff transport.  All
through the same front door the streaming engine uses.  (The original
host-plane client path — ``JobConfig``/``Coordinator`` — still works and
stays exercised by ``tests/test_torch_batch_job.py``.)

    PYTHONPATH=src python examples_torch/pipeline_jobs.py                # the card
    PYTHONPATH=src python examples_torch/pipeline_jobs.py --device cpu   # plain versions
"""

import argparse
import json

import numpy as np

from repro_torch.core import MemoryStore
from repro_torch.data.pipeline import synth_corpus
from repro_torch.pipeline import Pipeline, RunOptions, Windowing

BUCKETS = 1024      # dense key-id space (vocab is 500 words + variants)
WORKERS = 4
WINDOW = Windowing.tumbling(1.0)    # one global window: a batch job


def normalize(rec):                  # stage 1 of job 2: normalize
    ts, word, one = rec
    return ts, word.strip(".,").lower(), one


def first_letter(rec):               # stage 2: bucket by first letter
    ts, word, one = rec
    return ts, (word[:1] or "_"), one


def build_pipelines():
    """Planlint hook (``python -m repro_torch.analysis.planlint``): the
    demo's graph shapes — single-stage, fused-map, top-k, two-phase
    chain, and the tee'd DAG — built over stub records for the CPU (bound
    data and the device do not affect the lowered plan, so the checks see
    exactly the programs ``main`` runs)."""
    stub = [(0.0, "w", 1.0)]

    def src():
        return Pipeline.from_source(records=stub, batch_records=2048)

    two_phase = (src().map(normalize).key_by()
                 .window(Windowing.tumbling(60.0)).reduce("count")
                 .window(Windowing.tumbling(300.0)).reduce("sum").top_k(5))
    fan = (src().key_by()
           .window(Windowing.tumbling(60.0)).reduce("count")
           .tee(Pipeline.branch()
                .window(Windowing.tumbling(300.0))
                .reduce("sum").top_k(5).sink("gps-busy/"),
                Pipeline.branch()
                .map(normalize).key_by()
                .window(Windowing.tumbling(300.0))
                .reduce("sum").sink("gps-region/")))
    return {
        "words": (src().key_by().window(WINDOW).reduce("count")
                  .build(num_buckets=BUCKETS, n_workers=WORKERS,
                         job_id="words", device="cpu")),
        "letters": (src().map(normalize).map(first_letter).key_by()
                    .window(WINDOW).reduce("count")
                    .build(num_buckets=BUCKETS, n_workers=WORKERS,
                           job_id="letters", device="cpu")),
        "hot": (src().map(normalize).key_by().window(WINDOW)
                .reduce("count").top_k(8)
                .build(num_buckets=BUCKETS, n_workers=WORKERS,
                       job_id="hot", device="cpu")),
        "two-phase": two_phase.build(num_buckets=BUCKETS,
                                     n_workers=WORKERS,
                                     job_id="two-phase", device="cpu"),
        "gps-fan": fan.build(num_buckets=64, n_workers=WORKERS,
                             job_id="gps-fan", device="cpu"),
    }


def main(argv=None) -> dict:
    """Run the five jobs; returns every job's sink objects."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    dev = ap.parse_args(argv).device
    corpus = synth_corpus(60_000, vocab_words=500, seed=1)
    # the Splitter's record form: one (event_time, key, value) per word
    words = [(0.0, w, 1.0) for w in corpus.split()]

    wordcount = (Pipeline.from_source(records=words)
                 .key_by()
                 .window(WINDOW)
                 .reduce("count"))
    letters = (Pipeline.from_source(records=words)
               .map(normalize)
               .map(first_letter)     # fuses with normalize: one stage
               .key_by()
               .window(WINDOW)
               .reduce("count"))
    hot = (Pipeline.from_source(records=words)
           .map(normalize)
           .key_by()
           .window(WINDOW)
           .reduce("count")
           .top_k(8))

    # one front door: records-bound graphs dispatch to a one-shot batch
    out1, rep1 = wordcount.build(num_buckets=BUCKETS, n_workers=WORKERS,
                                 job_id="words", device=dev).run()
    out2, rep2 = letters.build(num_buckets=BUCKETS, n_workers=WORKERS,
                               job_id="letters", device=dev).run()
    out3, _ = hot.build(num_buckets=BUCKETS, n_workers=WORKERS,
                        job_id="hot", device=dev).run()

    def decode(outputs):
        (blob,) = outputs.values()
        return [json.loads(line) for line in blob.splitlines()]

    counts1, counts2, top = decode(out1), decode(out2), decode(out3)
    total1 = sum(v for _k, v in counts1)
    total2 = sum(v for _k, v in counts2)
    print(f"job1 (wordcount): {len(counts1)} words, total={total1}")
    print(f"job2 (two fused maps → letter buckets): "
          f"{dict(counts2[:8])} ...")
    print(f"job3 (top_k node): hottest words {top}")
    assert total1 == total2 == len(words)
    print("conservation across pipelines ✓")

    # job 4 — a two-phase chain: count per word per "minute" of event
    # time, then the 5 heaviest words per "five minutes" of those counts.
    # One graph, two stages, carry handoff between them — and the same
    # graph runs batch (here) or streaming, bit-identically per window.
    timed = [(float(i % 300), w, 1.0) for i, w in enumerate(corpus.split())]
    two_phase = (Pipeline.from_source(records=timed)
                 .map(normalize)
                 .key_by()
                 .window(Windowing.tumbling(60.0))
                 .reduce("count")                   # phase 1: count/minute
                 .window(Windowing.tumbling(300.0))
                 .reduce("sum")                     # phase 2: re-window …
                 .top_k(5))                         # … and rank the counts
    built = two_phase.build(num_buckets=BUCKETS, n_workers=WORKERS,
                            job_id="two-phase", device=dev)
    out4, rep4 = built.run()
    hot5 = decode(out4)
    print(f"job4 (two-phase chain, {len(built.stages)} stages, "
          f"{rep4.handoffs} carry handoffs): top-5 over minute-counts "
          f"{hot5}")
    assert len(built.stages) == 2 and built.stages[0].handoff_device
    assert [w for w, _c in hot5] == [w for w, _c in top[:5]]
    print("two-phase ranking agrees with the single-window top_k ✓")

    # job 5 — DAG fan-out: a GPS fleet stream (event_time, vehicle, speed),
    # counted per vehicle per "minute", then TEE'd: one branch ranks the 5
    # busiest vehicles per five minutes (identity boundary → on-device
    # handoff), the other rolls the counts up per region (a host map
    # between the stages → host-record handoff).  One ingested stream, two
    # concurrent consumers, one shared intermediate — and the same graph
    # runs batch and streaming with bit-identical windows on BOTH sinks.
    rng = np.random.default_rng(7)
    gps = [(float(t % 1800), f"v{int(v):02d}", float(s))
           for t, v, s in zip(rng.uniform(0, 1800, 20_000),
                              rng.integers(0, 24, 20_000),
                              rng.uniform(0, 30, 20_000))]
    gps.sort()

    def to_region(rec):
        ts, vehicle, count = rec
        return ts, f"region-{int(vehicle[1:]) % 4}", count

    fan = (Pipeline.from_source(records=gps, batch_records=2048)
           .key_by()
           .window(Windowing.tumbling(60.0))
           .reduce("count")                        # per-minute counts, once
           .tee(Pipeline.branch()                  # consumer 1: busiest
                .window(Windowing.tumbling(300.0))
                .reduce("sum").top_k(5)
                .sink("gps-busy/"),
                Pipeline.branch()                  # consumer 2: region load
                .map(to_region).key_by()
                .window(Windowing.tumbling(300.0))
                .reduce("sum")
                .sink("gps-region/")))
    built5 = fan.build(num_buckets=64, n_workers=WORKERS, job_id="gps-fan",
                       device=dev)
    transports = sorted(e.device for e in built5.edges)
    assert len(built5.stages) == 3 and transports == [False, True]
    out5, rep5 = built5.run()
    stream_store = MemoryStore()
    rep5s = built5.run(store=stream_store, mode="streaming",
                       options=RunOptions(overlap=True, prefetch_batches=2))
    streamed5 = built5.collect_outputs(stream_store)
    assert streamed5 and streamed5 == out5
    busy = {k: v for k, v in out5.items() if k.startswith("gps-busy/")}
    region = {k: v for k, v in out5.items() if k.startswith("gps-region/")}
    first_busy = [json.loads(ln)
                  for ln in sorted(busy.items())[0][1].splitlines()]
    first_region = [json.loads(ln)
                    for ln in sorted(region.items())[0][1].splitlines()]
    print(f"job5 (DAG fan-out, {len(built5.stages)} stages, "
          f"{rep5.handoffs} edge handoffs): busiest vehicles "
          f"{first_busy} | region load {dict(first_region)}")
    print("tee'd branches: batch ↔ streaming bit-identical on both sinks ✓")
    print(f"[{rep1.batches + rep2.batches + rep4.batches + rep5.batches} "
          f"batch drives + {rep5s.batches} streaming micro-batches "
          f"(close→emit p99 {rep5s.p99_emit_latency * 1e3:.2f} ms); one "
          f"front door — .run(..., options=RunOptions(...)) — both modes]")
    return {"words": out1, "letters": out2, "hot": out3, "two-phase": out4,
            "gps-fan": out5}


if __name__ == "__main__":
    main()
