"""The port's host batch job (Coordinator → Splitter → Mappers → Reducers
→ Finalizer) against the reference's.

The same scenario runs through ``repro`` and ``repro_torch`` over the same
input: the splitter's byte ranges, every object the job leaves in the
store (input, the mappers' sorted spills under their keys, the reducers'
parts, the Finalizer's object) and the metadata's task records with the
times taken out must be identical.  The scenarios are the reference's
``tests/test_splitter.py``, ``tests/test_coordinator_client.py``, the
corpus half of ``tests/test_data.py`` and ``tests/test_system.py``'s
word counts, combiner and host-vs-device cases; the device engine on the
port's side is the array pipeline with ``device="cpu"`` (the
``hash_combine`` wrapper's plain version).  The card's run of the same
comparison carries the ``cuda`` marker and skips here.
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import splitter as jsplitter
from repro.core import workers as jworkers
from repro.core.mapreduce import wordcount_map_factory as jwordcount
from repro.data import tokenizer as jtokenizer
from repro.data.pipeline import synth_corpus as jsynth_corpus
from repro.pipeline import Pipeline as JPipeline

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch import core
from repro_torch.core import splitter, workers
from repro_torch.core.job import JobConfig, load_udf
from repro_torch.core.mapreduce import wordcount_map_factory
from repro_torch.data import build_vocab, tokenizer
from repro_torch.data.pipeline import synth_corpus
from repro_torch.kernels.hash_combine import ops as hc_ops
from repro_torch.pipeline import Pipeline

#: the two packages' host planes, side by side
PKGS = {"jax": jcore, "port": core}

#: phase timings and wall-clock fields differ between any two runs
_TIMES = {"downloading", "processing", "uploading", "total"}

CORPUS = synth_corpus(15_000, vocab_words=100, seed=1)
EXPECTED = dict(Counter(CORPUS.split()))


def _stack(pkg, corpus=CORPUS):
    store = pkg.MemoryStore()
    store.put("input/corpus.txt", corpus.encode())
    return store, pkg.MetadataStore()


def _objects(store) -> dict:
    return {m.key: store.get(m.key) for m in store.list_objects("")}


def _meta_without_times(meta) -> dict:
    out = {}
    for key in meta.keys(""):
        value = meta.get(key)
        if isinstance(value, dict):
            value = {k: v for k, v in value.items() if k not in _TIMES}
        out[key] = value
    return out


def _run_wordcount(pkg, corpus=CORPUS, **overrides):
    """One word count.  Speculation is off: a twin launched because a task
    ran slow on a loaded host adds to the metadata's done counters, which
    the parity tests compare (it has its own test below)."""
    store, meta = _stack(pkg, corpus)
    cfg = pkg.make_wordcount_job(job_id="wc-1", **overrides)
    report = pkg.Coordinator(store, meta,
                             speculative_execution=False).run_job(cfg)
    return cfg, report, store, meta


# -- the splitter (tests/test_splitter.py) ------------------------------------

def _ranges(ranges):
    return [(r.key, r.lo, r.hi) for r in ranges]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_split_object_matches_reference(seed, binary):
    rng = np.random.default_rng(seed)
    words = ["".join(rng.choice(list("abcdef"), rng.integers(1, 9)))
             for _ in range(int(rng.integers(1, 300)))]
    data = ("\n".join(words) + "\n").encode()
    n = int(rng.integers(1, 11))
    got = {}
    for name, pkg in PKGS.items():
        store = pkg.MemoryStore()
        store.put("obj", data)
        mod = jsplitter if name == "jax" else splitter
        got[name] = _ranges(mod.split_object(store, "obj", n, binary=binary,
                                             sep=b"\n"))
    assert got["port"] == got["jax"]
    assert got["port"][0][1] == 0 and got["port"][-1][2] == len(data)


@pytest.mark.parametrize("n_mappers", [1, 2, 3, 6])
def test_split_prefix_and_published_splits_match_reference(n_mappers):
    rng = np.random.default_rng(n_mappers)
    bodies = [bytes(rng.integers(97, 105, size, dtype=np.uint8))
              for size in rng.integers(0, 5000, 5)]
    got = {}
    for name, pkg in PKGS.items():
        store, meta = pkg.MemoryStore(), pkg.MetadataStore()
        for i, body in enumerate(bodies):
            store.put(f"in/{i}", body)
        mod = jsplitter if name == "jax" else splitter
        assignments = mod.split_prefix(store, "in/", n_mappers, binary=True)
        mod.publish_splits(meta, "job", assignments)
        got[name] = ([_ranges(a) for a in assignments],
                     [_ranges(mod.fetch_split(meta, "job", m))
                      for m in range(n_mappers)])
    assert got["port"] == got["jax"]
    assert sum(hi - lo for a in got["port"][0] for _, lo, hi in a) == \
        sum(map(len, bodies))


def test_long_record_spanning_splits_is_not_cut():
    data = b"short\n" + b"x" * 1000 + b"\nend\n"
    store = core.MemoryStore()
    store.put("obj", data)
    ranges = splitter.split_object(store, "obj", 5, binary=False)
    recs = [rec for r in ranges for rec in data[r.lo:r.hi].split(b"\n")]
    assert b"x" * 1000 in recs


# -- the workers' wire format and partitioner ----------------------------------

@pytest.mark.parametrize("n_reducers", [1, 2, 3, 7, 64])
def test_hash_partition_and_record_codec_match_reference(n_reducers):
    keys = ["", "a", "w17", "ünï", "hello world"] + \
        [f"w{i}" for i in range(200)]
    assert [workers._hash_partition(k, n_reducers) for k in keys] == \
        [jworkers._hash_partition(k, n_reducers) for k in keys]
    records = [(k, i) for i, k in enumerate(keys)]
    blob = workers._encode_records(records)
    assert blob == jworkers._encode_records(records)
    assert list(workers._decode_records(blob)) == \
        list(jworkers._decode_records(blob))


def test_combine_and_merge_runs_match_reference():
    rng = np.random.default_rng(3)
    recs = [(f"k{int(k)}", int(v)) for k, v in
            zip(rng.integers(0, 30, 400), rng.integers(0, 9, 400))]

    def add(key, values):
        return key, sum(values)

    assert workers._combine(list(recs), add) == \
        jworkers._combine(list(recs), add)
    runs = [sorted(recs[i::7]) for i in range(7)]
    for fan_in in (2, 3, 100):
        assert list(workers._merge_runs([list(r) for r in runs], fan_in)) == \
            list(jworkers._merge_runs([list(r) for r in runs], fan_in))


def test_job_config_round_trips_and_udfs_ship_as_source():
    cfg = core.make_wordcount_job(job_id="cfg-1", n_mappers=3)
    ref = jcore.make_wordcount_job(job_id="cfg-1", n_mappers=3)
    assert cfg.to_json() == ref.to_json()
    back = JobConfig.from_json(cfg.to_json())
    assert back == cfg
    mapper = load_udf(back.mapper_src)
    assert list(mapper(None, "a b a")) == [("a", 1), ("b", 1), ("a", 1)]
    with pytest.raises(ValueError, match="mapper source"):
        JobConfig().validate()


# -- the word count end to end (tests/test_system.py) --------------------------

@pytest.mark.parametrize("n_mappers,n_reducers", [(4, 2), (7, 3), (1, 1)])
def test_wordcount_objects_and_records_match_reference(n_mappers,
                                                       n_reducers):
    runs = {name: _run_wordcount(pkg, n_mappers=n_mappers,
                                 n_reducers=n_reducers)
            for name, pkg in PKGS.items()}
    (cfg, report, store, meta), (_, jreport, jstore, jmeta) = \
        runs["port"], runs["jax"]
    assert report.state == jreport.state == core.JobState.DONE
    assert report.state.value == jreport.state.value == "DONE"
    assert workers.read_final_output(cfg, store) == EXPECTED
    objects = _objects(store)
    assert objects == _objects(jstore)
    assert any("/intermediate/spill-" in k for k in objects)
    assert _meta_without_times(meta) == _meta_without_times(jmeta)
    assert sorted((t.role, t.worker_id) for t in report.task_results) == \
        sorted((t.role, t.worker_id) for t in jreport.task_results)


def test_map_only_workflow_leaves_the_reference_spills():
    runs = {name: _run_wordcount(pkg, n_mappers=3, n_reducers=0,
                                 run_finalizer=False)
            for name, pkg in PKGS.items()}
    spills = {name: {k: v for k, v in _objects(store).items()
                     if k.startswith("jobs/wc-1/intermediate/")}
              for name, (_, _, store, _) in runs.items()}
    assert spills["port"] and spills["port"] == spills["jax"]
    assert runs["port"][1].state == core.JobState.DONE


@pytest.mark.parametrize("n_mappers,n_reducers", [(4, 2), (2, 3)])
def test_combiner_changes_spill_bytes_not_results(n_mappers, n_reducers):
    """Combiner on and off give the same Finalizer object, and fewer spill
    bytes with it on, in both packages alike: the same spill keys and
    bytes."""
    got = {}
    for name, pkg in PKGS.items():
        for combine in (True, False):
            cfg, report, store, _ = _run_wordcount(
                pkg, n_mappers=n_mappers, n_reducers=n_reducers,
                run_combiner=combine)
            assert report.state.value == "DONE"
            spills = {k: v for k, v in _objects(store).items()
                      if k.startswith("jobs/wc-1/intermediate/")}
            got[name, combine] = (
                store.get(workers.final_output_key(cfg)), spills,
                sum(t.times.bytes_out for t in report.task_results
                    if t.role == "mapper"))
    assert got["port", True] == got["jax", True]
    assert got["port", False] == got["jax", False]
    (final_on, spills_on, bytes_on), (final_off, spills_off, bytes_off) = \
        got["port", True], got["port", False]
    assert final_on == final_off
    assert bytes_on < bytes_off
    assert spills_on.keys() == spills_off.keys()


def test_host_job_agrees_with_the_array_pipeline_and_the_reference():
    """tests/test_system.py's host-vs-device case: the Finalizer's counts
    equal the port's array pipeline (device="cpu") and the reference's
    (backend="vmap") over the same token shards."""
    corpus = synth_corpus(30_000, vocab_words=200, seed=7)
    cfg, report, store, _ = _run_wordcount(core, corpus, n_mappers=4,
                                           n_reducers=2)
    host = workers.read_final_output(cfg, store)
    assert host == dict(Counter(corpus.split()))
    vocab = {w: i for i, w in enumerate(sorted(host))}
    tok = np.array([vocab[w] for w in corpus.split()], dtype=np.int32)
    w_, nb = 8, 256
    n = (len(tok) + w_ - 1) // w_ * w_
    toks = np.concatenate([tok, np.full(n - len(tok), -1, np.int32)])
    shard = np.stack([toks.reshape(w_, -1), np.ones((w_, n // w_),
                                                    np.int32)], axis=-1)
    built = (Pipeline.from_source(shards=torch.from_numpy(shard))
             .map(wordcount_map_factory(nb)).reduce("sum")
             .build(num_buckets=nb, n_workers=w_, device="cpu"))
    res, _ = built.run_batch(data=torch.from_numpy(shard))
    jbuilt = (JPipeline.from_source(shards=shard).map(jwordcount(nb))
              .reduce("sum").build(num_buckets=nb, n_workers=w_,
                                   backend="vmap"))
    jres, _ = jbuilt.run_batch(data=shard)
    assert np.array_equal(res.numpy(), np.asarray(jres))
    for w, c in host.items():
        assert res[vocab[w]].item() == c


@pytest.mark.cuda
def test_host_job_equals_the_card_word_count(cuda_device):
    """On the card: the Finalizer's counts equal the array pipeline built
    with device="cuda", which combines through one hash_combine launch."""
    corpus = synth_corpus(60_000, vocab_words=500, seed=11)
    cfg, report, store, _ = _run_wordcount(core, corpus, n_mappers=4,
                                           n_reducers=2)
    host = workers.read_final_output(cfg, store)
    vocab = {w: i for i, w in enumerate(sorted(host))}
    tok = torch.tensor([vocab[w] for w in corpus.split()], dtype=torch.int64)
    w_, nb = 8, 512
    pad = (-len(tok)) % w_
    toks = torch.cat([tok, torch.full((pad,), -1, dtype=torch.int64)])
    shard = torch.stack([toks.reshape(w_, -1), torch.ones(
        w_, toks.numel() // w_, dtype=torch.int64)], -1).to(cuda_device)
    built = (Pipeline.from_source(shards=shard)
             .map(wordcount_map_factory(nb)).reduce("sum")
             .build(num_buckets=nb, n_workers=w_, device="cuda"))
    before = hc_ops.combine.launches
    res, _ = built.run_batch(data=shard)
    assert hc_ops.combine.launches == before + 1
    res = res.cpu()
    assert {w: int(res[i]) for w, i in vocab.items()} == host


# -- reliability and the client package (tests/test_coordinator_client.py) ----

def test_retry_on_transient_mapper_failure_matches_reference():
    results = {}
    for name, pkg in PKGS.items():
        store, meta = _stack(pkg)
        failures = {("mapper", 1, 0), ("mapper", 2, 0)}

        def inject(role, wid, attempt, failures=failures):
            if (role, wid, attempt) in failures:
                failures.discard((role, wid, attempt))
                raise RuntimeError("simulated container crash")

        coord = pkg.Coordinator(store, meta, fault_injector=inject,
                                max_task_retries=2)
        cfg = pkg.make_wordcount_job(job_id="retry-1", n_mappers=4,
                                     n_reducers=2)
        report = coord.run_job(cfg)
        results[name] = (report.state.value, report.retries, _objects(store))
    assert results["port"] == results["jax"]
    assert results["port"][:2] == ("DONE", 2)


def test_job_fails_after_retry_budget_like_reference():
    got = {}
    for name, pkg in PKGS.items():
        store, meta = _stack(pkg)

        def always_fail(role, wid, attempt):
            if role == "reducer" and wid == 0:
                raise RuntimeError("permanent failure")

        coord = pkg.Coordinator(store, meta, fault_injector=always_fail,
                                max_task_retries=1)
        report = coord.run_job(pkg.make_wordcount_job(
            job_id="fail-1", n_mappers=2, n_reducers=2))
        got[name] = (report.state.value, report.error,
                     meta.get("job:fail-1:state"))
    assert got["port"] == got["jax"]
    assert got["port"][0] == "FAILED" and "permanent failure" in got["port"][1]


def test_speculative_execution_on_straggler():
    store, meta = _stack(core)
    slow_once = {0}

    def inject(role, wid, attempt):
        if role == "mapper" and wid in slow_once:
            slow_once.discard(wid)
            time.sleep(1.2)

    coord = core.Coordinator(store, meta, fault_injector=inject,
                             straggler_factor=3.0, straggler_min_seconds=0.2,
                             speculative_execution=True)
    cfg = core.make_wordcount_job(job_id="spec-1", n_mappers=4, n_reducers=2)
    report = coord.run_job(cfg)
    assert report.state == core.JobState.DONE
    assert report.speculative_launches >= 1
    assert workers.read_final_output(cfg, store) == EXPECTED
    _, _, jstore, _ = _run_wordcount(jcore, n_mappers=4, n_reducers=2)
    assert store.get("output/spec-1/final") == jstore.get("output/wc-1/final")


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax"),
                                        ("port", "port")])
def test_coordinator_restart_resumes_job_across_packages(tmp_path, first,
                                                         then):
    """A job recorded mid-MAPPING by one package's Coordinator is resumed
    from the persisted metadata by the other's, with the same objects."""
    a, b = PKGS[first], PKGS[then]
    store, _ = _stack(a)
    path = str(tmp_path / "meta.json")
    coord = a.Coordinator(store, a.MetadataStore(persist_path=path))
    cfg = a.make_wordcount_job(job_id="restart-1", n_mappers=3, n_reducers=2)
    coord.meta.set(f"job:{cfg.job_id}:config", cfg.to_json())
    coord._set_state(cfg.job_id, a.JobState.MAPPING)
    coord2 = b.Coordinator(store, b.MetadataStore(persist_path=path))
    report = coord2.resume_job(cfg.job_id)
    assert report.state.value == "DONE"
    assert workers.read_final_output(cfg, store) == EXPECTED
    _, _, ref, _ = _run_wordcount(jcore, n_mappers=3, n_reducers=2)
    assert store.get("output/restart-1/final") == ref.get("output/wc-1/final")


def upper_mapper(key, chunk):
    for word in chunk.split():
        yield word.upper(), 1


def count_mapper(key, chunk):
    import json
    for line in chunk.splitlines():
        if line.strip():
            k, v = json.loads(line)
            yield k, v


def sum_reducer(key, values):
    return key, sum(values)


@pytest.mark.parametrize("mappers", [[upper_mapper],
                                     [upper_mapper, count_mapper]],
                         ids=["single", "chained"])
def test_client_jobs_match_reference(mappers):
    """Fig. 4's client: one map stage, or two chained map stages (the
    first map-only, §III-D), with the same stage configs and objects."""
    got = {}
    for name, pkg in PKGS.items():
        store, meta = _stack(pkg)
        job = pkg.Job(payload=pkg.JobConfig(n_mappers=2, n_reducers=2,
                                            job_id="client-1"),
                      mappers=list(mappers), reducer=sum_reducer)
        stages = job.build_stages()
        ids = pkg.MapReduce(pkg.Coordinator(store, meta), [job]).run_sync()
        got[name] = ([s.to_json() for s in stages], ids, _objects(store))
        assert pkg.read_final_output(stages[-1], store) == \
            {k.upper(): v for k, v in EXPECTED.items()}
    assert got["port"] == got["jax"]
    assert len(got["port"][1][0]) == len(mappers)


def test_client_parallel_jobs():
    store, meta = _stack(core)
    jobs = [core.Job(payload=core.JobConfig(n_mappers=2, n_reducers=1),
                     mappers=[upper_mapper], reducer=sum_reducer)
            for _ in range(3)]
    ids = core.MapReduce(core.Coordinator(store, meta), jobs).run_sync()
    assert len(ids) == 3
    for job in jobs:
        out = core.read_final_output(job.build_stages()[-1], store)
        assert out == {k.upper(): v for k, v in EXPECTED.items()}


# -- the corpus half of tests/test_data.py -------------------------------------

@pytest.mark.parametrize("kw", [dict(n_words=1000), dict(
    n_words=5000, vocab_words=50, seed=9), dict(n_words=200, zipf=2.0,
                                                seed=3)])
def test_synth_corpus_is_the_reference_text(kw):
    assert synth_corpus(**kw) == jsynth_corpus(**kw)


@pytest.mark.parametrize("text", ["", "Hello,  World!\n\tagain", "ÀB c.d",
                                  synth_corpus(300, seed=2)])
def test_tokenizer_matches_reference(text):
    assert tokenizer.preprocess(text) == jtokenizer.preprocess(text)
    assert tokenizer.fnv1a(text) == jtokenizer.fnv1a(text)
    for vocab in (7, 512):
        assert tokenizer.HashTokenizer(vocab).encode(text) == \
            jtokenizer.HashTokenizer(vocab).encode(text)


def test_vocab_built_by_mapreduce_job_matches_reference():
    corpus = synth_corpus(20_000, vocab_words=50, seed=9)
    vocabs = {}
    for name, pkg in PKGS.items():
        cfg, report, store, _ = _run_wordcount(pkg, corpus, n_mappers=3,
                                               n_reducers=2)
        assert report.state.value == "DONE"
        counts = pkg.read_final_output(cfg, store)
        mod = jtokenizer if name == "jax" else tokenizer
        vocabs[name] = mod.build_vocab(counts, 32)
    assert vocabs["port"] == vocabs["jax"]
    assert vocabs["port"]["<unk>"] == 0 and len(vocabs["port"]) == 32
    for w, _ in Counter(corpus.split()).most_common(5):
        assert w in vocabs["port"]
    assert build_vocab is tokenizer.build_vocab
