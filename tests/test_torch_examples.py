"""The port's examples (``examples_torch/``) on the CPU, against the
reference's (``examples/``).

Each example's ``main`` runs with ``--device cpu`` (the kernels' plain
versions) at the CI caps (``STREAM_GPS_DURATION=120``,
``JOB_SERVER_DURATION=120``; ``train_lm`` at 3 steps of 2 × 32 tokens)
and makes its reference counterpart's assertions.  ``stream_gps``'s and
``job_server``'s sink objects and ``quickstart``'s counts are held byte
for byte against the reference example's own functions at the same cap
(JAX on the CPU).  No file of ``examples_torch/`` imports the reference
or JAX, planlint's CLI in the port passes on its default path
(``examples_torch``), and the directory lints clean under the port's
reprolint.
"""

import ast
import importlib.util
import pathlib
from collections import Counter

import numpy as np
import pytest

from repro_torch.analysis import lint, planlint

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
NAMES = ("quickstart", "stream_gps", "pipeline_jobs", "job_server",
         "serve_lm", "train_lm")
CAPS = {"STREAM_GPS_DURATION": "120", "JOB_SERVER_DURATION": "120"}


@pytest.fixture
def load(monkeypatch):
    """Load ``<dir>/<name>.py`` as a fresh module under the CI caps (the
    examples read them when imported)."""
    for var, value in CAPS.items():
        monkeypatch.setenv(var, value)

    def _load(directory, name):
        path = ROOT / directory / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"_{directory}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return _load


def test_the_six_counterparts_import_neither_the_reference_nor_jax():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)
    for path in EXAMPLES.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"repro", "jax"} & set(roots), (path.name, roots)


def test_quickstart_counts_equal_the_reference(load):
    """Both planes' exact word counts, equal to the reference's host plane
    and its device engine (``backend="vmap"``) on the same corpus."""
    from repro.core import (Coordinator, MemoryStore, MetadataStore,
                            make_wordcount_job, read_final_output)
    from repro.core.mapreduce import wordcount_map_factory
    from repro.data.pipeline import synth_corpus
    from repro.pipeline import Pipeline

    got = load("examples_torch", "quickstart").main(["--device", "cpu"])
    corpus = synth_corpus(100_000, vocab_words=2000, seed=0)
    store = MemoryStore()
    store.put("input/corpus.txt", corpus.encode())
    cfg = make_wordcount_job(n_mappers=4, n_reducers=2)
    Coordinator(store, MetadataStore()).run_job(cfg)
    want = read_final_output(cfg, store)
    assert got["host"] == want == dict(Counter(corpus.split()))
    vocab = {w: i for i, w in enumerate(sorted(want))}
    tok = np.array([vocab[w] for w in corpus.split()], dtype=np.int32)
    n = (len(tok) + 7) // 8 * 8
    toks = np.concatenate([tok, np.full(n - len(tok), -1, np.int32)])
    shard = np.stack([toks.reshape(8, -1), np.ones((8, n // 8), np.int32)],
                     axis=-1)
    res, _ = (Pipeline.from_source(shards=shard)
              .map(wordcount_map_factory(len(vocab))).reduce("sum")
              .build(num_buckets=len(vocab), n_workers=8, backend="vmap")
              .run_batch(data=shard))
    res = np.asarray(res)
    assert got["device"] == {w: int(res[i]) for w, i in vocab.items()}


def test_stream_gps_sinks_equal_the_reference(load):
    """The streaming run's windows (already equal to its batch flip and
    the oracle inside ``main``) equal the reference example's fleet
    pipeline over its own events, byte for byte."""
    from repro.core import MemoryStore
    from repro.pipeline import RunOptions
    from repro.streaming import write_event_log

    got = load("examples_torch", "stream_gps").main(["--device", "cpu"])
    ref = load("examples", "stream_gps")
    store = MemoryStore()
    write_event_log(store, "streams/gps", ref.synth_gps_events(),
                    segment_records=4096)
    built = ref.fleet_pipeline().build(num_buckets=8, n_workers=4,
                                       allowed_lateness=5.0,
                                       job_id="gps-fleet")
    built.run(store=store, options=RunOptions(overlap=True,
                                              prefetch_batches=2,
                                              sink_batching=True))
    want = {m.key: store.get(m.key)
            for m in store.list_objects("stream-output/gps-fleet/")}
    assert want and got == want


def test_job_server_sinks_equal_the_reference(load):
    """Both tenants' sinks after the park / append / cold-restore round
    trip equal the reference example's ``standalone_sink`` of each
    program, byte for byte."""
    got = load("examples_torch", "job_server").main(["--device", "cpu"])
    ref = load("examples", "job_server")
    events = ref.synth_gps_events()
    assert got["gps-speed"] == ref.standalone_sink(events, "gps-speed",
                                                   "mean")
    assert got["gps-bill"] == ref.standalone_sink(events, "gps-bill",
                                                  "count")
    assert got["gps-speed"] and got["gps-bill"]


def test_pipeline_jobs_runs_its_assertions(load):
    """Conservation across the pipelines, the two-phase ranking and the
    tee'd branches' batch ↔ streaming identity, asserted inside ``main``."""
    out = load("examples_torch", "pipeline_jobs").main(["--device", "cpu"])
    assert set(out) == {"words", "letters", "hot", "two-phase", "gps-fan"}
    assert all(out.values())


def test_serve_lm_serves_every_request(load):
    assert load("examples_torch", "serve_lm").main(["--device", "cpu"]) == \
        10 * 24


def test_train_lm_loss_falls(load):
    log = load("examples_torch", "train_lm").main(
        ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "32",
         "--corpus-words", "20000"])
    assert len(log) == 3 and log[-1]["loss"] < log[0]["loss"]


def test_planlint_and_reprolint_pass_on_the_examples(monkeypatch, capsys):
    """planlint's CLI in the port checks ``examples_torch`` by default and
    finds no error; the port's reprolint finds nothing there."""
    monkeypatch.chdir(ROOT)
    assert planlint.main([]) == 0
    out = capsys.readouterr().out
    assert "examples_torch/stream_gps.py:gps-fleet: clean" in out
    assert out.splitlines()[-1] == "planlint: 10 program(s) checked, 0 error(s)"
    assert lint.main(["examples_torch"]) == 0
