"""The reference package and the port side by side, for the port's
stage-DAG and join parity tests (``test_torch_dag.py``,
``test_torch_join.py``).

``JAX`` and ``PORT`` carry each package's public names under one set of
attribute names, plus the build options that pick its fold: the
reference's default ``backend="vmap"`` (or ``"pallas"``, its kernel in
interpret mode, where a test moves a checkpoint between the packages —
its flat carry is the port's) and the port's ``device="cpu"`` (the
fold's plain PyTorch version).  ``sync`` turns every scheduler lane off.
"""

import json
from collections import Counter
from types import SimpleNamespace

import numpy as np

from repro.core import MemoryStore as JMemoryStore
from repro.core import MetadataStore as JMetadataStore
from repro.pipeline import JoinSource as JJoinSource
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import PipelineError as JPipelineError
from repro.pipeline import RunOptions as JRunOptions
from repro.pipeline import Windowing as JWindowing
from repro.streaming import StreamingCoordinator as JCoordinator
from repro.streaming import StreamSource as JStreamSource

from repro_torch.core import MemoryStore, MetadataStore
from repro_torch.pipeline import (JoinSource, Pipeline, PipelineError,
                                  RunOptions, Windowing)
from repro_torch.streaming import StreamingCoordinator, StreamSource

W = 4

JAX = SimpleNamespace(
    name="jax", Pipeline=JPipeline, Windowing=JWindowing, Store=JMemoryStore,
    Meta=JMetadataStore, Source=JStreamSource, Coordinator=JCoordinator,
    RunOptions=JRunOptions, JoinSource=JJoinSource, Error=JPipelineError,
    build={}, sync=dict(overlap=False, sink_batching=False,
                        donate_carry=False))
PALLAS = SimpleNamespace(**{**vars(JAX), "name": "pallas",
                            "build": {"backend": "pallas"}})
PORT = SimpleNamespace(
    name="port", Pipeline=Pipeline, Windowing=Windowing, Store=MemoryStore,
    Meta=MetadataStore, Source=StreamSource, Coordinator=StreamingCoordinator,
    RunOptions=RunOptions, JoinSource=JoinSource, Error=PipelineError,
    build={"device": "cpu"}, sync=dict(overlap=False, sink_batching=False))


def events(n=1500, n_keys=6, span=200.0, seed=0, vmax=9):
    """Sorted integer-valued events ``(ts, "k<i>", value)`` from a numpy
    seed — integer values keep every float32 fold exact in any order."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, span, n))
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, vmax, n).astype(float)
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


def region(rec):
    ts, key, value = rec
    return ts, ("even" if int(key[1:]) % 2 == 0 else "odd"), value


def streamed(pk, built, store=None, source=None, **kw):
    """Stream ``built`` (over ``source``, or its bound source) to its end,
    flushed, and return every terminal sink's objects."""
    store = store if store is not None else pk.Store()
    report = built.run(source, store=store, meta=kw.pop("meta", pk.Meta()),
                       mode="streaming", **kw)
    assert report.error is None
    return built.collect_outputs(store)


def decoded(outputs):
    """``window@sink`` → the window's decoded records."""
    return {k.rsplit("/", 1)[1] + "@" + k.split("/", 1)[0]:
            [json.loads(ln) for ln in v.splitlines()]
            for k, v in outputs.items()}


class CountingStore(MemoryStore):
    """Counts every object write (``put_many`` loops ``put``)."""

    def __init__(self):
        super().__init__()
        self.put_counts = Counter()
        self.put_many_calls = []

    def put(self, key, data):
        self.put_counts[key] += 1
        return super().put(key, data)

    def put_many(self, items):
        self.put_many_calls.append(len(items))
        return super().put_many(items)


class Boom(RuntimeError):
    pass


def crashing(base):
    """``base`` coordinator that crashes before micro-batch
    ``crash_batch`` — with the prefetcher on, later batches sit prepared
    and unconsumed."""
    class Crashing(base):
        def __init__(self, *args, crash_batch, **kwargs):
            super().__init__(*args, **kwargs)
            self._crash_batch = crash_batch
            self._processed = 0

        def _process_prepared(self, prep, report):
            if self._processed >= self._crash_batch:
                raise Boom(f"injected crash before batch {prep.index}")
            super()._process_prepared(prep, report)
            self._processed += 1
    return Crashing


def json_meta(meta, Meta):
    """The checkpoint metadata as it comes back from a persistent store:
    a JSON round trip into a fresh metadata store of the other package."""
    fresh = Meta()
    for key in meta.keys():
        fresh.set(key, json.loads(json.dumps(meta.get(key))))
    return fresh


def error_message(fn):
    """The ``PipelineError``/``NotImplementedError`` text ``fn()`` raises
    (``None`` when it raises nothing)."""
    try:
        fn()
    except (JPipelineError, PipelineError, NotImplementedError) as exc:
        return str(exc)
    return None
