"""MapReduce job configuration — the paper's JSON input (§III-C).

The paper's client sends the Coordinator a JSON document with: input/output S3
locations, the number of Mapper and Reducer components, whether a Finalizer
runs, text/binary split mode, buffer sizes, the spill threshold as a percent,
the reducer merge fan-in (k of the k-way merge), the multipart size, and the
user-defined map/reduce function *source code* (the client package extracts it
with ``inspect.getsource`` and appends it to the payload — Fig. 4/5).

``JobConfig`` is that document, with validation and (de)serialization.  UDFs
travel as source strings and are re-materialized in the worker with ``exec`` —
the same mechanism the paper uses to ship Python functions into containers.
"""

from __future__ import annotations

import inspect
import json
import textwrap
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Iterable, Iterator

MB = 1024 * 1024


@dataclass
class JobConfig:
    # locations
    input_prefix: str = "input/"
    output_prefix: str = "output/"
    # component counts — the paper's evaluation uses 4 mappers / 2 reducers
    n_mappers: int = 4
    n_reducers: int = 2
    run_finalizer: bool = True
    # split mode: text extends chunk boundaries to record separators (§III-A.2)
    binary_input: bool = False
    record_separator: bytes = b"\n"
    # buffers — paper defaults: 50 MB in/out buffers, 5 MB multipart,
    # 75% spill threshold, merge fan-in 100
    input_buffer_bytes: int = 50 * MB
    output_buffer_bytes: int = 50 * MB
    multipart_bytes: int = 5 * MB
    spill_threshold: float = 0.75
    merge_fan_in: int = 100
    # combiner (local reduce before spill — §II-A.1)
    run_combiner: bool = True
    # UDF source code (shipped as strings, per the paper's client package)
    mapper_src: str = ""
    reducer_src: str = ""
    combiner_src: str = ""          # defaults to reducer when combiner enabled
    # identity
    job_id: str = field(default_factory=lambda: uuid.uuid4().hex[:12])

    # -- validation ---------------------------------------------------------
    def validate(self) -> None:
        if self.n_mappers < 1:
            raise ValueError("need at least one mapper")
        if self.n_reducers < 0:
            raise ValueError("n_reducers must be >= 0 (0 = map-only workflow)")
        if not (0.0 < self.spill_threshold <= 1.0):
            raise ValueError("spill_threshold is a fraction in (0, 1]")
        if self.merge_fan_in < 2:
            raise ValueError("merge fan-in must be >= 2")
        if not self.mapper_src:
            raise ValueError("mapper source is required")
        if self.n_reducers > 0 and not self.reducer_src:
            raise ValueError("reducer source required when reducers requested")

    # -- JSON wire format ------------------------------------------------------
    def to_json(self) -> str:
        d = asdict(self)
        d["record_separator"] = self.record_separator.decode("latin-1")
        return json.dumps(d)

    @classmethod
    def from_json(cls, blob: str | dict[str, Any]) -> "JobConfig":
        d = dict(json.loads(blob)) if isinstance(blob, str) else dict(blob)
        if isinstance(d.get("record_separator"), str):
            d["record_separator"] = d["record_separator"].encode("latin-1")
        return cls(**d)

    # -- UDF handling ------------------------------------------------------------
    @staticmethod
    def extract_source(fn: Callable) -> str:
        """What the client package does to user functions (Fig. 4)."""
        return textwrap.dedent(inspect.getsource(fn))

    def with_functions(self, mapper: Callable, reducer: Callable | None = None,
                       combiner: Callable | None = None) -> "JobConfig":
        self.mapper_src = self.extract_source(mapper)
        if reducer is not None:
            self.reducer_src = self.extract_source(reducer)
        if combiner is not None:
            self.combiner_src = self.extract_source(combiner)
        return self


def load_udf(src: str) -> Callable:
    """Materialize a shipped UDF in a worker.

    The namespace is restricted to builtins — UDFs in this framework are pure
    record transforms, as in the paper's word-count example (Fig. 5).
    """
    ns: dict[str, Any] = {}
    exec(src, ns)  # noqa: S102 - the paper ships user code the same way
    fns = [v for k, v in ns.items()
           if callable(v) and not k.startswith("__")]
    if not fns:
        raise ValueError("UDF source defines no function")
    return fns[0]


# -- the paper's Fig. 5 word-count UDFs, used across tests/benchmarks --------

def wordcount_mapper(key: Any, chunk: str) -> Iterator[tuple[str, int]]:
    for word in chunk.split():
        yield word, 1


def wordcount_reducer(key: str, values: Iterable[int]) -> tuple[str, int]:
    total = sum(values)
    return key, total


def make_wordcount_job(**overrides: Any) -> JobConfig:
    cfg = JobConfig(**overrides)
    return cfg.with_functions(wordcount_mapper, wordcount_reducer)
