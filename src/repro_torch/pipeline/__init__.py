"""Declarative pipeline dataflow — the one front door for batch and
streaming.

``Pipeline.from_source(...).map(fn).key_by(...).window(...).reduce(...)
.top_k(k).sink(prefix).build(device=...)`` declares a dataflow graph;
``build()`` validates it and lowers it to a ``repro_torch.engine`` plan;
the built program runs in batch mode or streaming mode with bit-identical
per-window results.  An array pipeline (``from_source(shards=...)
.map(udf).reduce("sum")``) runs once over its worker shards.
"""

from .graph import Pipeline, PipelineError, Windowing
from .lower import BuiltPipeline, EmitSpec, SidePlan, SourceSpec, StagePlan
from .runtime import RunOptions, resolve_source, run, run_batch

__all__ = [
    "Pipeline", "PipelineError", "Windowing", "BuiltPipeline", "EmitSpec",
    "SidePlan", "SourceSpec", "StagePlan", "RunOptions", "resolve_source",
    "run", "run_batch",
]
