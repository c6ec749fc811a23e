"""Declarative pipeline dataflow — the one front door for batch and
streaming.

``Pipeline.from_source(...).map(fn).key_by(...).window(...).reduce(...)
.top_k(k).sink(prefix).build(device=...)`` declares a dataflow graph;
``.join(other)`` and ``.tee(branch, ...)`` make it a stage DAG (a chain
may also continue past a reduce); ``build()`` validates it and lowers it
to ``repro_torch.engine`` plans; the built program runs in batch mode or
streaming mode with bit-identical per-window results on every branch.
An array pipeline (``from_source(shards=...).map(udf).reduce("sum")``)
runs once over its worker shards.
"""

from .graph import Pipeline, PipelineError, Windowing
from .lower import (BuiltPipeline, EmitSpec, SidePlan, SourceSpec, StageEdge,
                    StagePlan)
from .runtime import JoinSource, RunOptions, resolve_source, run, run_batch

__all__ = [
    "Pipeline", "PipelineError", "Windowing", "BuiltPipeline", "EmitSpec",
    "SidePlan", "SourceSpec", "StageEdge", "StagePlan", "JoinSource",
    "RunOptions", "resolve_source", "run", "run_batch",
]
