"""Structured diagnostics — the shared currency of planlint and reprolint.

Both analyzers report ``Diagnostic`` records instead of raising on first
sight: a plan check surfaces *every* finding in one pass (the paper's
admission story — reject a bad job before it holds pool replicas, with a
message naming each problem), and the AST lint aggregates findings across
a whole tree for one CLI report.

Severity levels:

* ``error`` — the program must misbehave (ring overflow, colliding sinks,
  a mutation off its declared lane).  ``JobServer.submit`` rejects on
  these; the lint CLI exits non-zero.
* ``warning`` — probabilistically or configuration-dependently wrong
  (hash-collision odds above threshold, a group buffer a skewed batch can
  overflow).  ``Pipeline.build`` surfaces these as ``PlanLintWarning``.
* ``info`` — advisory context shown by ``BuiltPipeline.explain()`` only.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

from ..pipeline.graph import PipelineError

ERROR = "error"
WARNING = "warning"
INFO = "info"

_LEVEL_RANK = {INFO: 0, WARNING: 1, ERROR: 2}


@dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding: a stable rule id, a severity, a message, and
    where — a plan location (``stage 1``, ``edge 0→1``, ``program``) for
    planlint, a ``path``/``line`` pair for reprolint."""

    rule_id: str
    level: str                      # "error" | "warning" | "info"
    message: str
    loc: str = "program"            # planlint: stage/edge/program location
    path: str | None = None         # reprolint: offending file
    line: int = 0                   # reprolint: 1-based line in ``path``

    def format(self) -> str:
        where = f"{self.path}:{self.line}" if self.path else self.loc
        return f"{where}: {self.rule_id} {self.level}: {self.message}"


class PlanLintWarning(UserWarning):
    """A build-time planlint finding.  ``Pipeline.build`` warns (the graph
    may be headed somewhere that fixes it — a test rig, a doc snippet);
    admission (``JobServer.submit``) rejects error-level findings."""


class PlanRejected(PipelineError):
    """A program failed planlint at admission — the plan-level twin of
    ``core.storage.QuotaExceeded``: raised before the job registers, so
    only the offending tenant's submit fails."""

    def __init__(self, diagnostics) -> None:
        self.diagnostics = tuple(diagnostics)
        detail = "; ".join(d.format() for d in self.diagnostics)
        super().__init__(
            f"planlint rejected the program ({len(self.diagnostics)} "
            f"error{'s' if len(self.diagnostics) != 1 else ''}): {detail}")


def errors(diagnostics) -> list[Diagnostic]:
    return [d for d in diagnostics if d.level == ERROR]


def max_level(diagnostics) -> str | None:
    """The most severe level present, or None for an empty report."""
    if not diagnostics:
        return None
    return max(diagnostics, key=lambda d: _LEVEL_RANK[d.level]).level


def format_report(diagnostics, *, min_level: str = INFO) -> str:
    """Human-readable multi-line report, most severe first."""
    floor = _LEVEL_RANK[min_level]
    rows = sorted((d for d in diagnostics
                   if _LEVEL_RANK[d.level] >= floor),
                  key=lambda d: -_LEVEL_RANK[d.level])
    if not rows:
        return "no findings"
    return "\n".join(d.format() for d in rows)


def warn_diagnostics(diagnostics, *, stacklevel: int = 3) -> None:
    """Surface warning- and error-level findings as ``PlanLintWarning``s —
    the build-time integration (builds stay usable; admission rejects)."""
    for d in diagnostics:
        if _LEVEL_RANK[d.level] >= _LEVEL_RANK[WARNING]:
            warnings.warn(d.format(), PlanLintWarning, stacklevel=stacklevel)
