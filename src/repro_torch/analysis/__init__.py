"""repro_torch.analysis — static checks for plans and for the tree.

The partner of ``repro.analysis``.  Three passes share the
:class:`~repro_torch.analysis.diagnostics.Diagnostic` currency:

* **planlint** (:mod:`repro_torch.analysis.planlint`) — semantic rules
  over a lowered ``BuiltPipeline`` (ring depth, hash-collision odds,
  group capacity, watermark wiring, sink prefixes).  Runs at
  ``Pipeline.build()`` (warnings), on demand via ``BuiltPipeline.check()``
  / ``explain()``, and over modules of pipelines via ``python -m
  repro_torch.analysis.planlint``.
* **reprolint** (:mod:`repro_torch.analysis.reprolint`) — stdlib-``ast``
  lint of the port's invariants (the collectives' one home, lane safety,
  stage and kernel body purity, documented exports), driven by ``python
  -m repro_torch.analysis.lint``.
* **docsmoke** (:mod:`repro_torch.analysis.docsmoke`) — executes the
  fenced ```python`` blocks in README + ``docs/``; ``python -m
  repro_torch.analysis.docsmoke``.

Submodules resolve lazily so importing the lane decorator never drags
in the plan layer.
"""

from __future__ import annotations

from .lanes import LANES, lane

_LAZY = {
    "Diagnostic": "diagnostics", "PlanLintWarning": "diagnostics",
    "PlanRejected": "diagnostics", "ERROR": "diagnostics",
    "WARNING": "diagnostics", "INFO": "diagnostics",
    "errors": "diagnostics", "format_report": "diagnostics",
    "check_plan": "planlint", "explain_plan": "planlint",
    "min_slots_required": "planlint", "collision_probability": "planlint",
    "lint_source": "reprolint", "lint_file": "reprolint",
    "lint_paths": "reprolint",
    "extract_snippets": "docsmoke", "run_paths": "docsmoke",
}

__all__ = ["LANES", "lane", *sorted(_LAZY)]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
