"""Static checks over lowered plans (planlint) and the scheduler-lane
annotations the coordinator carries — copied from the reference package.

Submodules resolve lazily so importing the lane decorator never drags in
the plan layer."""

from __future__ import annotations

from .lanes import LANES, lane

_LAZY = {
    "Diagnostic": "diagnostics", "PlanLintWarning": "diagnostics",
    "PlanRejected": "diagnostics", "ERROR": "diagnostics",
    "WARNING": "diagnostics", "INFO": "diagnostics",
    "errors": "diagnostics", "format_report": "diagnostics",
    "check_plan": "planlint", "explain_plan": "planlint",
    "min_slots_required": "planlint", "collision_probability": "planlint",
}

__all__ = ["LANES", "lane", *sorted(_LAZY)]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
