"""Scheduler-lane annotations for the pipelined streaming coordinator.

The streaming drive loop runs three lanes with a byte-identity contract:

* ``prefetch`` — the background prepare thread.  May touch only the
  immutable program (source reads, fused map chains); key-id assignment
  and every piece of mutable stage state stay off-limits, or output bytes
  would depend on thread timing.
* ``driver`` — the main thread's fold path.  Owns key tables, ring
  admission, carries.  Must not force device→host syncs mid-batch
  (``np.asarray`` on a step result, ``.block_until_ready``), or the
  async dispatch pipeline stalls per fold instead of per barrier.
* ``barrier`` — the micro-batch boundary: deferred stats drains, batched
  sink flushes, checkpoints.  The only lane where host syncs are part of
  the design.

``@lane(name)`` is a **no-op at runtime** — it tags the function (and
sets ``__lane__`` for introspection) so ``repro.analysis.reprolint`` can
enforce the contract statically: host-sync calls inside ``driver``/
``prefetch`` functions are RL102 errors, and mutations of attributes
declared in the module's ``LANE_SHARED`` table from a lane outside the
attribute's allowed set are RL103 errors.  The convention this replaces
was a docstring.
"""

from __future__ import annotations

from typing import Callable, TypeVar

LANES = ("driver", "prefetch", "barrier")

_F = TypeVar("_F", bound=Callable)

__all__ = ["LANES", "lane"]


def lane(name: str) -> Callable[[_F], _F]:
    """Tag a coordinator method with the scheduler lane it runs on."""
    if name not in LANES:
        raise ValueError(f"unknown lane {name!r}; lanes are {LANES}")

    def mark(fn: _F) -> _F:
        fn.__lane__ = name
        return fn

    return mark
