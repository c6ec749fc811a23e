"""Scale-to-zero worker pool — the Knative stand-in.

The paper's workers are Knative Services/JobSinks: zero replicas until an event
arrives, then the autoscaler (KPA) brings instances up toward a concurrency
target, and back down to zero after an idle window.  Cold starts are the reason
the paper's Fig. 6 is flat at small inputs — activation latency dominates.

This module reproduces those dynamics so the benchmarks can show the same
curve: a ``ServerlessPool`` holds *deactivated* worker factories; incoming
events activate instances (paying a configurable ``cold_start`` delay once per
instance), a KPA-style loop sizes the pool as ``ceil(concurrency /
target_concurrency)`` bounded by ``max_scale``, and instances retire to zero
after ``scale_to_zero_grace`` of idleness.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class AutoscalerConfig:
    target_concurrency: int = 1        # KPA default: 1 request per instance
    max_scale: int = 64
    min_scale: int = 0                 # scale-to-zero
    cold_start: float = 0.0            # seconds to activate an instance
    scale_to_zero_grace: float = 30.0  # idle seconds before retiring


@dataclass
class _Instance:
    id: int
    started: float
    busy: bool = False
    last_used: float = field(default_factory=time.time)


class ServerlessPool:
    """A pool of identical workers with scale-from-zero semantics.

    ``submit(task)`` behaves like an event hitting a Knative service: if a warm
    idle instance exists it runs immediately; otherwise a new instance is
    activated (cold start) provided we are under ``max_scale``; otherwise the
    task queues.  Execution is synchronous in the caller's thread (workers in
    this framework are deterministic stage functions); the pool tracks *which*
    instance ran it and the latency split (cold start vs execution) so
    benchmarks can report the paper's phase numbers.
    """

    def __init__(self, name: str, config: AutoscalerConfig | None = None) -> None:
        self.name = name
        self.config = config or AutoscalerConfig()
        self._instances: dict[int, _Instance] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        # instrumentation
        self.cold_starts = 0
        self.total_invocations = 0
        self.cold_start_seconds = 0.0
        self.scale_downs = 0           # retire events (reap / scale-to-zero)
        self._last_active = time.time()

    # -- KPA / KEDA sizing ----------------------------------------------------
    def _clamped_scale(self, demand: int, per_replica: int) -> int:
        c = self.config
        want = math.ceil(demand / max(1, per_replica))
        return max(c.min_scale, min(c.max_scale, want))

    def desired_scale(self, concurrency: int) -> int:
        """KPA sizing: in-flight requests over the concurrency target."""
        return self._clamped_scale(concurrency, self.config.target_concurrency)

    def desired_scale_from_backlog(self, backlog: int,
                                   per_replica: int = 1) -> int:
        """KEDA-style sizing from queue depth: unconsumed events (consumer
        lag) divided by the per-replica drain rate.  The streaming
        coordinator feeds it ``bus.lag(...)`` so the pool tracks
        backpressure instead of a fixed split count."""
        return self._clamped_scale(backlog, per_replica)

    def ensure_scale(self, n: int) -> int:
        """Pre-activate instances up to ``n`` (paying cold starts now, not on
        the critical path of the next batch).  Returns replicas added."""
        n = min(n, self.config.max_scale)
        added = 0
        with self._lock:
            while len(self._instances) < n:
                inst = _Instance(id=self._next_id, started=time.time())
                self._next_id += 1
                self._instances[inst.id] = inst
                self.cold_starts += 1
                self.cold_start_seconds += self.config.cold_start
                added += 1
            if added:
                self._last_active = time.time()
        if added and self.config.cold_start > 0:
            # concurrent activations: one cold-start wait, not ``added``
            time.sleep(self.config.cold_start)
        return added

    def replicas(self) -> int:
        with self._lock:
            return len(self._instances)

    # -- instance lifecycle ----------------------------------------------------
    def _acquire(self) -> tuple[_Instance, bool]:
        """Returns (instance, was_cold)."""
        with self._lock:
            for inst in self._instances.values():
                if not inst.busy:
                    inst.busy = True
                    inst.last_used = time.time()
                    return inst, False
            if len(self._instances) < self.config.max_scale:
                inst = _Instance(id=self._next_id, started=time.time(), busy=True)
                self._next_id += 1
                self._instances[inst.id] = inst
                return inst, True
        # pool saturated: wait for an idle instance
        while True:
            time.sleep(0.001)
            with self._lock:
                for inst in self._instances.values():
                    if not inst.busy:
                        inst.busy = True
                        inst.last_used = time.time()
                        return inst, False

    def _release(self, inst: _Instance) -> None:
        with self._lock:
            inst.busy = False
            inst.last_used = time.time()

    def reap_idle(self) -> int:
        """Retire instances idle past the grace window (scale-to-zero),
        never shrinking below ``min_scale``."""
        now = time.time()
        with self._lock:
            idle = [i for i, inst in self._instances.items()
                    if not inst.busy
                    and now - inst.last_used > self.config.scale_to_zero_grace]
            allowed = max(0, len(self._instances) - self.config.min_scale)
            dead = idle[:allowed]
            for i in dead:
                del self._instances[i]
            self.scale_downs += len(dead)
        return len(dead)

    def scale_to_zero(self) -> int:
        """Retire every idle instance immediately — the job server's park
        path, which need not wait out the grace window because the barrier
        checkpoint already made the workers' state recoverable.  Returns
        instances retired."""
        with self._lock:
            keep = {i: inst for i, inst in self._instances.items()
                    if inst.busy}
            retired = len(self._instances) - len(keep)
            self._instances = keep
            self.scale_downs += retired
        return retired

    def idle_for(self) -> float:
        """Seconds since the pool last ran (or pre-activated) anything —
        the lifecycle controller's park signal."""
        with self._lock:
            return time.time() - self._last_active

    # -- invocation -------------------------------------------------------------
    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        inst, cold = self._acquire()
        self.total_invocations += 1
        self._last_active = time.time()
        if cold:
            self.cold_starts += 1
            if self.config.cold_start > 0:
                time.sleep(self.config.cold_start)
            self.cold_start_seconds += self.config.cold_start
        try:
            return fn(*args, **kwargs)
        finally:
            self._release(inst)

    def stats(self) -> dict[str, Any]:
        return {
            "pool": self.name,
            "replicas": self.replicas(),
            "cold_starts": self.cold_starts,
            "invocations": self.total_invocations,
            "cold_start_seconds": round(self.cold_start_seconds, 6),
            "scale_downs": self.scale_downs,
        }


@dataclass
class ComputeMeter:
    """One job's compute account: wall-clock seconds spent inside pool
    invocations plus the invocation count — the two quantities serverless
    platforms actually bill (GB-seconds and requests).  The job server
    attaches one meter per job via :class:`MeteredPool` and enforces
    per-tenant ``quota_pool_seconds`` against the summed accounts, the
    compute-side twin of the storage byte quota."""

    pool_seconds: float = 0.0
    invocations: int = 0

    def as_dict(self) -> dict[str, Any]:
        """Metering fields in the shape ``JobServer.status()`` reports."""
        return {"pool_seconds": round(self.pool_seconds, 6),
                "fold_invocations": self.invocations}


class MeteredPool:
    """A per-job accounting view of a shared :class:`ServerlessPool`.

    ``submit`` delegates to the shared pool while charging the elapsed
    wall time and one invocation to this view's :class:`ComputeMeter`;
    every other attribute proxies straight through, so a coordinator
    holding a ``MeteredPool`` sees the real pool's scaling, replica, and
    instrumentation surface unchanged.  This is how N tenants fold on
    ONE physical pool yet each receives its own bill.
    """

    def __init__(self, inner: ServerlessPool,
                 meter: ComputeMeter | None = None) -> None:
        self._inner = inner
        self.meter = meter if meter is not None else ComputeMeter()

    def submit(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        start = time.perf_counter()
        try:
            return self._inner.submit(fn, *args, **kwargs)
        finally:
            self.meter.pool_seconds += time.perf_counter() - start
            self.meter.invocations += 1

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)
