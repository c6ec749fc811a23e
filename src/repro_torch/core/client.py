"""Client package — submitting and monitoring jobs (§III-D, Fig. 3/4).

The paper's users interact through a Python package that (1) extracts the
source of user-defined map/reduce functions and appends it to the JSON
payload, (2) submits each job to the Coordinator, (3) polls job progress from
the Redis metadata, and (4) runs multiple jobs asynchronously.  A job with
several map functions is executed as a *chain* of MapReduce jobs: each map
stage consumes the previous stage's intermediate output; only the last stage
runs the reducer — the client locates intermediate files between stages
(§III-D, the two-mapper example).

This module is that package against our in-process Coordinator.  ``Job`` and
``MapReduce`` mirror the names in the paper's Fig. 4.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Any, Callable

from .coordinator import Coordinator, JobReport, JobState
from .job import JobConfig
from .metadata import job_state_key


@dataclass
class Job:
    """A user-facing job: one or more map functions and an optional reducer,
    exactly the Fig. 4 shape."""

    payload: dict[str, Any] | JobConfig
    mappers: list[Callable]
    reducer: Callable | None = None
    combiner: Callable | None = None
    reports: list[JobReport] = field(default_factory=list)

    def base_config(self) -> JobConfig:
        if isinstance(self.payload, JobConfig):
            return self.payload
        return JobConfig.from_json(dict(self.payload))

    def build_stages(self) -> list[JobConfig]:
        """Compile the multi-map job into chained JobConfigs.

        Stage i>0 reads stage i-1's output prefix; only the final stage gets
        the reducer + finalizer.  Identity-reduce intermediate stages are
        map-only workflows (the paper: 'the first executes the first map
        function only').
        """
        if not self.mappers:
            raise ValueError("need at least one mapper function")
        base = self.base_config()
        stages: list[JobConfig] = []
        prev_output: str | None = None
        n = len(self.mappers)
        for i, map_fn in enumerate(self.mappers):
            cfg = JobConfig.from_json(base.to_json())
            cfg.job_id = f"{base.job_id}-s{i}"
            if prev_output is not None:
                cfg.input_prefix = prev_output
            is_last = i == n - 1
            if is_last:
                cfg.with_functions(map_fn, self.reducer, self.combiner)
                cfg.run_finalizer = base.run_finalizer and self.reducer is not None
                if self.reducer is None:
                    cfg.n_reducers = 0
            else:
                # intermediate stage: map-only; pass records through unreduced
                cfg.with_functions(map_fn)
                cfg.n_reducers = 0
                cfg.run_finalizer = False
                cfg.run_combiner = False
            stages.append(cfg)
            prev_output = f"{cfg.output_prefix.rstrip('/')}/{cfg.job_id}/" \
                if is_last else f"jobs/{cfg.job_id}/intermediate/"
        return stages


class MapReduce:
    """Async multi-job runner (Fig. 4): each job is an asyncio task; the run
    returns the job IDs so users can locate results in storage."""

    def __init__(self, coordinator: Coordinator, jobs: list[Job],
                 logging: bool = False,
                 poll_interval: float = 0.02) -> None:
        self.coordinator = coordinator
        self.jobs = jobs
        self.logging = logging
        self.poll_interval = poll_interval

    # -- monitoring (Fig. 3: the package polls Redis metadata) ---------------
    def job_status(self, job_id: str) -> str:
        return self.coordinator.meta.get(job_state_key(job_id),
                                         JobState.PENDING.value)

    async def _run_job(self, job: Job) -> list[str]:
        loop = asyncio.get_running_loop()
        ids = []
        for cfg in job.build_stages():
            if self.logging:
                print(f"[client] submitting {cfg.job_id} "
                      f"({cfg.n_mappers} mappers / {cfg.n_reducers} reducers)")
            # submit to the coordinator off-thread; poll metadata meanwhile
            fut = loop.run_in_executor(None, self.coordinator.run_job, cfg)
            while not fut.done():
                await asyncio.sleep(self.poll_interval)
                if self.logging:
                    state = self.job_status(cfg.job_id)
                    m = self.coordinator.stage_progress(cfg.job_id, "mapper")
                    r = self.coordinator.stage_progress(cfg.job_id, "reducer")
                    print(f"[client] {cfg.job_id}: {state} "
                          f"(mappers done={m}, reducers done={r})")
            report: JobReport = fut.result()
            job.reports.append(report)
            if report.state != JobState.DONE:
                raise RuntimeError(
                    f"job {cfg.job_id} failed: {report.error}")
            ids.append(cfg.job_id)
        return ids

    async def run(self) -> list[list[str]]:
        """Run all jobs concurrently; returns per-job lists of stage job IDs."""
        return list(await asyncio.gather(
            *(self._run_job(j) for j in self.jobs)))

    def run_sync(self) -> list[list[str]]:
        return asyncio.run(self.run())


class JobServiceClient:
    """The job server's client package — the streaming twin of
    :class:`MapReduce`.

    Two transports, one surface.  *In-process* (``server=``): the
    lifecycle verbs delegate to the server's control plane directly, and
    monitoring reads only the metadata records (``job_record_key``),
    exactly as the paper's client polls Redis rather than the
    coordinator process — a dashboard holding just the MetadataStore
    sees the same state the server wrote.  *Remote* (``address=``): the
    same verbs travel as length-prefixed JSON frames to a
    ``launch.serve.JobSocketServer`` in another process, with
    ``timeout`` bounding every socket operation and ``retries`` bounding
    reconnect attempts; programs are referenced by their server-side
    registered name, since a compiled ``BuiltPipeline`` never crosses
    the wire.  Exactly one of ``server``/``address`` must be given.
    ``run()`` drives the server until every submitted job completes,
    awaiting asynchronously like Fig. 4's multi-job runner.
    """

    def __init__(self, server=None, *, address: tuple[str, int] | None = None,
                 timeout: float = 5.0, retries: int = 2,
                 poll_interval: float = 0.02) -> None:
        if (server is None) == (address is None):
            raise ValueError("pass exactly one of server= (in-process) or "
                             "address= (socket transport)")
        self.server = server
        if address is not None:
            from .rpc import FrameClient
            self._rpc = FrameClient(address, timeout=timeout, retries=retries)
        else:
            self._rpc = None
        self.poll_interval = poll_interval

    def _call(self, method: str, **params: Any) -> Any:
        from .rpc import RPCError
        response = self._rpc.call({"method": method, **params})
        if not response.get("ok"):
            raise RPCError(response.get("error", "rpc call failed"))
        return response.get("result")

    def close(self) -> None:
        """Drop the socket connection, if any.  Idempotent; the next
        remote call redials."""
        if self._rpc is not None:
            self._rpc.close()

    # -- submission / lifecycle verbs (RPC surface) --------------------------
    def submit(self, tenant: str, program, **kwargs) -> str:
        """Submit ``program`` for ``tenant``.  In-process, ``program`` is
        the ``BuiltPipeline`` itself; remote, it is the name the server's
        ``JobRPC.register`` bound."""
        if self.server is not None:
            return self.server.submit(tenant, program, **kwargs)
        return self._call("submit", tenant=tenant, program=program, **kwargs)

    def pause(self, job_id: str) -> None:
        """Park ``job_id`` until an explicit ``resume``."""
        if self.server is not None:
            self.server.pause(job_id)
        else:
            self._call("pause", job_id=job_id)

    def resume(self, job_id: str) -> None:
        """Wake a paused job (a cold restore if it had checkpointed)."""
        if self.server is not None:
            self.server.resume(job_id)
        else:
            self._call("resume", job_id=job_id)

    def cancel(self, job_id: str) -> None:
        """Stop a job for good; persisted windows stay."""
        if self.server is not None:
            self.server.cancel(job_id)
        else:
            self._call("cancel", job_id=job_id)

    def drain(self, timeout: float | None = None) -> dict[str, str]:
        """Drive the server until every job completes; returns {job_id:
        final state}.  Remote drains can far outlast a verb round-trip,
        so ``timeout`` (when given) temporarily widens the socket
        timeout for this one call."""
        if self.server is not None:
            return self.server.run_until_complete()
        if timeout is None:
            return self._call("drain")
        old = self._rpc.timeout
        self._rpc.timeout = timeout
        self._rpc.close()          # reconnect under the widened timeout
        try:
            return self._call("drain")
        finally:
            self._rpc.timeout = old
            self._rpc.close()

    # -- monitoring (metadata-only, like the paper's Redis polling) ----------
    def status(self, job_id: str) -> dict[str, Any]:
        """One job's record: lifecycle state, cursor/checkpointed offset,
        and its compute bill (``pool_seconds``/``fold_invocations``).
        In-process this reads the metadata records only; remote it asks
        the server's ``status`` verb (which reads the same records)."""
        if self.server is None:
            return self._call("status", job_id=job_id)
        from .metadata import job_record_key
        rec = self.server.meta.hgetall(job_record_key(job_id))
        if not rec:
            raise KeyError(f"unknown job: {job_id}")
        return rec

    def jobs(self) -> list[str]:
        """Every registered job id, from the metadata index."""
        if self.server is None:
            return list(self._call("jobs"))
        from .metadata import job_index_key
        return list(self.server.meta.get(job_index_key(), []))

    async def wait(self, job_id: str, states: tuple[str, ...] = ("DONE",
                   "CANCELLED", "FAILED")) -> str:
        """Poll until ``job_id`` reaches one of ``states``; returns it."""
        while True:
            state = self.status(job_id)["state"]
            if state in states:
                return state
            await asyncio.sleep(self.poll_interval)

    async def run(self) -> dict[str, str]:
        """Drive the server to completion; returns {job_id: final state}."""
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(None, self.drain)
        while not fut.done():
            await asyncio.sleep(self.poll_interval)
        fut.result()
        return {jid: self.status(jid)["state"] for jid in self.jobs()}

    def run_sync(self) -> dict[str, str]:
        """Synchronous wrapper over :meth:`run`."""
        return asyncio.run(self.run())
