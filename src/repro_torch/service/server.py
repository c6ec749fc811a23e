"""The JobServer — many tenants, one engine pool, a parked-job lifecycle.

One server instance holds the four shared substrates — ObjectStore,
MetadataStore, EventBus, ServerlessPool — and multiplexes any number of
``BuiltPipeline`` programs over them:

* **submit/pause/resume/cancel/status** are the control-plane verbs the
  paper's client exercises over HTTP against the Coordinator; here they
  drive metadata-backed :class:`~repro_torch.service.registry.JobRegistry`
  records, so any process holding the MetadataStore observes the same
  lifecycle.  (``launch.serve.JobSocketServer`` puts them behind a real
  socket; :class:`~repro_torch.core.client.JobServiceClient` dials it.)
* **Ingest is physical-once**: every source prefix gets one
  :class:`~repro_torch.service.ingest_share.SharedIngest` (optionally
  N-partitioned — subscribers may drain disjoint partition subsets);
  jobs subscribe with private cursors and ``step()`` pumps each ingest
  exactly once per round regardless of subscriber count.
* **Scale-to-zero lifecycle**: a job whose backlog stays at or below
  ``ParkPolicy.max_lag`` for ``ParkPolicy.idle_seconds`` of wall-clock
  time is *parked* — its lanes drain at the micro-batch barrier (they
  always do), its one-pytree carry state is checkpointed, its
  coordinator is dropped, and when no job remains running the pool
  retires every instance.  Backlog above ``max_lag`` *unparks* it: a
  fresh coordinator cold-restores the checkpoint (measured — this is
  the cold start the paper's Fig. 6 charges) and resumes from the
  checkpointed record offset.  Emission idempotence makes the round
  trip exactly-once: re-finalized windows re-write the same bytes,
  already-persisted ones are skipped.
* **Compute is metered**: every job folds through a
  :class:`~repro_torch.core.autoscaler.MeteredPool` view of the one shared
  pool, so ``status()`` reports per-job pool-seconds and fold
  invocations — the quantities the paper bills — and a tenant's
  ``quota_pool_seconds`` fails only that tenant's jobs with
  :class:`~repro_torch.service.tenancy.ComputeQuotaExceeded`.

The drive loop stays deterministic either way it runs.  Serially,
``step()`` round-robins jobs, each folding its tail to completion.
With ``overlap=True`` (the default) and more than one lagging job,
``step()`` multiplexes the three-lane scheduler across jobs: each
job gets a private prefetch thread host-preparing its next micro-batch
while the driver thread round-robins the fold/drain lanes, so tenant
A's device fold overlaps tenant B's host prepare.  Within a job nothing
leaves the serial order — prepare is pure, folds and key-table
mutations happen on the driver thread batch-by-batch, checkpoints only
at barriers — and across jobs nothing is shared but the pool, bus, and
store (all order-insensitive for sink bytes), so the overlapped drive
is byte-identical to the serial one, crash included (held against the
reference package in ``tests/test_torch_job_service.py``).

A job runs where its program was built: a program built with the default
``device="cuda"`` keeps its carry on the card and folds every micro-batch
through the ``fused_fold`` kernel, on the driver thread's current stream;
the prefetch threads do host work only.  Several tenants' carries live on
the card at once, one per job.  A fold that fails on the card (a kernel
that does not build, load or launch: ``KernelError``) fails that job
through the same path as a storage error — never a re-run elsewhere.
That containment covers what the launch itself reports (a failed build,
a launch-configuration error).  A sticky device fault (an illegal
address) or one that surfaces later at a synchronisation (a torch
``RuntimeError``) is not contained per job: it leaves the CUDA context
unusable for every tenant on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterable

from ..analysis.diagnostics import PlanRejected, errors
from ..core.autoscaler import (AutoscalerConfig, ComputeMeter, MeteredPool,
                               ServerlessPool)
from ..core.events import (TOPIC_JOB_LIFECYCLE, EventBus,
                           job_lifecycle_event)
from ..core.metadata import MetadataStore
from ..core.storage import ObjectStore, StorageError
from ..engine.plan import not_ported
from ..kernels._build import KernelError
from ..streaming.coordinator import (Prefetcher, RunOptions,
                                     StreamingCoordinator, StreamReport,
                                     saved_offset)
from .ingest_share import SharedIngest, SubscriberSource
from .registry import JobRegistry
from .tenancy import ComputeQuotaExceeded, Tenant

__all__ = ["JobServer", "JobStatus", "ParkPolicy"]

#: what fails one job instead of the server: its tenant's store refusing a
#: write (quota, missing object), or its fold's kernel failing to build or
#: launch on the card (not a sticky device fault: see the module docstring)
_JOB_ERRORS = (StorageError, KernelError)


class JobStatus:
    """Lifecycle states — string constants, mirrored into the metadata
    records so clients need no enum import to poll them."""

    PENDING = "PENDING"      # submitted, coordinator not yet built
    RUNNING = "RUNNING"      # live coordinator, folding batches
    PAUSED = "PAUSED"        # parked by explicit request; only resume() wakes
    PARKED = "PARKED"        # scaled to zero; next matching event wakes
    DONE = "DONE"
    CANCELLED = "CANCELLED"
    FAILED = "FAILED"

    TERMINAL = (DONE, CANCELLED, FAILED)


@dataclass(frozen=True)
class ParkPolicy:
    """Wall-clock/lag thresholds for the scale-to-zero lifecycle.

    A RUNNING job whose backlog stays at or below ``max_lag`` records
    for ``idle_seconds`` of wall-clock time parks (barrier checkpoint,
    coordinator dropped, pool retired when nothing else runs); a PARKED
    job wakes only when its backlog exceeds ``max_lag``.  ``max_lag > 0``
    lets small dribbles batch up instead of paying a cold start per
    record; ``idle_seconds=0.0`` parks on the first idle observation
    (what the round-based threshold used to approximate).  The server
    holds one default policy; ``submit(park_policy=...)`` overrides it
    per job.
    """

    idle_seconds: float = 0.25
    max_lag: int = 0

    def validate(self) -> None:
        """Reject unusable thresholds (negative time or lag)."""
        if self.idle_seconds < 0:
            raise ValueError("idle_seconds must be >= 0")
        if self.max_lag < 0:
            raise ValueError("max_lag must be >= 0")


@dataclass
class _Job:
    """Server-side live state for one submitted job.  Everything durable
    lives in the registry records; this holds only what a crash may lose
    (and restore rebuilds): the coordinator and its drive bookkeeping."""

    job_id: str
    tenant: Tenant
    program: Any
    options: RunOptions
    store: ObjectStore                  # the tenant's namespaced view
    ingest: SharedIngest
    sub: SubscriberSource
    park_policy: ParkPolicy
    state: str = JobStatus.PENDING
    coord: StreamingCoordinator | None = None
    report: StreamReport = None
    cursor: int = 0                     # records consumed (live offset)
    idle_since: float | None = None     # monotonic time the backlog emptied
    meter: ComputeMeter = field(default_factory=ComputeMeter)
    error: str | None = None
    cold_start_latencies: list = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.report is None:
            self.report = StreamReport(self.job_id)


class JobServer:
    """Control plane + drive loop over the shared substrates.

    ``park_policy`` sets the default park/wake thresholds (see
    :class:`ParkPolicy`), ``overlap`` turns the multi-tenant overlapped
    drive on (byte-identical to serial, so there is no correctness
    reason to turn it off), and ``ingest_partitions`` is the default
    partition count for newly created shared ingests.
    """

    def __init__(self, store: ObjectStore, meta: MetadataStore | None = None,
                 bus: EventBus | None = None, *,
                 autoscaler: AutoscalerConfig | None = None,
                 park_policy: ParkPolicy | None = None,
                 overlap: bool = True,
                 ingest_partitions: int = 1) -> None:
        self.store = store
        self.meta = meta if meta is not None else MetadataStore()
        self.bus = bus if bus is not None else EventBus()
        self.pool = ServerlessPool("job-server",
                                   autoscaler or AutoscalerConfig())
        self.registry = JobRegistry(self.meta)
        self.park_policy = park_policy if park_policy is not None \
            else ParkPolicy()
        self.park_policy.validate()
        self.overlap = overlap
        self.ingest_partitions = max(1, int(ingest_partitions))
        self.tenants: dict[str, Tenant] = {}
        self.ingests: dict[str, SharedIngest] = {}
        self.jobs: dict[str, _Job] = {}

    # -- tenancy / ingest setup ---------------------------------------------
    def add_tenant(self, name: str, quota_bytes: int | None = None,
                   quota_pool_seconds: float | None = None) -> Tenant:
        """Register (or fetch) a tenant; quotas bound its bytes in the
        shared store and its seconds on the shared pool."""
        if name in self.tenants:
            return self.tenants[name]
        t = Tenant(name, quota_bytes, quota_pool_seconds)
        self.tenants[name] = t
        return t

    def shared_ingest(self, prefix: str, batch_records: int = 1024,
                      n_partitions: int | None = None) -> SharedIngest:
        """The one physical reader for ``prefix`` — created on first use
        (with ``n_partitions`` or the server default), shared by every
        later subscriber."""
        key = prefix.rstrip("/")
        if key not in self.ingests:
            self.ingests[key] = SharedIngest(
                self.bus, self.store, prefix, batch_records=batch_records,
                n_partitions=n_partitions or self.ingest_partitions)
        return self.ingests[key]

    # -- control-plane verbs -------------------------------------------------
    def submit(self, tenant: str, program, *, source_prefix: str,
               options: RunOptions | None = None,
               resume: bool = False,
               partitions: Iterable[int] | None = None,
               park_policy: ParkPolicy | None = None) -> str:
        """Register a program for a tenant against a shared source.

        The registry enforces global job-id uniqueness and rejects
        cross-job sink-prefix collisions on the shared store before the
        job can write anything; ``resume=True`` re-attaches a job that a
        crashed server had already registered — its checkpoint (if any)
        is honored on first drive, so recovery is exactly-once.
        ``partitions`` restricts the job's subscriber to a subset of the
        shared ingest's partitions (parallel jobs splitting one source);
        ``park_policy`` overrides the server's default thresholds.

        Admission runs planlint first: a program with error-level
        findings (a ring that must overflow, colliding sinks, an unfed
        join side) raises :class:`~repro_torch.analysis.diagnostics.PlanRejected`
        *before* the job registers — the plan-level twin of the
        ``QuotaExceeded`` pattern, failing only this tenant's submit.
        """
        if tenant not in self.tenants:
            raise KeyError(f"unknown tenant {tenant!r}; add_tenant first")
        if program.backend == "shard_map":
            raise not_ported("the job service under backend='shard_map'",
                             "Queue A #11")
        bad = errors(program.check())
        if bad:
            raise PlanRejected(bad)
        if park_policy is not None:
            park_policy.validate()
        t = self.tenants[tenant]
        fresh = self.registry.register(
            program.job_id, tenant,
            [t.qualify(p) for p in program.output_prefixes()],
            resume=resume)
        ingest = self.shared_ingest(source_prefix,
                                    batch_records=program.batch_records)
        sub = ingest.subscribe(program.job_id,
                               batch_records=program.batch_records,
                               partitions=partitions)
        job = _Job(job_id=program.job_id, tenant=t, program=program,
                   options=options or RunOptions(),
                   store=t.store_view(self.store), ingest=ingest, sub=sub,
                   park_policy=park_policy or self.park_policy)
        self.jobs[job.job_id] = job
        if fresh:
            self._transition(job, JobStatus.PENDING, verb="submitted")
        else:
            self._transition(job, JobStatus.PENDING, verb="reattached")
        return job.job_id

    def pause(self, job_id: str) -> None:
        """Park immediately on explicit request; only resume() wakes it
        (arriving events do not)."""
        job = self._job(job_id)
        self._check_live(job, "pause")
        if job.coord is not None:
            self._checkpoint(job)
            job.coord = None
        self._transition(job, JobStatus.PAUSED, verb="paused")
        self._maybe_scale_to_zero()

    def resume(self, job_id: str) -> None:
        """Wake a paused job — a cold restore if it had checkpointed."""
        job = self._job(job_id)
        if job.state != JobStatus.PAUSED:
            raise ValueError(f"job {job_id!r} is {job.state}, not PAUSED")
        self._restore(job, verb="resumed")

    def cancel(self, job_id: str) -> None:
        """Stop a job for good.  No flush — half-open windows are
        abandoned; already-persisted windows (and the prefix claim) stay,
        as S3 objects would."""
        job = self._job(job_id)
        self._check_live(job, "cancel")
        job.coord = None
        self._transition(job, JobStatus.CANCELLED, verb="cancelled")
        self._maybe_scale_to_zero()

    def status(self, job_id: str) -> dict[str, Any]:
        """The registry record plus live drive state — what the paper's
        client renders while polling.  Includes the job's compute bill
        (``pool_seconds``/``fold_invocations``) and its durable
        ``checkpointed_offset``.

        A job without a live coordinator (parked, paused, or freshly
        re-attached after a crash) reports position from the barrier
        checkpoint, not from the in-memory cursor — the pre-park live
        counters die with the coordinator, and a re-attached job's
        cursor is 0 until its first drive, which would misreport the
        whole log as lag."""
        job = self._job(job_id)
        rec = self.registry.record(job_id)
        checkpointed = saved_offset(self.meta, job_id)
        cursor = job.cursor if job.coord is not None \
            else max(job.cursor, checkpointed)
        rec.update({
            "job_id": job_id,
            "cursor": cursor,
            "checkpointed_offset": checkpointed,
            "lag": job.sub.lag(cursor),
            "batches": job.report.batches,
            "records_in": job.report.records_in,
            "windows_emitted": job.report.windows_emitted,
            "error": job.error,
            **job.meter.as_dict(),
        })
        return rec

    # -- the drive loop ------------------------------------------------------
    def step(self) -> int:
        """One scheduling round: pump every shared ingest once (the only
        physical log reads), wake parked jobs whose backlog crossed their
        policy's ``max_lag``, drive every runnable job over its available
        tail — overlapped across jobs when more than one has backlog and
        ``overlap`` is on — and park the idle.  Returns records moved
        (pumped + folded) — 0 means quiescent."""
        moved = 0
        for ingest in self.ingests.values():
            moved += ingest.pump()
        runnable: list[_Job] = []
        for job in list(self.jobs.values()):
            if job.state == JobStatus.PARKED \
                    and job.sub.lag(job.cursor) > job.park_policy.max_lag:
                self._restore(job, verb="restored")
            if job.state in (JobStatus.PENDING, JobStatus.RUNNING):
                runnable.append(job)
        lagging = [j for j in runnable
                   if j.sub.lag(j.cursor) > j.park_policy.max_lag]
        if self.overlap and len(lagging) > 1:
            moved += self._drive_overlapped(lagging)
            lagging_ids = {j.job_id for j in lagging}
            rest = [j for j in runnable if j.job_id not in lagging_ids]
        else:
            rest = runnable
        for job in rest:
            if job.state in (JobStatus.PENDING, JobStatus.RUNNING):
                moved += self._drive(job)
        return moved

    def run_until_complete(self, flush: bool = True) -> dict[str, str]:
        """Drive until no ingest yields new records and every job is
        drained, then finish each live job (end-of-stream flush).  Paused
        jobs stay paused — completing them would override an explicit
        operator verb.  Returns {job_id: final state}."""
        while self.step():
            pass
        for job in list(self.jobs.values()):
            if job.state not in JobStatus.TERMINAL + (JobStatus.PAUSED,):
                self.finish(job.job_id, flush=flush)
        return {jid: j.state for jid, j in self.jobs.items()}

    def finish(self, job_id: str, flush: bool = True) -> StreamReport:
        """Drain a job's remaining tail and finalize it: end-of-stream
        watermark through every stage, sinks flushed, final checkpoint —
        the sink bytes now match a standalone flushed run's exactly."""
        job = self._job(job_id)
        self._check_live(job, "finish")
        job.ingest.pump()
        if job.coord is None:
            self._restore(job, verb="restored")
        self._drive(job, park_when_idle=False)
        if job.state == JobStatus.FAILED:
            return job.report
        try:
            if flush:
                job.coord.flush_end_of_stream(job.report)
        except _JOB_ERRORS as exc:
            self._fail(job, exc)
            return job.report
        job.coord = None
        self._transition(job, JobStatus.DONE, verb="done")
        self.registry.update(job_id, cursor=job.cursor)
        self._maybe_scale_to_zero()
        return job.report

    # -- lifecycle internals -------------------------------------------------
    def _job(self, job_id: str) -> _Job:
        if job_id not in self.jobs:
            raise KeyError(f"unknown job: {job_id}")
        return self.jobs[job_id]

    def _check_live(self, job: _Job, verb: str) -> None:
        if job.state in JobStatus.TERMINAL:
            raise ValueError(f"cannot {verb} job {job.job_id!r}: "
                             f"already {job.state}")

    def _transition(self, job: _Job, state: str, *, verb: str) -> None:
        job.state = state
        self.registry.update(job.job_id, state=state, cursor=job.cursor,
                             **job.meter.as_dict())
        self.bus.produce(TOPIC_JOB_LIFECYCLE,
                         job_lifecycle_event(job.job_id, job.tenant.name,
                                             verb, {"cursor": job.cursor}))

    def _checkpoint(self, job: _Job) -> None:
        """Barrier checkpoint: the drive loop only rests at micro-batch
        barriers (lanes drained), so the one-pytree carry snapshot is
        always consistent here."""
        if job.report.batches:
            job.coord.save_state()
        self.registry.update(job.job_id, cursor=job.cursor,
                             **job.meter.as_dict())

    def _restore(self, job: _Job, *, verb: str) -> None:
        """Build (or cold-rebuild) the job's coordinator and restore its
        checkpoint.  Timed end to end — pool activation, carry download,
        tracker/dictionary rebuild — because this *is* the serverless
        cold start the lifecycle trades against idle cost.  The
        coordinator folds through a per-job ``MeteredPool`` view of the
        one shared pool, so its compute bills to this job alone."""
        cold = job.state in (JobStatus.PARKED, JobStatus.PAUSED)
        t0 = time.perf_counter()
        self.pool.ensure_scale(1)
        job.coord = StreamingCoordinator(
            job.store, self.meta, bus=self.bus, program=job.program,
            options=job.options, pool=MeteredPool(self.pool, job.meter))
        job.cursor = job.coord.restore_state()
        dt = time.perf_counter() - t0
        job.idle_since = None
        if cold:
            job.cold_start_latencies.append(dt)
            self.registry.bump(job.job_id, "restores")
            self.registry.bump(job.job_id, "cold_start_seconds", dt)
        self._transition(job, JobStatus.RUNNING, verb=verb)

    def _drive(self, job: _Job, park_when_idle: bool = True) -> int:
        """Fold the job's currently-available tail, batch by batch, at
        its own cursor.  Backlog at or below the job's ``max_lag`` counts
        as idle; idle past ``idle_seconds`` of wall clock parks the job
        (unless the caller — ``finish`` — is about to flush this very
        coordinator, in which case any backlog at all drains)."""
        if job.coord is None:
            self._restore(job, verb="started")
        policy = job.park_policy
        threshold = policy.max_lag if park_when_idle else 0
        if job.sub.lag(job.cursor) <= threshold:
            if park_when_idle:
                now = time.monotonic()
                if job.idle_since is None:
                    job.idle_since = now
                if now - job.idle_since >= policy.idle_seconds \
                        and job.state == JobStatus.RUNNING:
                    self._park(job)
            return 0
        job.idle_since = None
        start = job.cursor
        try:
            job.coord.announce(job.sub, start_record=start)
            for batch in job.sub.batches(start_record=start):
                job.coord.process_batch(batch, job.report)
                job.cursor += len(batch)
                if not self._within_compute_quota(job):
                    break
        except _JOB_ERRORS as exc:
            self._fail(job, exc)
        return job.cursor - start

    def _drive_overlapped(self, jobs: list[_Job]) -> int:
        """Multiplex the three-lane scheduler across jobs: one private
        prefetch thread per job host-prepares its next micro-batches
        (bounded by its own ``RunOptions.prefetch_batches``) while this
        driver thread round-robins ``process_prepared`` — device fold,
        watermark, sink/stats drains — across jobs in per-job batch
        order.

        Byte-identity with the serial drive holds by construction:
        prepare is pure (``@lane("prefetch")``), every mutation of a
        job's key tables, carries, and sinks happens here on the driver
        thread in that job's batch order, and jobs share nothing whose
        bytes depend on cross-job order (per-job consumer groups on the
        bus, tenant-namespaced stores, a synchronous pool).  A failing
        job closes its own lanes and fails alone; a crash behaves like
        the serial crash — prepared-but-unconsumed batches simply never
        advance the checkpoint, so restart replays them exactly-once.
        """
        lanes: list[tuple[_Job, Any, Any]] = []
        for job in jobs:
            if job.coord is None:
                self._restore(job, verb="started")
            job.idle_since = None
            job.coord.announce(job.sub, start_record=job.cursor)
            prefetch = Prefetcher(job.sub.batches(start_record=job.cursor),
                                  job.coord.prepare_batch,
                                  job.options.prefetch_batches)
            lanes.append((job, iter(prefetch), prefetch))
        moved = 0
        try:
            while lanes:
                still: list[tuple[_Job, Any, Any]] = []
                for lane in lanes:
                    job, batches, prefetch = lane
                    try:
                        prep = next(batches)
                    except StopIteration:
                        prefetch.close()
                        continue
                    except _JOB_ERRORS as exc:
                        prefetch.close()
                        self._fail(job, exc)
                        continue
                    try:
                        job.coord.process_prepared(prep, job.report)
                    except _JOB_ERRORS as exc:
                        prefetch.close()
                        self._fail(job, exc)
                        continue
                    job.cursor += prep.n_records
                    moved += prep.n_records
                    if self._within_compute_quota(job):
                        still.append(lane)
                    else:
                        prefetch.close()
                lanes = still
        finally:
            for _, _, prefetch in lanes:
                prefetch.close()
        return moved

    def _within_compute_quota(self, job: _Job) -> bool:
        """Enforce the tenant's pool-time quota against the summed meters
        of all its jobs; over quota fails THIS job (its neighbors keep
        their own accounts) and reports False so drive loops stop charging
        it."""
        quota = job.tenant.quota_pool_seconds
        if quota is None:
            return True
        used = sum(j.meter.pool_seconds for j in self.jobs.values()
                   if j.tenant.name == job.tenant.name)
        if used <= quota:
            return True
        self._fail(job, ComputeQuotaExceeded(
            f"tenant {job.tenant.name!r} used {used:.6f}s of its "
            f"{quota:.6f}s pool-time quota"))
        return False

    def _park(self, job: _Job) -> None:
        """Scale-to-zero: checkpoint at the barrier, drop the coordinator
        (frees the device carries), retire pool instances if nothing else
        runs.  The job's next matching event cold-restores it."""
        self._checkpoint(job)
        job.coord = None
        self.registry.bump(job.job_id, "parks")
        self._transition(job, JobStatus.PARKED, verb="parked")
        self._maybe_scale_to_zero()

    def _fail(self, job: _Job, exc: Exception) -> None:
        job.error = f"{type(exc).__name__}: {exc}"
        job.coord = None
        self.registry.update(job.job_id, error=job.error)
        self._transition(job, JobStatus.FAILED, verb="failed")
        self._maybe_scale_to_zero()

    def _maybe_scale_to_zero(self) -> None:
        if not any(j.state == JobStatus.RUNNING
                   for j in self.jobs.values()):
            self.pool.scale_to_zero()

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """Server-wide snapshot: job states, shared-pool counters,
        per-ingest pump accounting, and per-job compute meters."""
        return {
            "jobs": {jid: j.state for jid, j in self.jobs.items()},
            "pool": self.pool.stats(),
            "ingests": {key: {"pumped": ing.pumped, "pumps": ing.pumps,
                              "partitions": ing.n_partitions,
                              "subscribers": len(ing.subscribers)}
                        for key, ing in self.ingests.items()},
            "meters": {jid: j.meter.as_dict()
                       for jid, j in self.jobs.items()},
        }
