"""Coordinator — the job state machine (§III-A.1).

The Coordinator is the entry point: it receives the JSON job config, assigns
work to the Splitter, creates and synchronizes Mapper/Reducer/Finalizer
workers by producing CloudEvents, tracks progress through status events and
the metadata store, and updates job state on any failure.  It is stateless —
all durable state lives in the metadata store, so a restarted Coordinator can
resume a job from the recorded stage (tested in tests/test_torch_batch_job.py).

Beyond the paper (which inherits these from Knative/Kubernetes restarts), the
coordinator implements the two classic MapReduce reliability mechanisms that
thousand-node deployments need, both enabled by stateless workers +
deterministic spill naming:

  * **retries** — a failed task is re-produced up to ``max_task_retries``;
    re-execution overwrites the same spill keys with identical bytes, so
    retries are idempotent;
  * **speculative execution** — when a running task exceeds
    ``straggler_factor ×`` the median completed-task duration, a duplicate is
    launched; first completion wins (per-task done flags in metadata).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

from .autoscaler import AutoscalerConfig, ServerlessPool
from .events import (EventBus, TOPIC_STATUS, status_event, trigger_event)
from .job import JobConfig
from .metadata import (MetadataStore, job_config_key, job_state_key,
                       stage_done_counter, task_status_key)
from .splitter import publish_splits, split_prefix
from .storage import ObjectStore
from .workers import PhaseTimes, run_finalizer, run_mapper, run_reducer


class JobState(str, Enum):
    PENDING = "PENDING"
    SPLITTING = "SPLITTING"
    MAPPING = "MAPPING"
    REDUCING = "REDUCING"
    FINALIZING = "FINALIZING"
    DONE = "DONE"
    FAILED = "FAILED"


@dataclass
class TaskResult:
    role: str
    worker_id: int
    attempt: int
    times: PhaseTimes
    speculative: bool = False


@dataclass
class JobReport:
    job_id: str
    state: JobState
    task_results: list[TaskResult] = field(default_factory=list)
    wall_time: float = 0.0
    retries: int = 0
    speculative_launches: int = 0
    error: str | None = None

    def component_times(self) -> dict[str, float]:
        """Average total seconds per component — the paper's Fig. 7 quantity."""
        by_role: dict[str, list[float]] = {}
        for t in self.task_results:
            by_role.setdefault(t.role, []).append(t.times.total)
        return {r: sum(v) / len(v) for r, v in by_role.items()}

    def phase_times(self) -> dict[str, dict[str, float]]:
        """Per-component per-phase averages — the paper's Fig. 8 quantity."""
        by_role: dict[str, list[PhaseTimes]] = {}
        for t in self.task_results:
            by_role.setdefault(t.role, []).append(t.times)
        out = {}
        for r, ts in by_role.items():
            n = len(ts)
            out[r] = {
                "processing": sum(t.processing for t in ts) / n,
                "uploading": sum(t.uploading for t in ts) / n,
                "downloading": sum(t.downloading for t in ts) / n,
            }
        return out


class Coordinator:
    """Drives MapReduce jobs to completion over the event bus + worker pools."""

    def __init__(self, store: ObjectStore, meta: MetadataStore,
                 bus: EventBus | None = None,
                 autoscaler: AutoscalerConfig | None = None,
                 max_task_retries: int = 2,
                 straggler_factor: float = 3.0,
                 straggler_min_seconds: float = 0.5,
                 speculative_execution: bool = True,
                 fault_injector: Callable[[str, int, int], None] | None = None,
                 max_workers: int = 16) -> None:
        self.store = store
        self.meta = meta
        self.bus = bus or EventBus()
        self.max_task_retries = max_task_retries
        self.straggler_factor = straggler_factor
        self.straggler_min_seconds = straggler_min_seconds
        self.speculative_execution = speculative_execution
        self.fault_injector = fault_injector
        ac = autoscaler or AutoscalerConfig(max_scale=max_workers)
        # one scale-to-zero pool per component role, like one Knative
        # Service/JobSink per component in the paper
        self.pools = {role: ServerlessPool(role, ac)
                      for role in ("splitter", "mapper", "reducer", "finalizer")}
        self._executor = ThreadPoolExecutor(max_workers=max_workers * 2)
        self._lock = threading.Lock()

    # -- state handling -------------------------------------------------------
    def _set_state(self, job_id: str, state: JobState) -> None:
        self.meta.set(job_state_key(job_id), state.value)
        if self.meta.persist_path:
            self.meta.snapshot()

    def job_state(self, job_id: str) -> JobState:
        raw = self.meta.get(job_state_key(job_id), JobState.PENDING.value)
        return JobState(raw)

    # -- task execution ----------------------------------------------------------
    def _run_task(self, cfg: JobConfig, role: str, worker_id: int,
                  attempt: int) -> PhaseTimes:
        """Execute one worker inside its scale-to-zero pool.  The event-bus
        round trip (trigger out, status back) happens even though execution is
        in-process, so event accounting matches the paper's architecture."""
        self.bus.produce(f"repro.{role}",
                         trigger_event(role, cfg.job_id, worker_id,
                                       {"attempt": attempt}),
                         key=f"{cfg.job_id}/{worker_id}")
        if self.fault_injector is not None:
            self.fault_injector(role, worker_id, attempt)
        if role == "mapper":
            times = self.pools[role].submit(run_mapper, cfg, worker_id,
                                            self.store, self.meta)
        elif role == "reducer":
            times = self.pools[role].submit(run_reducer, cfg, worker_id,
                                            self.store, self.meta)
        elif role == "finalizer":
            times = self.pools[role].submit(run_finalizer, cfg, self.store,
                                            self.meta)
        else:
            raise ValueError(role)
        self.bus.produce(TOPIC_STATUS,
                         status_event(role, cfg.job_id, worker_id, "done",
                                      times.as_dict()),
                         key=f"{cfg.job_id}/{worker_id}")
        return times

    def _run_stage(self, cfg: JobConfig, role: str, n_workers: int,
                   report: JobReport) -> None:
        """Run one stage's tasks in parallel with retries + speculation."""
        done_flags: dict[int, bool] = {}
        durations: list[float] = []
        inflight: dict[Future, tuple[int, int, float, bool]] = {}

        def launch(worker_id: int, attempt: int, speculative: bool) -> None:
            fut = self._executor.submit(self._run_task, cfg, role, worker_id,
                                        attempt)
            inflight[fut] = (worker_id, attempt, time.perf_counter(), speculative)

        for w in range(n_workers):
            done_flags[w] = False
            launch(w, 0, False)

        while inflight:
            done, _pending = wait(list(inflight), timeout=0.05,
                                  return_when=FIRST_COMPLETED)
            for fut in done:
                worker_id, attempt, t0, speculative = inflight.pop(fut)
                try:
                    times = fut.result()
                except Exception as exc:  # task failed → retry
                    if done_flags[worker_id]:
                        continue  # a twin already finished; ignore
                    if attempt >= self.max_task_retries:
                        for f in inflight:
                            f.cancel()
                        raise RuntimeError(
                            f"{role}-{worker_id} failed after "
                            f"{attempt + 1} attempts: {exc}") from exc
                    report.retries += 1
                    launch(worker_id, attempt + 1, False)
                    continue
                if done_flags[worker_id]:
                    continue  # speculative twin lost the race
                done_flags[worker_id] = True
                durations.append(time.perf_counter() - t0)
                self.meta.set(task_status_key(cfg.job_id, role, worker_id),
                              {"status": "done", **times.as_dict()})
                report.task_results.append(
                    TaskResult(role, worker_id, attempt, times, speculative))
            # straggler check: anything running far beyond the median?
            if self.speculative_execution and durations:
                durations.sort()
                median = durations[len(durations) // 2]
                threshold = max(self.straggler_min_seconds,
                                self.straggler_factor * median)
                now = time.perf_counter()
                running = {wid for (wid, _a, _t, _s) in inflight.values()}
                spec_counts = sum(1 for (_w, _a, _t, s) in inflight.values() if s)
                for fut, (wid, attempt, t0, spec) in list(inflight.items()):
                    if (not spec and not done_flags[wid]
                            and now - t0 > threshold
                            and list(running).count(wid) < 2
                            and spec_counts < n_workers):
                        report.speculative_launches += 1
                        launch(wid, attempt, True)
                        running.add(wid)
                        spec_counts += 1

    # -- the workflow (Fig. 2) -----------------------------------------------------
    def run_job(self, cfg: JobConfig) -> JobReport:
        cfg.validate()
        report = JobReport(cfg.job_id, JobState.PENDING)
        t_start = time.perf_counter()
        self.meta.set(job_config_key(cfg.job_id), cfg.to_json())
        try:
            resume_from = self.job_state(cfg.job_id)

            # -- SPLITTING ----------------------------------------------------
            if resume_from in (JobState.PENDING, JobState.SPLITTING):
                self._set_state(cfg.job_id, JobState.SPLITTING)
                t0 = time.perf_counter()
                assignments = self.pools["splitter"].submit(
                    split_prefix, self.store, cfg.input_prefix, cfg.n_mappers,
                    cfg.binary_input, cfg.record_separator)
                publish_splits(self.meta, cfg.job_id, assignments)
                pt = PhaseTimes(processing=time.perf_counter() - t0)
                report.task_results.append(TaskResult("splitter", 0, 0, pt))

            # -- MAPPING -------------------------------------------------------
            if self.job_state(cfg.job_id) in (JobState.SPLITTING, JobState.MAPPING):
                self._set_state(cfg.job_id, JobState.MAPPING)
                self._run_stage(cfg, "mapper", cfg.n_mappers, report)

            # -- REDUCING ------------------------------------------------------
            if cfg.n_reducers > 0 and self.job_state(cfg.job_id) in (
                    JobState.MAPPING, JobState.REDUCING):
                self._set_state(cfg.job_id, JobState.REDUCING)
                self._run_stage(cfg, "reducer", cfg.n_reducers, report)

            # -- FINALIZING -----------------------------------------------------
            if cfg.run_finalizer and cfg.n_reducers > 0 and self.job_state(
                    cfg.job_id) in (JobState.REDUCING, JobState.FINALIZING):
                self._set_state(cfg.job_id, JobState.FINALIZING)
                self._run_stage(cfg, "finalizer", 1, report)

            self._set_state(cfg.job_id, JobState.DONE)
            report.state = JobState.DONE
        except Exception as exc:
            self._set_state(cfg.job_id, JobState.FAILED)
            report.state = JobState.FAILED
            report.error = str(exc)
        report.wall_time = time.perf_counter() - t_start
        return report

    def resume_job(self, job_id: str) -> JobReport:
        """Coordinator restart: rebuild the config from metadata and continue
        from the recorded stage — possible because workers are stateless and
        all progress lives in the metadata store."""
        raw = self.meta.get(job_config_key(job_id))
        if raw is None:
            raise KeyError(f"unknown job {job_id}")
        cfg = JobConfig.from_json(raw)
        state = self.job_state(job_id)
        if state == JobState.DONE:
            return JobReport(job_id, JobState.DONE)
        if state in (JobState.FAILED, JobState.MAPPING, JobState.SPLITTING,
                     JobState.PENDING):
            # restart the interrupted stage from the top (idempotent tasks)
            self._set_state(job_id, JobState.SPLITTING)
        return self.run_job(cfg)

    def stage_progress(self, job_id: str, role: str) -> int:
        return int(self.meta.get(stage_done_counter(job_id, role), 0))
