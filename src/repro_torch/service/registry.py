"""Job registry — the control plane's metadata records.

The paper keeps all workflow state in Redis so that workers (and the
coordinator itself) stay stateless; the job server does the same with
one hash per job (``job_record_key``) plus an index of all job ids
(``job_index_key``).  A monitoring process holding only the
``MetadataStore`` — the :class:`~repro_torch.core.client.JobServiceClient` —
reads exactly what the server wrote; nothing about a job's lifecycle
lives solely in server memory, which is what makes crash re-attach
(``resume=True``) possible.

Registration is also where the *cross-job* sink-prefix collision check
runs (the build-time check only sees one program): every job's
tenant-qualified output prefixes are claimed in the record, and a new
job whose prefixes overlap any claim on the same shared store is
rejected with ``PipelineError`` before it can write a byte.

Under ``"shard_map"`` every rank runs a job server over the same store,
tenants and submissions, each with its own ``MetadataStore``.  A second
rank registering the job again would be refused as a duplicate, so the
registry has one writer: rank 0 applies ``register``, ``update`` and
``bump``, and every other rank installs rank 0's resulting record (its
error, if the write was refused) from one ``agree`` — so each rank holds
one record a job, equal to rank 0's, and ``resume=True`` re-attaches on
every rank.
"""

from __future__ import annotations

import time
from typing import Any

from ..core.metadata import MetadataStore, job_index_key, job_record_key
from ..pipeline.lower import assert_no_prefix_collision

__all__ = ["JobRegistry"]


class JobRegistry:
    """Metadata-backed job records + the cross-job prefix claim table."""

    def __init__(self, meta: MetadataStore) -> None:
        self.meta = meta
        self.axis = None        # the shard_map ranks' worker axis, or None

    def _written(self, job_id: str, write):
        """Apply ``write()`` (it returns a value or raises) — on rank 0
        alone under ``"shard_map"``, whose record, job index, result or
        error every rank then takes, after that one exchange."""
        if self.axis is None:
            return write()
        out = err = rec = ids = None
        if self.axis.rank == 0:
            try:
                out = write()
            except Exception as exc:   # the refusal, raised on every rank
                err = exc
            rec, ids = self.meta.hgetall(job_record_key(job_id)), self.jobs()
        rec, ids, out, err = self.axis.agree((rec, ids, out, err))
        if err is not None:
            raise err
        if self.axis.rank != 0:
            self.meta.set(job_index_key(), ids)
            for name, value in rec.items():
                self.meta.hset(job_record_key(job_id), name, value)
        return out

    def jobs(self) -> list[str]:
        return list(self.meta.get(job_index_key(), []))

    def record(self, job_id: str) -> dict[str, Any]:
        rec = self.meta.hgetall(job_record_key(job_id))
        if not rec:
            raise KeyError(f"unknown job: {job_id}")
        return rec

    def claimed_prefixes(self) -> dict[str, str]:
        """Normalized store-absolute prefix → owning job id, across every
        registered job.  Cancelled and done jobs keep their claims —
        their objects persist in the store, so a new job nesting under
        them would still scoop up foreign windows."""
        claimed: dict[str, str] = {}
        for jid in self.jobs():
            for pfx in self.meta.hget(job_record_key(jid), "prefixes", []):
                claimed[pfx] = jid
        return claimed

    def register(self, job_id: str, tenant: str,
                 prefixes: "tuple[str, ...] | list[str]", *,
                 resume: bool = False) -> bool:
        """Claim a job id and its tenant-qualified sink prefixes.

        Job ids are globally unique (they key the coordinator's shared
        metadata schema — ``job:<id>:...`` — which tenancy does not
        namespace), and prefixes must not overlap any existing claim.
        With ``resume=True`` an existing record is re-attached instead of
        rejected, provided the tenant matches — the crash-recovery path.
        Returns True if a fresh record was created, False on re-attach.
        """
        return self._written(job_id, lambda: self._register(
            job_id, tenant, prefixes, resume))

    def _register(self, job_id: str, tenant: str, prefixes,
                  resume: bool) -> bool:
        ids = self.jobs()
        normed = [p.rstrip("/") + "/" for p in prefixes]
        if job_id in ids:
            rec = self.record(job_id)
            if resume and rec.get("tenant") == tenant:
                return False
            raise ValueError(
                f"job id {job_id!r} already registered"
                + (f" to tenant {rec.get('tenant')!r}" if resume else
                   " (rebuild with a distinct job_id=, or pass "
                   "resume=True to re-attach after a crash)"))
        assert_no_prefix_collision(normed, self.claimed_prefixes())
        self.meta.set(job_index_key(), sorted(ids + [job_id]))
        key = job_record_key(job_id)
        self.meta.hset(key, "tenant", tenant)
        self.meta.hset(key, "prefixes", normed)
        self.meta.hset(key, "state", "PENDING")
        self.meta.hset(key, "submitted", time.time())
        self.meta.hset(key, "parks", 0)
        self.meta.hset(key, "restores", 0)
        self.meta.hset(key, "cold_start_seconds", 0.0)
        return True

    def update(self, job_id: str, **fields: Any) -> None:
        key = job_record_key(job_id)

        def write():
            for name, value in fields.items():
                self.meta.hset(key, name, value)
        self._written(job_id, write)

    def bump(self, job_id: str, field: str, amount: float = 1) -> None:
        key = job_record_key(job_id)
        self._written(job_id, lambda: self.meta.hset(
            key, field, self.meta.hget(key, field, 0) + amount))

    def state(self, job_id: str) -> str:
        return self.record(job_id)["state"]
