"""Tenants — namespaced, quota-bounded slices of one shared bucket.

Multi-tenancy in the paper's deployment is S3 prefix conventions plus
IAM policy: every team writes under its own prefix and a bucket quota
bounds its footprint.  Here a :class:`Tenant` is exactly that, made
mechanical: ``store_view`` wraps the shared :class:`~repro_torch.core.storage.
ObjectStore` in a :class:`~repro_torch.core.storage.NamespacedStore`, so every
key a tenant's jobs write — sink windows, carry checkpoints, spills —
lands under ``tenants/<name>/`` and counts against the tenant's byte
quota.  Two tenants running the *same* program (same job id, same sink
prefix) therefore never collide in the store, and a runaway job fails
with :class:`~repro_torch.core.storage.QuotaExceeded` instead of filling the
bucket.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.storage import NamespacedStore, ObjectStore

__all__ = ["ComputeQuotaExceeded", "Tenant"]


class ComputeQuotaExceeded(RuntimeError):
    """A tenant's jobs have spent more pool-time than the tenant's
    ``quota_pool_seconds`` allows — the compute-side twin of storage's
    :class:`~repro_torch.core.storage.QuotaExceeded`.  Raised by the job
    server's drive loop (metered per job via ``ComputeMeter``), failing
    only the offending tenant's job, never its neighbors."""


@dataclass(frozen=True)
class Tenant:
    """One tenant: a namespace under the shared bucket, an optional byte
    quota for everything its jobs persist there, and an optional
    pool-time quota (seconds of shared-pool compute across all the
    tenant's jobs — the paper bills invocations, so compute is metered
    like storage)."""

    name: str
    quota_bytes: int | None = None
    quota_pool_seconds: float | None = None

    def __post_init__(self) -> None:
        if not self.name or "/" in self.name:
            raise ValueError(f"tenant name must be non-empty and "
                             f"slash-free, got {self.name!r}")
        if self.quota_pool_seconds is not None and self.quota_pool_seconds < 0:
            raise ValueError("quota_pool_seconds must be >= 0")

    @property
    def namespace(self) -> str:
        return f"tenants/{self.name}"

    def store_view(self, shared: ObjectStore) -> NamespacedStore:
        """This tenant's view of the shared bucket — every job of the
        tenant runs its coordinator against this, so checkpoints and sink
        windows are isolated and quota-accounted without the engine
        knowing tenancy exists."""
        return NamespacedStore(shared, self.namespace, self.quota_bytes)

    def qualify(self, prefix: str) -> str:
        """A store-absolute key prefix for this tenant's ``prefix`` — what
        the cross-job collision check compares, since collisions only
        matter in the shared bucket's one key space."""
        return f"{self.namespace}/{prefix.lstrip('/')}"
