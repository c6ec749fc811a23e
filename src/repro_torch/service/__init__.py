"""Multi-tenant job service — the control plane over the streaming engine.

The paper's framework is one job per deployment: a client submits a JSON
config, the coordinator spins workers up from zero, and everything is
torn down at the end.  This package is the *service* form of the same
five components — many ``BuiltPipeline`` programs from many tenants
registered against one engine pool:

* :mod:`tenancy` — tenants as namespaced, quota-bounded views of one
  shared object store (per-team S3 prefixes + IAM, in miniature), with
  byte quotas on storage and pool-second quotas on compute;
* :mod:`ingest_share` — ONE physical read per source: a ``SharedIngest``
  materializes the event log onto a bus topic (optionally N-partitioned
  by record key) and every subscribing job replays it from a private
  record cursor (late registrants catch up from offset 0; parallel
  subscribers may drain disjoint partition subsets);
* :mod:`registry` — metadata-backed job records (the Redis schema) plus
  the cross-job sink-prefix collision check;
* :mod:`server` — the ``JobServer`` control plane: submit / pause /
  resume / cancel / status verbs, a shared ``ServerlessPool`` metered
  per job, an overlapped multi-tenant drive loop (byte-identical to the
  serial round-robin), and the ``ParkPolicy``-driven lifecycle that
  parks an idle job (barrier checkpoint → drop its coordinator → scale
  the pool to zero) and cold-restores it on the next matching event,
  exactly-once across the round trip.

``repro_torch.core.client.JobServiceClient`` is the user-facing package over
this control plane — polling the same metadata records the paper's
Python client polls in Redis, or dialing the socket transport
(``launch.serve.JobSocketServer``) across a process boundary.
"""

from .ingest_share import SharedIngest, SubscriberSource
from .registry import JobRegistry
from .server import JobServer, JobStatus, ParkPolicy
from .tenancy import ComputeQuotaExceeded, Tenant

__all__ = ["ComputeQuotaExceeded", "JobServer", "JobStatus", "JobRegistry",
           "ParkPolicy", "SharedIngest", "SubscriberSource", "Tenant"]
