"""Host plane: object store (S3), metadata (Redis), event bus (Kafka /
CloudEvents) and the serverless worker pool (Knative KPA) — copied from
the reference package, which has no JAX in these modules."""

from .autoscaler import (AutoscalerConfig, ComputeMeter, MeteredPool,
                         ServerlessPool)
from .events import CloudEvent, EventBus
from .metadata import MetadataStore
from .storage import (FileStore, MemoryStore, NamespacedStore, ObjectStore,
                      QuotaExceeded)

__all__ = [
    "AutoscalerConfig", "ComputeMeter", "MeteredPool", "ServerlessPool",
    "CloudEvent", "EventBus", "MetadataStore", "FileStore", "MemoryStore",
    "NamespacedStore", "ObjectStore", "QuotaExceeded",
]
