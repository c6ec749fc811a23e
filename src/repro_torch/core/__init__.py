"""Core — the paper's serverless MapReduce system.

Host plane (paper-faithful components, copied from the reference package,
which has no JAX in these modules):
  storage (S3), metadata (Redis), events (Kafka/CloudEvents),
  autoscaler (Knative KPA), splitter, workers (Mapper/Reducer/Finalizer),
  coordinator (job state machine), job (JSON config), client (Fig. 4
  package), rpc (the job service's socket transport).

Device plane: ``mapreduce`` holds the word-count UDF for the port's array
pipeline and the reference's device-engine streaming helpers
(``DeviceJobConfig``, incremental steps, window-slot carries).
"""

from .autoscaler import (AutoscalerConfig, ComputeMeter, MeteredPool,
                         ServerlessPool)
from .client import Job, JobServiceClient, MapReduce
from .coordinator import Coordinator, JobReport, JobState
from .events import CloudEvent, EventBus
from .job import JobConfig, make_wordcount_job
from .mapreduce import (DeviceJobConfig, clear_window_slot, init_window_carry,
                        make_incremental_step, read_window_slot,
                        segment_reduce)
from .metadata import MetadataStore
from .rpc import FrameClient, FrameServer, RPCError
from .splitter import ByteRange, split_object, split_prefix
from .storage import (FileStore, MemoryStore, NamespacedStore, ObjectStore,
                      QuotaExceeded)
from .workers import read_final_output, run_mapper, run_reducer

__all__ = [
    "AutoscalerConfig", "ComputeMeter", "MeteredPool", "ServerlessPool",
    "Job", "MapReduce", "Coordinator",
    "JobReport", "JobState", "CloudEvent", "EventBus", "JobConfig",
    "make_wordcount_job", "DeviceJobConfig", "segment_reduce",
    "make_incremental_step", "init_window_carry", "read_window_slot",
    "clear_window_slot", "FrameClient", "FrameServer", "RPCError",
    "MetadataStore", "ByteRange", "split_object", "split_prefix", "FileStore",
    "MemoryStore", "NamespacedStore", "ObjectStore", "QuotaExceeded",
    "JobServiceClient", "read_final_output", "run_mapper", "run_reducer",
]
