"""Workflow metadata store — the Redis stand-in.

The paper keeps all workflow state in Redis: split byte-range metadata from the
Splitter, per-task progress updates from Mappers/Reducers, and overall job state
that the Python client polls (§III-D).  Workers are stateless precisely because
this store is not.

API kept deliberately Redis-shaped (GET/SET/HSET/HGETALL/INCR/expiry/watch) so
the coordinator and client code reads like the system in the paper.  A JSON
snapshot/restore path makes coordinator restart (fault tolerance) testable.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable


class MetadataStore:
    """In-memory, thread-safe, Redis-like KV store with hashes and counters."""

    def __init__(self, persist_path: str | None = None) -> None:
        self._kv: dict[str, Any] = {}
        self._hashes: dict[str, dict[str, Any]] = {}
        self._expiry: dict[str, float] = {}
        self._lock = threading.RLock()
        self._watchers: list[Callable[[str, Any], None]] = []
        self.persist_path = persist_path
        if persist_path and os.path.isfile(persist_path):
            self.restore(persist_path)

    # -- plain KV ----------------------------------------------------------
    def set(self, key: str, value: Any, ttl: float | None = None) -> None:
        with self._lock:
            self._kv[key] = value
            if ttl is not None:
                self._expiry[key] = time.time() + ttl
            else:
                self._expiry.pop(key, None)
        for w in list(self._watchers):
            w(key, value)

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            if key in self._expiry and time.time() > self._expiry[key]:
                self._kv.pop(key, None)
                self._expiry.pop(key, None)
            return self._kv.get(key, default)

    def delete(self, key: str) -> None:
        with self._lock:
            self._kv.pop(key, None)
            self._hashes.pop(key, None)
            self._expiry.pop(key, None)

    def keys(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._kv if k.startswith(prefix))

    def incr(self, key: str, amount: int = 1) -> int:
        """Atomic counter — used for completed-task counts the Coordinator
        checks to decide a stage is done."""
        with self._lock:
            val = int(self._kv.get(key, 0)) + amount
            self._kv[key] = val
            return val

    # -- hashes (Redis HSET/HGETALL) ----------------------------------------
    def hset(self, key: str, field: str, value: Any) -> None:
        with self._lock:
            self._hashes.setdefault(key, {})[field] = value

    def hget(self, key: str, field: str, default: Any = None) -> Any:
        with self._lock:
            return self._hashes.get(key, {}).get(field, default)

    def hgetall(self, key: str) -> dict[str, Any]:
        with self._lock:
            return dict(self._hashes.get(key, {}))

    def hdel(self, key: str, field: str) -> None:
        with self._lock:
            self._hashes.get(key, {}).pop(field, None)

    # -- pub-sub-ish watch ---------------------------------------------------
    def watch(self, fn: Callable[[str, Any], None]) -> None:
        self._watchers.append(fn)

    # -- persistence (coordinator restart) -----------------------------------
    def snapshot(self, path: str | None = None) -> None:
        path = path or self.persist_path
        if path is None:
            raise ValueError("no persist path configured")
        with self._lock:
            blob = json.dumps({"kv": self._kv, "hashes": self._hashes},
                              default=str)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            f.write(blob)
        os.replace(tmp, path)

    def restore(self, path: str | None = None) -> None:
        path = path or self.persist_path
        if path is None or not os.path.isfile(path):
            return
        with open(path) as f:
            blob = json.load(f)
        with self._lock:
            self._kv = blob.get("kv", {})
            self._hashes = blob.get("hashes", {})


# -- key helpers: the schema the paper's components share --------------------

def job_state_key(job_id: str) -> str:
    return f"job:{job_id}:state"


def job_config_key(job_id: str) -> str:
    return f"job:{job_id}:config"


def split_key(job_id: str, mapper_id: int) -> str:
    """Byte-range metadata the Splitter writes for each Mapper (§III-A.2)."""
    return f"job:{job_id}:split:{mapper_id}"


def task_status_key(job_id: str, role: str, worker_id: int) -> str:
    return f"job:{job_id}:{role}:{worker_id}:status"


def stage_done_counter(job_id: str, role: str) -> str:
    return f"job:{job_id}:{role}:done"


# -- job-service schema: the control plane's per-job records -----------------

def job_record_key(job_id: str) -> str:
    """Hash holding one submitted job's control-plane record (tenant,
    state, sink prefixes, cursor, park/restore counters)."""
    return f"jobsvc:job:{job_id}"


def job_index_key() -> str:
    """KV key whose value is the sorted list of all submitted job ids —
    what ``status()`` and the registry's collision scan iterate."""
    return "jobsvc:jobs"
