"""Object storage layer — the S3 stand-in.

The paper stores input files, Mapper spill files, Reducer outputs and the final
object in an S3 bucket.  This module keeps the S3 *semantics* that shaped the
paper's design so the rest of the framework is written against a realistic API:

  * flat key space with prefix listing (``list_objects(prefix=...)``),
  * whole-object GET plus **ranged GET** (the Splitter hands Mappers byte
    ranges; Mappers fetch ``bytes=lo-hi``),
  * **multipart upload** with a configurable part size (the paper sets 5 MB),
  * **no append / no in-place update** — the Finalizer must stream-concatenate
    reducer outputs into a new object, exactly as §III-A.5 notes.

Two backends: a process-local in-memory store (tests, benchmarks) and a
filesystem-backed store (persistence across coordinator restarts — what S3
gives the paper's stateless workers).
"""

from __future__ import annotations

import io
import os
import threading
import time
from dataclasses import dataclass, field


class StorageError(Exception):
    pass


class NoSuchKey(StorageError):
    pass


class QuotaExceeded(StorageError):
    """A PUT would push a tenant's namespace past its byte quota."""


@dataclass
class ObjectMeta:
    key: str
    size: int
    created: float


class ObjectStore:
    """Abstract S3-like object store."""

    #: default multipart part size — the paper's experiments use 5 MB
    DEFAULT_PART_SIZE = 5 * 1024 * 1024

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str, byte_range: tuple[int, int] | None = None) -> bytes:
        """GET an object; ``byte_range=(lo, hi)`` is inclusive-exclusive."""
        raise NotImplementedError

    def head(self, key: str) -> ObjectMeta:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        raise NotImplementedError

    # -- conveniences shared by both backends ------------------------------
    def put_many(self, items: "list[tuple[str, bytes]]") -> None:
        """PUT several objects in one store round trip.

        The streaming coordinator stages every window emitted during one
        finalization sweep and writes the whole sweep through a single
        ``put_many`` call instead of one PUT per window — against a real
        object store that is one batched request (and one set of
        request-level latencies) per sweep.  The default implementation
        loops ``self.put`` so every backend — and every instrumented
        subclass that hooks ``put`` — observes the same per-object writes.
        """
        for key, data in items:
            self.put(key, data)

    def exists(self, key: str) -> bool:
        try:
            self.head(key)
            return True
        except NoSuchKey:
            return False

    def total_size(self, prefix: str = "") -> int:
        """Total bytes under a prefix — the Splitter's first step (§III-A.2)."""
        return sum(m.size for m in self.list_objects(prefix))

    def multipart_upload(self, key: str, parts: "list[bytes] | MultipartWriter",
                         part_size: int | None = None) -> None:
        """Assemble a multipart upload.  Parts except the last must be
        >= part_size (S3 enforces a 5 MB minimum)."""
        if isinstance(parts, MultipartWriter):
            parts = parts.parts
        part_size = part_size or self.DEFAULT_PART_SIZE
        for p in parts[:-1]:
            if len(p) < min(part_size, 5 * 1024 * 1024):
                raise StorageError(
                    f"multipart part smaller than part size ({len(p)} < {part_size})")
        self.put(key, b"".join(parts))

    def stream_concat(self, out_key: str, in_keys: list[str],
                      chunk_size: int = 8 * 1024 * 1024) -> int:
        """Finalizer primitive: stream several objects into one new object.

        S3 cannot append to an existing object, so the Finalizer reads each
        reducer output in chunks and writes a single combined object (§III-A.5).
        Returns total bytes written.
        """
        buf = io.BytesIO()
        for k in in_keys:
            size = self.head(k).size
            lo = 0
            while lo < size:
                hi = min(lo + chunk_size, size)
                buf.write(self.get(k, (lo, hi)))
                lo = hi
        data = buf.getvalue()
        self.put(out_key, data)
        return len(data)


class MemoryStore(ObjectStore):
    """In-memory object store (thread-safe) — unit tests and benchmarks."""

    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._meta: dict[str, ObjectMeta] = {}
        self._lock = threading.Lock()
        # instrumentation for the paper's phase breakdown (Fig. 8)
        self.bytes_uploaded = 0
        self.bytes_downloaded = 0

    def put(self, key: str, data: bytes) -> None:
        if not isinstance(data, (bytes, bytearray)):
            raise TypeError(f"object body must be bytes, got {type(data)}")
        with self._lock:
            self._objects[key] = bytes(data)
            self._meta[key] = ObjectMeta(key, len(data), time.time())
            self.bytes_uploaded += len(data)

    def get(self, key: str, byte_range: tuple[int, int] | None = None) -> bytes:
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            data = self._objects[key]
            if byte_range is not None:
                lo, hi = byte_range
                data = data[lo:hi]
            self.bytes_downloaded += len(data)
            return data

    def head(self, key: str) -> ObjectMeta:
        with self._lock:
            if key not in self._meta:
                raise NoSuchKey(key)
            return self._meta[key]

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)
            self._meta.pop(key, None)

    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        with self._lock:
            return sorted((m for k, m in self._meta.items() if k.startswith(prefix)),
                          key=lambda m: m.key)


class FileStore(ObjectStore):
    """Filesystem-backed object store — survives process restarts, used for
    checkpoints and coordinator-restart tests.  Keys map to files under a root
    directory ('bucket'); '/' in keys becomes directory structure."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self.bytes_uploaded = 0
        self.bytes_downloaded = 0

    def _path(self, key: str) -> str:
        path = os.path.normpath(os.path.join(self.root, key))
        if not path.startswith(os.path.abspath(self.root) + os.sep) and \
           path != os.path.abspath(self.root):
            path = os.path.join(self.root, key.replace("/", "_"))
        return path

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic publish, like S3's all-or-nothing PUT
        with self._lock:
            self.bytes_uploaded += len(data)

    def get(self, key: str, byte_range: tuple[int, int] | None = None) -> bytes:
        path = self._path(key)
        if not os.path.isfile(path):
            raise NoSuchKey(key)
        with open(path, "rb") as f:
            if byte_range is not None:
                lo, hi = byte_range
                f.seek(lo)
                data = f.read(hi - lo)
            else:
                data = f.read()
        with self._lock:
            self.bytes_downloaded += len(data)
        return data

    def head(self, key: str) -> ObjectMeta:
        path = self._path(key)
        if not os.path.isfile(path):
            raise NoSuchKey(key)
        st = os.stat(path)
        return ObjectMeta(key, st.st_size, st.st_mtime)

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.isfile(path):
            os.remove(path)

    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, fn)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if key.startswith(prefix):
                    st = os.stat(full)
                    out.append(ObjectMeta(key, st.st_size, st.st_mtime))
        return sorted(out, key=lambda m: m.key)


class NamespacedStore(ObjectStore):
    """A tenant's view of a shared bucket: one prefix, one byte quota.

    Every key a job writes or reads through this view is transparently
    prefixed with the tenant namespace, so two tenants running the *same*
    program (same job id, same sink) on one physical store never touch
    each other's objects — the multi-tenant isolation the paper gets from
    per-team S3 prefixes and IAM policy.  ``quota_bytes`` bounds the
    namespace's footprint: a PUT that would push the total past the quota
    raises :class:`QuotaExceeded` *before* writing (replacing an object
    frees its old bytes first, as S3 versioned-overwrite accounting does).

    Listings come back namespace-relative, so callers — the coordinator's
    resume scan, ``collect_outputs`` — see exactly the key space they
    wrote.
    """

    def __init__(self, inner: ObjectStore, namespace: str,
                 quota_bytes: int | None = None) -> None:
        if not namespace.strip("/"):
            raise StorageError("namespace must be non-empty")
        self.inner = inner
        self.namespace = namespace.strip("/") + "/"
        self.quota_bytes = quota_bytes

    def _k(self, key: str) -> str:
        return self.namespace + key.lstrip("/")

    def used_bytes(self) -> int:
        return self.inner.total_size(self.namespace)

    def put(self, key: str, data: bytes) -> None:
        if self.quota_bytes is not None:
            used = self.used_bytes()
            try:
                used -= self.inner.head(self._k(key)).size
            except NoSuchKey:
                pass
            if used + len(data) > self.quota_bytes:
                raise QuotaExceeded(
                    f"namespace {self.namespace!r}: PUT of {len(data)} B "
                    f"over {used} B used exceeds quota {self.quota_bytes} B")
        self.inner.put(self._k(key), data)

    def get(self, key: str, byte_range: tuple[int, int] | None = None) -> bytes:
        return self.inner.get(self._k(key), byte_range)

    def head(self, key: str) -> ObjectMeta:
        m = self.inner.head(self._k(key))
        return ObjectMeta(key, m.size, m.created)

    def delete(self, key: str) -> None:
        self.inner.delete(self._k(key))

    def list_objects(self, prefix: str = "") -> list[ObjectMeta]:
        ns = len(self.namespace)
        return [ObjectMeta(m.key[ns:], m.size, m.created)
                for m in self.inner.list_objects(self._k(prefix))]


@dataclass
class MultipartWriter:
    """Buffers writes and cuts multipart parts at ``part_size`` boundaries —
    how the Mapper streams spill files out without holding them whole."""

    part_size: int = ObjectStore.DEFAULT_PART_SIZE
    parts: list[bytes] = field(default_factory=list)
    _buf: bytearray = field(default_factory=bytearray)

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= self.part_size:
            self.parts.append(bytes(self._buf[: self.part_size]))
            del self._buf[: self.part_size]

    def finish(self) -> list[bytes]:
        if self._buf:
            self.parts.append(bytes(self._buf))
            self._buf = bytearray()
        return self.parts


def spill_key(job_id: str, reducer_id: int, file_index: int, mapper_id: int) -> str:
    """Spill-file naming from §III-A.4: ``spill-reducer_id-file_index-mapper_id``.
    Reducers list by prefix ``spill-{their id}-`` to find their inputs."""
    return f"jobs/{job_id}/intermediate/spill-{reducer_id}-{file_index}-{mapper_id}"


def parse_spill_key(key: str) -> tuple[int, int, int]:
    """Inverse of :func:`spill_key` → (reducer_id, file_index, mapper_id)."""
    name = key.rsplit("/", 1)[-1]
    if not name.startswith("spill-"):
        raise ValueError(f"not a spill key: {key}")
    r, f, m = name[len("spill-"):].split("-")
    return int(r), int(f), int(m)
