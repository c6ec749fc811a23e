"""Sharded, async checkpoints through the object-storage layer, in the
reference's byte layout.

The partner of ``repro/checkpoint/checkpoint.py``.  Checkpoints reuse the
paper's spill-file discipline: each saver shard writes one immutable
object ``<prefix>/step-SSSSSSSS/shard-i-of-N`` (an ``np.savez`` archive
of ``leaf<k>`` arrays), and a JSON manifest with the shapes, dtypes,
split bounds and per-shard CRC32s is PUT last — the commit point: a crash
mid-save leaves no visible checkpoint.  Restore is elastic: the manifest,
not the shard count, defines the logical arrays.

The layout is the reference's, key for key and field for field, so a
checkpoint written by either package restores in the other:

  * leaves go in ``jax.tree`` order — a ``TrainState(params,
    OptState(m, v, count), step)``'s fields in order, dict keys sorted —
    and a list of per-layer dicts (the port's ``params["layers"]``, and
    its moments) is stored as the reference stores its layer stack: one
    leaf per parameter, stacked on a leading ``(L, ...)`` axis;
  * split leaves are cut at ``np.linspace(0, n, N + 1)`` bounds on their
    first axis; scalars and short leaves go whole to shard 0;
  * bfloat16 leaves are 2-byte ``V2`` records (what ``np.load`` makes of
    the reference's ``ml_dtypes`` arrays) with ``"bfloat16"`` in the
    manifest, and are read back bit for bit as ``torch.bfloat16`` from the
    dtype the manifest states (the card machine has no ``ml_dtypes``, and
    numpy none of its own).

``AsyncCheckpointer`` snapshots to host memory synchronously and writes
through a background thread — training never blocks on storage.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.storage import NoSuchKey, ObjectStore
from ..optim.tree import is_namedtuple


def _is_layer_list(x) -> bool:
    return isinstance(x, list) and bool(x) and all(
        isinstance(v, dict) for v in x)


def _paths(tree: dict, prefix=()) -> list[tuple]:
    """Leaf paths of a dict tree, keys sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _paths(v, prefix + (k,)) if isinstance(v, dict) \
            else [prefix + (k,)]
    return out


def _at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _flatten(tree: Any) -> list:
    """Leaves in the reference's order; a list of per-layer dicts yields
    one leaf per parameter path: the list of that path's layer tensors."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if _is_layer_list(tree):
        return [[_at(layer, p) for layer in tree] for p in _paths(tree[0])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure holding ``leaves`` (``_flatten`` order); a
    layer list takes each stacked leaf back apart, layer by layer."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            filled = {k: build(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if _is_layer_list(t):
            stacked = {p: next(it) for p in _paths(t[0])}
            out = []
            for i in range(len(t)):
                layer: dict = {}
                for p, parts in stacked.items():
                    d = layer
                    for k in p[:-1]:
                        d = d.setdefault(k, {})
                    d[p[-1]] = parts[i]
                out.append(layer)
            return out
        if is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _structure(tree: Any) -> str:
    """A readable structure of ``tree`` (``*`` a leaf), for the manifest's
    ``treedef_repr`` — informative only: both packages check a
    checkpoint by its leaf count and shapes."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_layer_list(tree):
        return f"[{len(tree)} layers stacked] {_structure(tree[0])}"
    if is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            _structure(v) for v in tree) + ")"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of one leaf, copied to the host: a
    tensor (bfloat16 as 2-byte records), a list of same-shaped layer
    tensors stacked on a new leading axis, or anything ``np.asarray``
    takes."""
    if isinstance(leaf, list):
        name = _dtype_name(leaf[0])
        a = torch.stack([t.detach() for t in leaf])
    elif isinstance(leaf, torch.Tensor):
        name, a = _dtype_name(leaf), leaf.detach()
    else:
        a = np.asarray(leaf)
        return a, str(a.dtype)
    if name == "bfloat16":
        a = a.view(torch.int16)
    a = a.to("cpu", copy=True).numpy()
    return (a.view("V2") if name == "bfloat16" else a), name


@dataclass
class _Snapshot:
    """A tree copied to the host: its leaves (``_flatten`` order) as numpy
    arrays, their dtype names and its structure's text."""

    arrays: list
    dtypes: list
    structure: str


def snapshot(tree: Any) -> _Snapshot:
    """Copy every leaf of ``tree`` to host memory (synchronously: the
    device's work on the leaves finishes first)."""
    pairs = [_host(x) for x in _flatten(tree)]
    return _Snapshot([a for a, _ in pairs], [d for _, d in pairs],
                     _structure(tree))


def _manifest_key(prefix: str, step: int) -> str:
    return f"{prefix.rstrip('/')}/step-{step:08d}/MANIFEST.json"


def _shard_key(prefix: str, step: int, i: int, n: int) -> str:
    return f"{prefix.rstrip('/')}/step-{step:08d}/shard-{i}-of-{n}"


def save_checkpoint(store: ObjectStore, prefix: str, step: int, tree: Any,
                    n_shards: int = 4) -> dict:
    """Write ``tree`` (or a ``snapshot`` of it) as ``n_shards`` objects +
    manifest.  Leaves are split on their first axis (padded shards at the
    tail); scalars go to shard 0."""
    snap = tree if isinstance(tree, _Snapshot) else snapshot(tree)
    meta = []
    shard_bufs: list[dict[str, np.ndarray]] = [dict()
                                               for _ in range(n_shards)]
    for li, (a, dtype) in enumerate(zip(snap.arrays, snap.dtypes)):
        if a.ndim == 0 or a.shape[0] < n_shards:
            shard_bufs[0][f"leaf{li}"] = a
            meta.append({"shape": list(a.shape), "dtype": dtype,
                         "split": False})
        else:
            bounds = np.linspace(0, a.shape[0], n_shards + 1).astype(int)
            for si in range(n_shards):
                shard_bufs[si][f"leaf{li}"] = a[bounds[si]:bounds[si + 1]]
            meta.append({"shape": list(a.shape), "dtype": dtype,
                         "split": True,
                         "bounds": [int(b) for b in bounds]})
    crcs = []
    for si, buf in enumerate(shard_bufs):
        bio = io.BytesIO()
        np.savez(bio, **buf)
        blob = bio.getvalue()
        crcs.append(zlib.crc32(blob))
        store.put(_shard_key(prefix, step, si, n_shards), blob)
    manifest = {
        "step": step,
        "n_shards": n_shards,
        "leaves": meta,
        "crc32": crcs,
        "treedef_repr": snap.structure,
    }
    # the manifest PUT commits the checkpoint
    store.put(_manifest_key(prefix, step), json.dumps(manifest).encode())
    return manifest


def latest_step(store: ObjectStore, prefix: str) -> int | None:
    """The newest committed step under ``prefix`` (a manifest exists), or
    None."""
    steps = []
    for m in store.list_objects(prefix.rstrip("/") + "/"):
        if m.key.endswith("MANIFEST.json"):
            part = m.key.rsplit("/", 2)[-2]          # step-XXXXXXXX
            steps.append(int(part.split("-")[1]))
    return max(steps) if steps else None


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A host array as the manifest's dtype on ``device``; 2-byte
    bfloat16 records reinterpreted bit for bit."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _target_shape(want) -> tuple | None:
    if isinstance(want, list):
        return (len(want),) + tuple(want[0].shape)
    return tuple(want.shape) if hasattr(want, "shape") else None


def restore_checkpoint(store: ObjectStore, prefix: str, target: Any,
                       step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``target`` (its leaves define the
    layout and devices; shapes are validated against the manifest).
    Returns (tree, step): tensors of the manifest's dtypes, on each target
    leaf's device (the CPU for a leaf that is not a tensor), a stacked
    layer leaf split back into its layers.  Elastic: works regardless of
    the shard count it was written with."""
    if step is None:
        step = latest_step(store, prefix)
        if step is None:
            raise NoSuchKey(f"no checkpoint under {prefix}")
    manifest = json.loads(store.get(_manifest_key(prefix, step)))
    n = manifest["n_shards"]
    bufs = []
    for si in range(n):
        blob = store.get(_shard_key(prefix, step, si, n))
        if zlib.crc32(blob) != manifest["crc32"][si]:
            raise IOError(f"checkpoint shard {si} failed CRC validation")
        bufs.append(np.load(io.BytesIO(blob)))
    leaves_meta = manifest["leaves"]
    flat_target = _flatten(target)
    if len(flat_target) != len(leaves_meta):
        raise ValueError(
            f"checkpoint has {len(leaves_meta)} leaves, target expects "
            f"{len(flat_target)}")
    out = []
    for li, (meta, want) in enumerate(zip(leaves_meta, flat_target)):
        key = f"leaf{li}"
        if meta["split"]:
            a = np.concatenate([bufs[si][key] for si in range(n)], axis=0)
        else:
            a = bufs[0][key]
        want_shape = _target_shape(want)
        if want_shape is not None and want_shape != a.shape:
            raise ValueError(f"leaf {li}: checkpoint shape {a.shape} != "
                             f"target {want_shape}")
        first = want[0] if isinstance(want, list) else want
        device = first.device if isinstance(first, torch.Tensor) else "cpu"
        t = _tensor(a, meta["dtype"], device)
        out.append(list(t.unbind(0)) if isinstance(want, list) else t)
    return _unflatten(target, out), step


class AsyncCheckpointer:
    """Background writer: ``save()`` snapshots to host and returns; a
    worker thread performs the object-store writes and keeps the newest
    ``keep`` steps.  ``wait()`` drains the queue and raises the first
    write error; ``close()`` stops the thread (which holds the store
    until then).  ``timings`` records each save: its step, the bytes,
    the snapshot's seconds (on the caller's thread) and the write's (on
    the writer's)."""

    def __init__(self, store: ObjectStore, prefix: str, n_shards: int = 4,
                 keep: int = 3) -> None:
        self.store = store
        self.prefix = prefix
        self.n_shards = n_shards
        self.keep = keep
        self._q: queue.Queue = queue.Queue()
        self._errors: list[Exception] = []
        self.timings: list[dict] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, snap, record = item
            try:
                t0 = time.perf_counter()
                save_checkpoint(self.store, self.prefix, step, snap,
                                self.n_shards)
                record["write_s"] = time.perf_counter() - t0
                self._gc()
            except Exception as exc:  # surfaced on wait()
                self._errors.append(exc)
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted({int(m.key.rsplit("/", 2)[-2].split("-")[1])
                        for m in self.store.list_objects(
                            self.prefix.rstrip("/") + "/")
                        if "step-" in m.key})
        for s in steps[:-self.keep] if len(steps) > self.keep else []:
            for m in self.store.list_objects(
                    f"{self.prefix.rstrip('/')}/step-{s:08d}/"):
                self.store.delete(m.key)

    def save(self, step: int, tree: Any) -> None:
        """Snapshot ``tree`` to host memory now; write it in the
        background."""
        t0 = time.perf_counter()
        snap = snapshot(tree)
        record = {"step": step, "snapshot_s": time.perf_counter() - t0,
                  "bytes": sum(a.nbytes for a in snap.arrays)}
        self.timings.append(record)
        self._q.put((step, snap, record))

    def wait(self) -> None:
        """Block until every queued save is written."""
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        """Drain the queue and stop the writer thread."""
        self._q.put(None)
        self._q.join()


__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint",
           "save_checkpoint", "snapshot"]
