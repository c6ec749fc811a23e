"""Rank programs for ``test_torch_shard_map.py``: worlds of 2-4 gloo ranks
on the CPU, one process a worker.

``spawn(body, world, root, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (the ``spawn`` method), joins them into one gloo
group through a ``FileStore`` under ``root`` (no TCP port), runs
``body(rank, world, root, *args)`` in each and waits at most ``timeout``
seconds, killing every rank past it.  The bodies import ``repro_torch``
only, build their programs with ``backend="shard_map"`` and
``device="cpu"``, and leave what they saw as ``root/out<rank>.pkl``; the
object store they share is a ``FileStore`` under ``root/store``, which
only rank 0 writes.
"""

import faulthandler
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the single-stage program of the reference's
#: ``test_pipeline_streaming_shard_map_matches_vmap``
SINGLE_EVENTS = [(float(t), f"k{t % 5}", float(t % 7)) for t in range(400)]
#: the two-stage chain of ``test_multistage_shard_map_matches_vmap``
CHAIN_EVENTS = [(float(t), f"k{t % 5}", float(t % 7)) for t in range(600)]
#: the tee of ``test_tee_shard_map_matches_vmap``
TEE_EVENTS = [(float(t), f"k{t % 7}", float(t % 5)) for t in range(800)]


def _entry(rank, body, world, root, args):
    faulthandler.enable()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=world)
    try:
        body(rank, world, root, *args)
    finally:
        dist.destroy_process_group()


def spawn(body, world, root, *args, timeout=100.0):
    """Run ``body`` on ``world`` gloo ranks; raise if a rank fails or the
    world outlives ``timeout`` seconds."""
    ctx = mp.start_processes(_entry, args=(body, world, str(root), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [load(root, r) for r in range(world)]


def save(root, rank, obj):
    with open(os.path.join(root, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def load(root, rank):
    with open(os.path.join(root, f"out{rank}.pkl"), "rb") as f:
        return pickle.load(f)


def _report(rep):
    return {k: getattr(rep, k) for k in (
        "records_in", "records_expanded", "late_dropped", "windows_emitted",
        "handoffs", "hash_collisions", "capacity_dropped", "batches")}


def word_shards(world, n_keys=64, n_per=512, seed=0):
    """The reference multi-device test's token shards: ``(world * n_per,
    2)`` int32 ``(token, 1)`` rows, shard ``w`` in rows ``[w * n_per, (w +
    1) * n_per)``."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, (world, n_per)).astype(np.int32)
    return np.stack([keys, np.ones_like(keys)], -1).reshape(world * n_per, 2)


def batch_body(rank, world, root):
    """The aggregate and the group word count, plus a hashed key space
    with collision tracking, each rank handed the whole data."""
    from repro_torch.core.mapreduce import wordcount_map_factory
    from repro_torch.pipeline import Pipeline
    n_keys = 64
    shard = word_shards(world, n_keys)
    out = {}
    for name, kw in (("sum", {}), ("hashed", {"key_space": "hashed"})):
        built = (Pipeline.from_source(shards=shard)
                 .map(wordcount_map_factory(1 << 20)).reduce("sum")
                 .build(num_buckets=n_keys if not kw else 16,
                        n_workers=world, backend="shard_map", device="cpu",
                        **kw))
        res, st = built.run_batch(data=shard)
        out[name] = (res.numpy(), int(st.sent), int(st.dropped),
                     None if st.bucket_collisions is None
                     else st.bucket_collisions.numpy())
    grp = (Pipeline.from_source(shards=shard).map(wordcount_map_factory(n_keys))
           .reduce("sum", mode="group", capacity=2048)
           .build(num_buckets=n_keys, n_workers=world, backend="shard_map",
                  device="cpu"))
    (gk, gv, gvalid), gst = grp.run_batch(data=shard)
    out["group"] = ((gk.numpy(), gv.numpy(), gvalid.numpy()), int(gst.sent),
                    int(gst.dropped), None)
    save(root, rank, out)


def stream_program(P, Wn, case, **build):
    """The reference's shard_map streaming programs, by name."""
    if case == "single":
        return (P.from_source(records=SINGLE_EVENTS, batch_records=100)
                .key_by().window(Wn.tumbling(50.0)).reduce("sum")
                .build(num_buckets=20, job_id="sm", **build))
    if case == "chain":
        return (P.from_source(records=CHAIN_EVENTS, batch_records=100)
                .key_by().window(Wn.tumbling(20.0)).reduce("count")
                .window(Wn.tumbling(100.0)).reduce("sum")
                .build(num_buckets=20, job_id="sm2", **build))
    if case == "group":
        return (P.from_source(records=CHAIN_EVENTS, batch_records=100)
                .key_by().window(Wn.sliding(40.0, 20.0))
                .reduce("max", mode="group", capacity=32)
                .build(num_buckets=20, job_id="smg", **build))
    base = (P.from_source(prefix="streams/ev", batch_records=100)
            .key_by().window(Wn.tumbling(20.0)).reduce("count"))
    return base.tee(
        P.branch().window(Wn.tumbling(100.0)).reduce("sum").top_k(3)
        .sink("smt-top/"),
        P.branch().map(_upper).key_by().window(Wn.tumbling(100.0))
        .reduce("sum").sink("smt-roll/"),
    ).build(num_buckets=28, job_id="smt", checkpoint_interval=3, **build)


def _upper(r):
    return (r[0], r[1].upper(), r[2])


def stream_body(rank, world, root, case):
    """One streaming program, every rank over the same source; the tee
    restarts mid-stream from its checkpoint, as the reference's case."""
    from repro_torch.core import FileStore, MetadataStore
    from repro_torch.pipeline import Pipeline, Windowing
    from repro_torch.streaming import StreamSource, write_event_log
    built = stream_program(Pipeline, Windowing, case, n_workers=world,
                           backend="shard_map", device="cpu")
    store, meta = FileStore(os.path.join(root, "store")), MetadataStore()
    reports = []
    if case == "tee":
        if rank == 0:
            write_event_log(store, "streams/ev", TEE_EVENTS)
        dist.barrier()
        reports.append(built.run(StreamSource.from_records(
            TEE_EVENTS[:400], batch_records=100), store=store, meta=meta,
            mode="streaming", flush=False))
    reports.append(built.run(store=store, meta=meta, mode="streaming"))
    save(root, rank, [_report(r) for r in reports])


class _Crash(RuntimeError):
    pass


def crash_body(rank, world, root, crash_batch, snapshot):
    """Crash every rank before micro-batch ``crash_batch`` (after a
    checkpoint), then resume from it under the same backend — or, with
    ``snapshot``, stop there and leave rank 0's metadata as
    ``root/meta.json`` for a restore under another backend.  Rank 0
    reports its store writes per key."""
    from collections import Counter
    from repro_torch.core import FileStore, MetadataStore
    from repro_torch.pipeline import Pipeline, RunOptions, Windowing
    from repro_torch.streaming import StreamingCoordinator, StreamSource

    class Counting(FileStore):
        def __init__(self, path):
            super().__init__(path)
            self.puts = Counter()

        def put(self, key, data):
            self.puts[key] += 1
            return super().put(key, data)

    class Crashing(StreamingCoordinator):
        def _process_prepared(self, prep, report):
            if prep.index >= crash_batch:
                raise _Crash(f"injected crash before batch {prep.index}")
            super()._process_prepared(prep, report)

    built = crash_program(Pipeline, Windowing, n_workers=world,
                          backend="shard_map", device="cpu")
    store, meta = Counting(os.path.join(root, "store")), MetadataStore()
    source = StreamSource.from_records(crash_events(), batch_records=100)
    dead = Crashing(store, meta, program=built, options=RunOptions())
    try:
        dead.run_stream(source, announce=False, flush=False)
    except _Crash:
        pass
    offset = meta.get("stream/crash/state")["offset"]
    if snapshot:
        if rank == 0:
            meta.snapshot(os.path.join(root, "meta.json"))
        save(root, rank, {"offset": offset})
        return
    rep = built.run(source, store=store, meta=meta, mode="streaming")
    save(root, rank, {"offset": offset, "report": _report(rep),
                      "puts": dict(store.puts)})


def crash_events():
    rng = np.random.default_rng(29)
    ts = np.sort(rng.uniform(0, 200.0, 1000))
    ts = np.clip(ts + rng.normal(0, 0.5, 1000), 0, None)
    keys = rng.integers(0, 5, 1000)
    vals = rng.integers(0, 9, 1000).astype(float)
    return [(float(t), f"k{k}", float(v)) for t, k, v in zip(ts, keys, vals)]


def crash_program(P, Wn, **build):
    return (P.from_source(records=[], batch_records=100).key_by()
            .window(Wn.sliding(20.0, 5.0)).reduce("sum").sink("crash/")
            .build(num_buckets=8, checkpoint_interval=2, job_id="crash",
                   allowed_lateness=1.0, **build))


def compressed_psum_body(rank, world, root, grads):
    """``optim.compressed_psum`` over the ranks of this rank's gradient
    tree: ``grads`` maps a leaf name to every rank's values stacked on a
    leading axis (numpy)."""
    from repro_torch.engine.compile import DistributedAxis
    from repro_torch.optim import compressed_psum
    mine = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    out = compressed_psum(mine, DistributedAxis(None))
    save(root, rank, {k: (v.dtype, v.float().numpy())
                      for k, v in out.items()})


def shardmap_train_body(rank, world, root, arch, batch, compress):
    """Two steps of ``make_shardmap_train_step`` on the reduced ``arch``
    (parameters from seed 0), every rank handed the global ``batch``;
    saves the parameters (numpy leaves) and the metrics after each."""
    from repro_torch import configs
    from repro_torch.engine.compile import DistributedAxis
    from repro_torch.optim import AdamW
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime import init_train_state
    from repro_torch.runtime.train_step import make_shardmap_train_step
    cfg = configs.get_reduced(arch)
    opt = AdamW(lr=1e-3)
    state = init_train_state(0, cfg, opt, device="cpu")
    step = make_shardmap_train_step(cfg, opt, DistributedAxis(None),
                                    compress_grads=compress)
    params, metrics = [], []
    for _ in range(2):
        state, m = step(state, batch)
        params.append([p.numpy() for p in tree_leaves(state.params)])
        metrics.append({k: float(v) for k, v in m.items()})
    save(root, rank, {"params": params, "metrics": metrics})
