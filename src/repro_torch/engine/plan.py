"""Execution plans — the declarative layer over the streaming engine.

A streaming MapReduce job on the device plane is a point in a small
product space:

    ``KeySpace``  ×  ``WindowSpec``  ×  ``ReduceSpec``  →  compiled plan

``KeySpace`` says how raw keys become bucket ids (dense pre-assigned ids,
or hashed open domains).  ``WindowSpec`` says whether records carry
event-time windows fanned out on the device (one 5-column row per record)
or already expanded by the host (one 4-column row per record × window).
``ReduceSpec`` says how values reduce: the aggregate fold, optionally
with a top-k selection at finalization, or group mode — any reducer over
each key's full value list, after a fixed-capacity grouping shuffle.

``ExecutionPlan.compile(device=...)`` lowers a windowed aggregate plan to
a ``CompiledStreamAggregate``: a flat ``(n_slots * num_buckets, 2)``
float32 carry on ``device``, folded once per micro-batch by
the fused fold (``kernels/fused_fold``: a hand-written CUDA kernel for
CUDA tensors, its plain PyTorch version for CPU tensors).  That is the
carry layout of the reference's ``backend="pallas"``, so checkpoints move
between the two packages unchanged.

Plans may share one carry: a windowed join's two sides fold into
disjoint channel pairs (``ReduceSpec.channel_base``) of one
``(n_slots * carry_buckets, 4)`` carry, and ``handoff_rows`` turns a
finalized window into a successor stage's wire rows on the device.

A batch plan (``window=None``) compiles with its map UDF to a
``CompiledBatchPlan``: ``run(shards)`` applies the UDF to each worker's
shard, as the reference's ``vmap`` does, and combines every worker's
records in one ``hash_combine`` launch (``engine.stages``) — or, in
group mode, runs the grouping shuffle over the explicit worker axis
(per-worker send buffers of ``capacity`` records a partition, the
exchange, and the reducer on each worker's merged stream).  Its result
has the shape the reference's ``backend="vmap"`` gives.

A windowed group plan compiles to a ``CompiledStreamGroup``: its carry is
the reference's ``vmap`` layout, fixed-capacity record buffers per
(worker, window slot), and the reducer runs over each key's buffered
values when a window finalizes.  Group mode has no kernel in either
package; its stages are plain tensor ops on the plan's device.

``compile(backend=...)`` picks where the workers live
(``engine.compile``).  ``"fused"``, the default, is the above: a
streaming fold has no worker axis.  ``"vmap"`` simulates ``n_workers``
workers on the device in the reference's ``vmap`` layouts: an aggregate
carry ``(W, n_slots * carry_buckets / W, C)`` and wire ``(W, per, 4|5)``,
which are the flat slab and wire reshaped (worker ``w`` owns rows ``[w *
per, (w + 1) * per)``), so the fold is still one ``fused_fold`` launch
over a contiguous view.  ``"shard_map"`` runs one ``torch.distributed``
rank a worker (``group=``, or the default group): each rank holds its
``(per, C)`` share of the flat carry, folds its shard of the flat wire
into a partial of the whole carry and reduce-scatters it; a group
stage's rank holds its ``(n_slots, capacity)`` share of ``(W * n_slots,
capacity)`` and exchanges with ``all_to_all``; a batch plan maps the
rank's shard, combines it with ``hash_combine`` and reduce-scatters.
Reads of a window gather it from every rank, so every rank sees the same
finalized windows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..kernels.fused_fold import ops as fused_fold
from . import stages
from .compile import BACKENDS, worker_axis

#: the default backend: the fused fold over a flat carry slab
BACKEND = "fused"
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1


def resolve_device(device) -> torch.device:
    """The device a plan's carry (or a model's parameters and cache)
    lives on.  ``"cuda"`` (the default of every entry point) must exist:
    on a host without CUDA this raises instead of quietly running
    somewhere else — ask for ``"cpu"`` explicitly to run the kernels'
    plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch reports no CUDA "
            f"device on this host; pass device='cpu' to run the kernels' "
            f"plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error every unported reference feature raises: what it is and
    the ``ROADMAP.md`` item that queues it."""
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP.md {item})")


# ---------------------------------------------------------------------------
# The plan vocabulary
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KeySpace:
    """How raw map keys become bucket ids in ``[0, num_buckets)``.

    ``dense`` — keys already are bucket ids (the data layer assigned them).
    ``hashed`` — keys come from an open domain and are folded in with
    ``device_hash``; distinct keys may collide.  Streaming plans count
    collisions in the coordinator's host-side label table; batch plans
    with ``track_collisions`` count them exactly per bucket on the device
    (``ShuffleStats.bucket_collisions``).
    """

    num_buckets: int
    mode: str = "dense"             # "dense" | "hashed"
    track_collisions: bool = True

    @classmethod
    def dense(cls, num_buckets: int) -> "KeySpace":
        return cls(num_buckets, "dense")

    @classmethod
    def hashed(cls, num_buckets: int,
               track_collisions: bool = True) -> "KeySpace":
        return cls(num_buckets, "hashed", track_collisions)

    @property
    def is_hashed(self) -> bool:
        return self.mode == "hashed"

    def padded(self, n_workers: int) -> int:
        """Bucket space padded to a multiple of the worker count, so the
        reference's tiled scatter divides it evenly; pad rows stay zero
        (unless a dense key lands in them)."""
        return -(-self.num_buckets // n_workers) * n_workers


@dataclass(frozen=True)
class WindowSpec:
    """Event-time windowing as the device engine sees it.

    ``kind="fixed"`` (tumbling/sliding): ``slide=None`` means tumbling
    (fan-out 1).  ``fanout_on_device=True`` ships one 5-column row per
    record and replicates it into its ``ceil(size/slide)`` windows in the
    fold kernel; ``False`` is the host fan-out wire (one 4-column row per
    record × window).  Window ``w`` lives in ring slot ``w mod n_slots``
    (floor mod) on host and device alike; wire window indices are rebased
    by the caller by a multiple of ``n_slots`` so they stay exact in
    float32.

    ``kind="session"``: data-dependent gap windows on the host wire with
    fan-out 1; the host maps each open session to a carry *cell* — a
    (ring slot, bucket) pair — and merges bridged sessions with the cell
    ops on the compiled plan.
    """

    size: float
    slide: float | None = None
    n_slots: int = 2
    fanout_on_device: bool = True
    kind: str = "fixed"             # "fixed" | "session"
    gap: float = 0.0

    @classmethod
    def session(cls, gap: float, n_slots: int = 8) -> "WindowSpec":
        """Gap-based session windows: the aggregate fold and carry are
        unchanged, only cell addressing and finalization differ."""
        return cls(size=0.0, slide=None, n_slots=n_slots,
                   fanout_on_device=False, kind="session", gap=gap)

    @property
    def is_session(self) -> bool:
        return self.kind == "session"

    @property
    def fanout(self) -> int:
        """Max windows per record — the in-kernel replication factor."""
        if self.slide is None:
            return 1
        return math.ceil(self.size / self.slide)


@dataclass(frozen=True)
class ReduceSpec:
    """How values reduce within a window × key group.

    ``aggregate`` folds ``[value, 1]`` pairs into the carry's two
    channels (count, sum and mean all come out of the carried pair);
    ``top_k`` is the same fold plus a fixed-capacity heavy-hitters
    selection at finalization (``k`` bounds it, ``reduce_fn`` names the
    ranking kind).  ``combine_fn`` is a batch plan's combiner
    (``stages.resolve_combine_fn``: ``None`` and ``"pallas"`` name the
    ``hash_combine`` kernel); the streaming fold is its own combiner.
    ``group`` — ``reduce_fn`` (a ``stages.SEGMENT_REDUCE_KINDS`` name or a
    ``(keys, values, starts) -> (gk, gv, gvalid)`` callable, see
    ``engine.stages``) over each key's full, exchanged value list;
    ``capacity`` bounds the per-partition record buffers (the spill-file
    size bound), and records past it are dropped and counted.

    ``channels`` / ``channel_base`` let several plans share one aggregate
    carry: each plan folds its ``[value, 1]`` pair into channels
    ``[channel_base, channel_base + 1]`` of a ``channels``-wide carry and
    leaves the rest untouched — the windowed join, whose left and right
    streams are two compiled plans over disjoint channel pairs of one
    carry.  ``carry_buckets`` widens the carry's bucket axis past the
    plan's own key space (0 → the key space width), so join sides with
    per-side key spaces each bucketize within their own
    ``KeySpace.num_buckets`` but flatten window slots over the shared
    width.
    """

    mode: str = "aggregate"         # "aggregate" | "group" | "top_k"
    reduce_fn: str | Callable = "sum"
    k: int = 0                      # top_k mode: selection capacity
    combine_fn: str | Callable | None = None
    capacity: int = 0               # group mode: records a buffer holds
    channels: int = 2               # carry width (2 per resident plan)
    channel_base: int = 0           # this plan's [sum, count] offset
    carry_buckets: int = 0          # shared carry bucket width (0 → own)

    @classmethod
    def top_k(cls, k: int) -> "ReduceSpec":
        return cls(mode="top_k", k=k)


@dataclass(frozen=True)
class ExecutionPlan:
    """One device MapReduce job, declaratively.  ``compile()`` lowers it.
    A batch plan has ``n_workers`` worker shards and pads its bucket space
    to a multiple of it; a group plan, batch or windowed, keeps one
    partition a worker.  A streaming aggregate plan's carry is split into
    ``n_workers`` owner slices under ``"vmap"`` and ``"shard_map"``; under
    ``"fused"`` the fold runs over the whole flat carry with no worker
    axis."""

    key_space: KeySpace
    reduce: ReduceSpec
    n_workers: int
    window: WindowSpec | None = None

    @property
    def carry_buckets(self) -> int:
        """Bucket width of the carry this plan folds into — the plan's own
        key space unless ``ReduceSpec.carry_buckets`` widens it (per-side
        key spaces over one shared join carry)."""
        return self.reduce.carry_buckets or self.key_space.num_buckets

    def compile(self, map_fn: Callable | None = None, *,
                backend: str = BACKEND, device="cuda", finalize: bool = True,
                group=None) -> ("CompiledStreamAggregate | "
                                "CompiledStreamGroup | CompiledBatchPlan"):
        """Lower the plan onto ``device``: a batch plan (``window=None``)
        with its map UDF to a ``CompiledBatchPlan``, a windowed aggregate
        (or top-k) plan to a ``CompiledStreamAggregate``, a windowed group
        plan to a ``CompiledStreamGroup``.  ``finalize`` (batch only)
        gathers the workers' results into one.  ``backend`` is one of
        ``engine.compile.BACKENDS``; ``group`` is the ``shard_map``
        backend's process group (default: the initialised default
        group, which must have ``n_workers`` ranks)."""
        rs = self.reduce
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (expected one of "
                             f"{BACKENDS})")
        if rs.mode not in ("aggregate", "group", "top_k"):
            raise ValueError(f"unknown reduce mode {rs.mode!r}")
        if rs.mode == "group" and rs.capacity <= 0:
            raise ValueError("grouping mode needs a positive capacity")
        if rs.mode == "top_k" and rs.k < 1:
            raise ValueError("top_k mode needs k >= 1")
        if rs.mode == "top_k" and rs.channel_base != 0:
            raise ValueError("top_k ranks channels [0, 2) — it cannot "
                             "share a carry at a nonzero channel_base")
        if rs.channels < 2 or rs.channel_base + 2 > rs.channels:
            raise ValueError("channel window [base, base+2) must fit the "
                             "carry's channel count")
        if rs.carry_buckets and rs.carry_buckets < self.key_space.num_buckets:
            raise ValueError("carry_buckets must cover the plan's own key "
                             "space (carry width >= num_buckets)")
        if self.window is None:
            if map_fn is None:
                raise ValueError("batch plans need a map_fn")
            if rs.mode == "top_k" and not finalize:
                raise ValueError("batch top_k selects over the finalized "
                                 "bucket vector; finalize=False is "
                                 "contradictory")
            if rs.mode == "top_k" and rs.k > self.key_space.num_buckets:
                raise ValueError("top_k k exceeds the bucket space")
            stages.resolve_combine_fn(rs.combine_fn)    # validate early
            dev = resolve_device(device)
            return CompiledBatchPlan(self, map_fn, dev, finalize,
                                     worker_axis(backend, self.n_workers,
                                                 group, dev))
        if map_fn is not None:
            raise ValueError("the fused fold decodes the standard wire "
                             "in-kernel; a custom map_fn does not apply")
        if rs.combine_fn is not None:
            raise ValueError("the fused fold is already the combiner; "
                             "combine_fn does not apply to windowed plans")
        if self.window.is_session:
            if self.window.gap <= 0:
                raise ValueError("session windows need a positive gap")
            if self.window.fanout_on_device or rs.mode != "aggregate":
                raise ValueError("session windows lower to the host-wire "
                                 "aggregate fold (fan-out 1) only")
        if self.window.fanout_on_device and self.window.size <= 0:
            raise ValueError("on-device fan-out needs a positive window size")
        if rs.mode == "group":
            if not self.window.fanout_on_device:
                raise ValueError("windowed group mode runs with on-device "
                                 "fan-out only")
        elif backend != "fused" and (self.window.n_slots * self.carry_buckets
                                     ) % self.n_workers:
            raise ValueError("n_slots * carry bucket width must divide by "
                             "n_workers")
        dev = resolve_device(device)
        axis = worker_axis(backend, self.n_workers, group, dev)
        if rs.mode == "group":
            return CompiledStreamGroup(self, dev, axis)
        return CompiledStreamAggregate(self, dev, axis)


# ---------------------------------------------------------------------------
# Batch lowering (one-shot jobs)
# ---------------------------------------------------------------------------

def streaming_record_map(shard: torch.Tensor):
    """Host-fan-out wire decode: ``shard`` is a ``(records, 4)`` float32
    tensor of ``[window_slot, key, value, valid]`` rows.  Emits int32
    slots and keys, ``(records, 2)`` ``[value, 1]`` value channels (count,
    sum and mean all come out of one carried pair) and the valid mask —
    the reference's decode, which the fused fold does in-kernel."""
    slots = shard[:, 0].to(torch.int32)
    keys = shard[:, 1].to(torch.int32)
    valid = shard[:, 3] > 0
    values = torch.stack([shard[:, 2], torch.ones_like(shard[:, 2])], dim=-1)
    return slots, keys, values, valid


def map_shards(shards: torch.Tensor, map_fn, n_workers: int):
    """The UDF on each worker's shard, its ``(keys, values, valid)``
    outputs concatenated over the workers — the combine's input — on the
    shards' device (a UDF may build a mask with ``torch.ones`` and no
    device).  The UDF sees one worker's shard at a time, as under the
    reference's ``vmap``, so a UDF that is not row-wise behaves the
    same."""
    if shards.dim() < 1 or shards.shape[0] != n_workers:
        raise ValueError(f"expected {n_workers} worker shards along axis 0, "
                         f"got data of shape {tuple(shards.shape)}")
    outs = [map_fn(shards[w]) for w in range(n_workers)]
    dev = shards.device
    return (torch.cat([k.reshape(-1).to(dev) for k, _, _ in outs]),
            torch.cat([v.to(dev) for _, v, _ in outs]),
            torch.cat([ok.reshape(-1).to(dev) for _, _, ok in outs])
            .to(torch.bool))


def _batch_body(shards: torch.Tensor, *, plan: ExecutionPlan, map_fn,
                finalize: bool, axis):
    """Map the local workers' shards (``(local, ...)``), then one
    aggregating shuffle over their records, or the grouping shuffle over
    the worker axis.  Returns ``(result, ShuffleStats)`` shaped as the
    reference's ``vmap`` backend returns them: the padded bucket vector
    (``finalize``), or the local workers' ``(local, padded / n_workers,
    ...)`` owner slices; in group mode the ``(group_keys, group_values,
    group_valid)`` triple, every worker's ``n_workers * capacity`` groups
    concatenated in worker order (``finalize``) or the local workers'
    stacked ``(local, n_workers * capacity)``."""
    ks, rs, n_workers = plan.key_space, plan.reduce, plan.n_workers
    keys, values, valid = map_shards(shards, map_fn, axis.local)
    raw = keys.to(torch.int32)
    buckets = stages.bucketize(raw, ks.num_buckets, hashed=ks.is_hashed)
    collisions = None
    if ks.is_hashed and ks.track_collisions:
        distinct = stages.distinct_keys_per_bucket(
            raw.reshape(axis.local, -1), valid.reshape(axis.local, -1), axis,
            ks.num_buckets)
        collisions = torch.clamp(distinct - 1, min=0)
    if rs.mode == "group":
        return _batch_group(buckets, values, valid, plan=plan,
                            finalize=finalize, collisions=collisions,
                            axis=axis)
    part = stages.shuffle_aggregate(buckets, values, axis,
                                    ks.padded(n_workers), valid=valid,
                                    combine_fn=rs.combine_fn)
    stats = stages.ShuffleStats(
        axis.psum(torch.sum(valid, dtype=torch.int32)),
        torch.zeros((), dtype=torch.int32, device=part.device), collisions)
    if finalize:
        return axis.all_gather(part), stats
    return part, stats


def _batch_group(buckets: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor, *, plan: ExecutionPlan, finalize: bool,
                 collisions, axis):
    """The group-mode batch body after the map: the local workers'
    records (worker-major, as ``map_shards`` concatenates them) through
    the grouping shuffle, then the reducer on each worker's merged stream
    — the user reducer sees one worker's stream at a time, as under the
    reference's ``vmap``."""
    rs, n_local = plan.reduce, axis.local
    vshape = tuple(values.shape[1:])
    out_k, out_v, starts, xstats = stages.shuffle_group(
        buckets.reshape(n_local, -1),
        values.reshape((n_local, -1) + vshape), plan.n_workers, rs.capacity,
        valid=valid.reshape(n_local, -1), axis=axis)
    groups = [stages.apply_reduce_fn(rs.reduce_fn, out_k[w], out_v[w],
                                     starts[w]) for w in range(n_local)]
    gk, gv, gvalid = (torch.stack([g[i] for g in groups]) for i in range(3))
    stats = stages.ShuffleStats(
        axis.psum(torch.sum(xstats.sent, dtype=torch.int32)),
        axis.psum(torch.sum(xstats.dropped, dtype=torch.int32)), collisions)
    if finalize:
        return (axis.all_gather(gk), axis.all_gather(gv),
                axis.all_gather(gvalid)), stats
    return (gk, gv, gvalid), stats


class CompiledBatchPlan:
    """One-shot lowering: ``run(shards) -> (result, ShuffleStats)``.

    ``shards`` is ``(n_workers, ...)`` — under ``"shard_map"`` this rank's
    one shard — a tensor, or a numpy array copied once to the plan's
    device.  The aggregate result is the padded dense bucket vector
    (``finalize=True``) or the local workers' owner slices of it; a top-k
    plan returns ``(bucket_ids, values, valid)`` of length ``k`` over the
    unpadded vector; a group plan returns the ``(group_keys,
    group_values, group_valid)`` triple.  Results and stats stay on the
    device; with ``finalize`` every rank gets the same ones.
    """

    def __init__(self, plan: ExecutionPlan, map_fn: Callable,
                 device: torch.device, finalize: bool, axis):
        self.plan = plan
        self.map_fn = map_fn
        self.device = device
        self.finalize = finalize
        self.axis = axis

    def run(self, data):
        """Run the job once over ``data``'s worker shards (this rank's
        shard under ``"shard_map"``)."""
        if isinstance(data, torch.Tensor):
            shards = data.to(self.device)
        else:
            shards = torch.from_numpy(np.ascontiguousarray(data)).to(
                self.device)
        if not self.axis.simulated:
            shards = shards.unsqueeze(0)        # the rank's one shard
        out, stats = _batch_body(shards, plan=self.plan, map_fn=self.map_fn,
                                 finalize=self.finalize, axis=self.axis)
        rs = self.plan.reduce
        if rs.mode == "top_k":
            kind = rs.reduce_fn if isinstance(rs.reduce_fn, str) else "sum"
            out = stages.top_k_buckets(out[:self.plan.key_space.num_buckets],
                                       rs.k, kind)
        return out, stats


# ---------------------------------------------------------------------------
# The streaming aggregate lowering
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place carry updates cannot reach (on the
    CPU, ``.numpy()`` alone would alias the carry)."""
    return t.to("cpu", copy=True).numpy()


def _rows_to(rows, device: torch.device) -> torch.Tensor:
    """Wire rows on the plan's device: a numpy array or a host tensor is
    copied there (to a card through pinned memory without waiting, so the
    fold queues behind the copy and the host moves on); a tensor already
    there passes through."""
    if not isinstance(rows, torch.Tensor):
        rows = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
    if device.type == "cuda" and rows.device.type == "cpu":
        return rows.pin_memory().to(device, non_blocking=True)
    return rows.to(device)


class CompiledStreamAggregate:
    """Streaming aggregate lowering: a dense carry over the flattened
    ``(window_slot, bucket)`` id space, folded once per micro-batch by the
    fused fold.

    ``step(rows, carry[, min_window]) -> (carry, stats)`` where stats is
    an int32 ``[late_pairs, folded_pairs, 0]`` tensor on the carry's
    device, left there so the caller decides when to read it.  The
    layouts follow the backend (the module docstring): ``"fused"`` takes
    the flat ``(R, 4|5)`` wire into the flat ``(n_slots * carry_buckets,
    C)`` carry; ``"vmap"`` the ``(W, per, 4|5)`` wire into the ``(W,
    n_slots * carry_buckets / W, C)`` carry, both folded as their flat
    views in one launch; ``"shard_map"`` this rank's ``(per, 4|5)`` shard
    of the flat wire into its ``(n_slots * carry_buckets / W, C)`` share
    of the carry, through a partial of the whole carry (zeros, the sum's
    identity), one reduce-scatter and a sum of the stats over the ranks.

    The carry is updated **in place**: ``step``, ``clear_slot`` and the
    cell ops write into the tensor they are given and return it.  That
    takes the place of the reference's buffer donation (``donate_argnums``
    on the jitted step, so its ``donate`` switch has no counterpart here)
    and is safe because every drive loop rebinds its carry from the result
    (``stage.carry = step(...)``) and never reads the argument again.
    Reads (``read_slot``, ``read_cell``, ``top_k_slot``) return host
    copies; under ``"shard_map"`` they gather the carry from every rank,
    so every rank reads the same window.
    """

    def __init__(self, plan: ExecutionPlan, device: torch.device, axis):
        ws = plan.window
        self.plan = plan
        self.device = device
        self.axis = axis
        self._buckets = plan.carry_buckets
        self._rows = ws.n_slots * plan.carry_buckets
        self._fold = fused_fold.make_fold_step(
            fanout=ws.fanout if ws.fanout_on_device else 1,
            n_slots=ws.n_slots, num_buckets=plan.key_space.num_buckets,
            carry_buckets=plan.carry_buckets,
            channel_base=plan.reduce.channel_base,
            hashed=plan.key_space.is_hashed,
            host_wire=not ws.fanout_on_device, kind="sum", device=device)

    def init_carry(self) -> torch.Tensor:
        """Zeroed carried window state — ``channels`` float32 columns,
        ``[sum, count]`` per plan (both sides' pairs for a join, which
        shares one carry) — on the plan's device, in the backend's
        layout."""
        shape = self.axis.rows_shape(self._rows) + (self.plan.reduce.channels,)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def step(self, rows, carry: torch.Tensor,
             min_window: int | None = None):
        """One micro-batch fold into ``carry`` (in place).  ``rows`` may be
        a numpy array or a host tensor (copied to the plan's device — to a
        card through pinned memory without waiting, so the fold queues
        behind the copy and the host moves on) or a tensor already
        there."""
        rows = _rows_to(rows, self.device)
        rows = rows.reshape(-1, rows.shape[-1])
        args = () if not self.plan.window.fanout_on_device else (min_window,)
        if self.axis.simulated:
            _, stats = self._fold(rows, carry.view(-1, carry.shape[-1]),
                                  *args)
            return carry, stats
        partial = torch.zeros((self._rows, carry.shape[-1]),
                              dtype=torch.float32, device=self.device)
        partial, stats = self._fold(rows, partial, *args)
        carry += self.axis.psum_scatter(partial)[0]
        return carry, self.axis.psum(stats)

    # -- the carry as one flat slab ------------------------------------------
    def _flat(self, carry: torch.Tensor) -> torch.Tensor:
        """The whole flat ``(n_slots * carry_buckets, C)`` carry: a view,
        or under ``"shard_map"`` every rank's share gathered."""
        return self.axis.unshard(carry).view(-1, carry.shape[-1])

    def _owned(self, carry: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """The rows ``[lo, hi)`` of the flat carry this process holds, as a
        writable view (empty where another rank holds them)."""
        flat = carry.view(-1, carry.shape[-1])
        base = self.axis.rank * flat.shape[0]
        lo, hi = max(lo - base, 0), min(hi - base, flat.shape[0])
        return flat[lo:max(hi, lo)]

    def checkpoint_carry(self, carry: torch.Tensor) -> torch.Tensor:
        """The carry as a checkpoint holds it: the backend's own layout,
        except under ``"shard_map"``, whose checkpoint is the gathered flat
        carry (so it restores under ``"fused"`` and the reference's
        ``pallas`` / ``shard_map``)."""
        return self.axis.unshard(carry)

    def restore_carry(self, saved: torch.Tensor) -> torch.Tensor:
        """This process's carry from a ``checkpoint_carry`` image (on the
        plan's device)."""
        return self.axis.shard(saved).clone()

    def _slot_rows(self, carry: torch.Tensor, slot: int) -> torch.Tensor:
        nb = self._buckets
        return self._flat(carry)[slot * nb:(slot + 1) * nb]

    def read_slot(self, carry: torch.Tensor, slot: int) -> np.ndarray:
        """One finalized window's dense ``(carry_buckets, channels)``
        aggregate; only the window's rows cross to the host."""
        return _to_host(self._slot_rows(carry, slot))

    def clear_slot(self, carry: torch.Tensor, slot: int) -> torch.Tensor:
        """Zero a finalized window's slice so its ring slot can be reused."""
        nb = self._buckets
        self._owned(carry, slot * nb, (slot + 1) * nb).zero_()
        return carry

    # -- cell ops (session windows: one key per window) ----------------------
    def _cell(self, slot: int, bucket: int) -> int:
        return slot * self._buckets + bucket

    def read_cell(self, carry: torch.Tensor, slot: int,
                  bucket: int) -> np.ndarray:
        """One (slot, bucket) cell's ``[sum, count]`` aggregate — a
        finalized session's entire state."""
        return _to_host(self._flat(carry)[self._cell(slot, bucket)])

    def merge_cell(self, carry: torch.Tensor, src_slot: int, dst_slot: int,
                   bucket: int) -> torch.Tensor:
        """Fold one cell's aggregate into another and zero the source —
        how a bridging event merges two open sessions of one key without
        the carry leaving the device."""
        src, dst = self._cell(src_slot, bucket), self._cell(dst_slot, bucket)
        flat = self._flat(carry)
        merged = flat[src] + flat[dst]
        self._owned(carry, dst, dst + 1)[:] = merged
        self._owned(carry, src, src + 1)[:] = 0.0
        return carry

    def clear_cell(self, carry: torch.Tensor, slot: int,
                   bucket: int) -> torch.Tensor:
        """Zero one (slot, bucket) cell so a finalized session's cell
        frees."""
        cell = self._cell(slot, bucket)
        self._owned(carry, cell, cell + 1).zero_()
        return carry

    # -- fixed-capacity heavy hitters ----------------------------------------
    def top_k_slot(self, carry: torch.Tensor, slot: int,
                   kind: str | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Select the plan's top-k buckets of one finalized window on the
        device: gather the slot's dense aggregate, rank per ``kind``
        (default: the plan's ``reduce_fn`` kind) and keep the k largest.
        Returns host ``(bucket_ids, values, valid)`` of length
        ``plan.reduce.k``."""
        rs = self.plan.reduce
        if rs.k < 1:
            raise ValueError("plan has no top-k capacity (reduce.k < 1)")
        if kind is None:
            kind = rs.reduce_fn if isinstance(rs.reduce_fn, str) else "sum"
        agg = self._slot_rows(carry, slot)[:self.plan.key_space.num_buckets]
        ids, vals, valid = stages.top_k_buckets(agg, rs.k, kind)
        return _to_host(ids), _to_host(vals), _to_host(valid)

    # -- carry handoff (multi-stage chains and DAG fan-out edges) ------------
    def handoff_rows(self, carry: torch.Tensor, slot: int,
                     relabel: torch.Tensor, last_window: int,
                     n_windows: int, kind: str,
                     dst_rows: int) -> torch.Tensor:
        """One finalized window's aggregates as a *successor* plan's wire
        rows, on the carry's device — the reduce → window → reduce seam
        of a stage DAG edge.  A teed stage calls this once per out-edge
        with that edge's own ``relabel`` table and the destination's wire
        size ``dst_rows``, so one finalized slot fans out to several
        downstream carries without visiting the host.

        The slot's rows are re-keyed through ``relabel`` (this plan's
        bucket id → the destination's key id, ``< 0`` = unassigned),
        stamped with the re-windowed span ``[last_window, n_windows]``
        (already rebased by the caller) and valued with the finalized
        ``kind`` aggregate (``stages.carry_handoff_rows``).  Returns the
        destination backend's wire: ``(W, dst_rows / W, 5)`` under
        ``"vmap"``, the flat global ``(dst_rows, 5)`` otherwise (every
        rank builds all of it; each folds its own shard)."""
        rows = stages.carry_handoff_rows(
            self._slot_rows(carry, slot), relabel, last_window, n_windows,
            kind, dst_rows, channel_base=self.plan.reduce.channel_base)
        return self.axis.layout(rows)


# ---------------------------------------------------------------------------
# The streaming group-mode lowering
# ---------------------------------------------------------------------------

class CompiledStreamGroup:
    """Streaming group-mode lowering: the carry is a fixed-capacity record
    buffer per (worker, window slot), and any ``reduce_fn`` runs over each
    key's full value list when a window finalizes (``finalize_slot``) —
    the contract of batch group mode.

    The carry is the dict ``{"keys": int32 (-1 = empty), "vals": float32,
    "counts": int32}`` on the plan's device, in the reference's layouts:
    ``(W, n_slots, capacity)`` buffers and ``(W, n_slots)`` counts under
    ``"fused"`` and ``"vmap"``, so a checkpoint of it moves between the two
    packages; under ``"shard_map"`` this rank's ``(n_slots, capacity)`` and
    ``(n_slots,)`` share of the reference's ``(W * n_slots, capacity)``.

    ``step(rows, carry, min_window) -> (carry, stats)`` folds one
    device-wire micro-batch: the records fan out to their windows on the
    device, each live (record, window) pair goes to worker
    ``hash_partition(slot * num_buckets + bucket, W)``, and is appended to
    that worker's buffer for the slot; past ``capacity`` it is dropped and
    counted.  ``stats`` is an int32 ``[late, expanded, dropped]`` tensor
    left on the device.  With simulated workers (``"fused"``, and
    ``"vmap"``'s ``(W, per, 5)`` wire seen flat) one stable sort of the
    flat wire by (worker, slot) puts every record where the reference's
    exchange would: it deals the wire to its workers in contiguous slices
    and sends every expanded record, so only the buffers drop.  Under
    ``"shard_map"`` the rank builds its send buffers from its ``(per, 5)``
    shard and the exchange is the axis's ``all_to_all``, as in the
    reference.  ``step`` returns new buffers (it does not write into the
    ones it is given); ``clear_slot`` empties a slot in place.
    """

    def __init__(self, plan: ExecutionPlan, device: torch.device, axis):
        self.plan = plan
        self.device = device
        self.axis = axis

    def init_carry(self) -> dict:
        """Empty per-(worker, window slot) record buffers on the plan's
        device."""
        plan = self.plan
        shape = (plan.window.n_slots, plan.reduce.capacity)
        if self.axis.simulated:
            shape = (plan.n_workers,) + shape
        return {"keys": torch.full(shape, stages.INVALID, dtype=torch.int32,
                                   device=self.device),
                "vals": torch.zeros(shape, dtype=torch.float32,
                                    device=self.device),
                "counts": torch.zeros(shape[:-1], dtype=torch.int32,
                                      device=self.device)}

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """A carry leaf with its leading axis of local workers (a view)."""
        return t if self.axis.simulated else t.unsqueeze(0)

    def _fanout(self, rows: torch.Tensor, min_window: int):
        """Decode device-wire rows, bucket their keys and fan them out to
        their windows: ``(flat (slot, bucket) ids, values, live, late,
        expanded)``."""
        ks, ws = self.plan.key_space, self.plan.window
        last, nw = rows[:, 0].to(torch.int32), rows[:, 1].to(torch.int32)
        buckets = stages.bucketize(rows[:, 2].to(torch.int32),
                                   ks.num_buckets, hashed=ks.is_hashed)
        slots, keys_f, vals_f, live, late, expanded = stages.window_fanout(
            last, nw, buckets, rows[:, 3], rows[:, 4] > 0, ws.fanout,
            ws.n_slots, min_window)
        return (slots.to(torch.int64) * ks.num_buckets + keys_f, vals_f,
                live, late, expanded)

    def step(self, rows, carry: dict, min_window: int = -(2 ** 31)):
        """One micro-batch fold of device-wire rows ``[last_window,
        n_windows, key, value, valid]`` (window indices rebased by the
        caller; ``min_window`` is the late bound on the same base)."""
        rows = _rows_to(rows, self.device)
        rows = rows.reshape(-1, rows.shape[-1])
        if self.axis.simulated:
            return self._step_flat(rows, carry, min_window)
        plan, axis = self.plan, self.axis
        flat, vals, live, late, expanded = self._fanout(rows, min_window)
        # capacity = every expanded record: the exchange cannot drop, only
        # the per-slot window buffers bound capacity
        sk, sv, sok, _ = stages.build_send_buffers(
            flat, vals, plan.n_workers, flat.shape[0], valid=live)
        rk, rv, rok = stages.exchange(sk[None], sv[None], sok[None], axis)
        ok = rok[0].reshape(-1)
        kb, vb, counts, dropped = stages.append_window_records(
            carry["keys"], carry["vals"], carry["counts"], rk[0].reshape(-1),
            torch.where(ok, rv[0].reshape(-1), 0.0), ok, plan.window.n_slots,
            plan.reduce.capacity, plan.key_space.num_buckets)
        stats = torch.stack([late, expanded, dropped]).to(torch.int32)
        return {"keys": kb, "vals": vb, "counts": counts}, axis.psum(stats)

    def _step_flat(self, rows: torch.Tensor, carry: dict, min_window: int):
        """The simulated workers' fold: the whole flat wire, one stable
        sort by (worker, slot) into the stacked buffers."""
        plan = self.plan
        ks, ws = plan.key_space, plan.window
        flat, vals_f, live, late, expanded = self._fanout(rows, min_window)
        keys_f = flat % ks.num_buckets
        slots = flat // ks.num_buckets
        cell = (stages.hash_partition(flat, plan.n_workers).to(torch.int64)
                * ws.n_slots + slots)
        n_cells = plan.n_workers * ws.n_slots
        cap = plan.reduce.capacity
        kb, vb, counts, dropped = stages.append_window_records(
            carry["keys"].reshape(n_cells, cap),
            carry["vals"].reshape(n_cells, cap),
            carry["counts"].reshape(n_cells), cell * ks.num_buckets + keys_f,
            vals_f, live, n_cells, cap, ks.num_buckets)
        shape = carry["keys"].shape
        new = {"keys": kb.reshape(shape), "vals": vb.reshape(shape),
               "counts": counts.reshape(shape[:-1])}
        return new, torch.stack([late, expanded, dropped])

    def finalize_slot(self, carry: dict, slot: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Gather, merge and reduce one window's buffered records across
        every worker; returns host ``(group_keys, group_values,
        group_valid)`` of length ``W * capacity`` (the window's groups
        first, in key order), the same on every rank."""
        gk, gv, gvalid = stages.gather_window_group(
            self._local(carry["keys"]), self._local(carry["vals"]), slot,
            self.plan.reduce.reduce_fn, axis=self.axis)
        return _to_host(gk), _to_host(gv), _to_host(gvalid)

    def clear_slot(self, carry: dict, slot: int) -> dict:
        """Empty one slot of every local worker's buffers (in place) so
        its ring slot can be reused."""
        stages.clear_window_group(self._local(carry["keys"]),
                                  self._local(carry["vals"]),
                                  self._local(carry["counts"]), slot)
        return carry

    def checkpoint_carry(self, carry: dict) -> dict:
        """The carry as a checkpoint holds it: the backend's own layout,
        except under ``"shard_map"``, whose checkpoint is every rank's share
        gathered into the reference's ``(W * n_slots, capacity)``
        buffers."""
        return {k: self.axis.unshard(v) for k, v in carry.items()}

    def restore_carry(self, saved: dict) -> dict:
        """This process's carry from a ``checkpoint_carry`` image."""
        return {k: self.axis.shard(v).clone() for k, v in saved.items()}
