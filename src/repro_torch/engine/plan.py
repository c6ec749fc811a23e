"""Execution plans — the declarative layer over the streaming engine.

A streaming MapReduce job on the device plane is a point in a small
product space:

    ``KeySpace``  ×  ``WindowSpec``  ×  ``ReduceSpec``  →  compiled plan

``KeySpace`` says how raw keys become bucket ids (dense pre-assigned ids,
or hashed open domains).  ``WindowSpec`` says whether records carry
event-time windows fanned out on the device (one 5-column row per record)
or already expanded by the host (one 4-column row per record × window).
``ReduceSpec`` says how values reduce: the aggregate fold, optionally
with a top-k selection at finalization.

``ExecutionPlan.compile(device=...)`` lowers a windowed aggregate plan to
a ``CompiledStreamAggregate``: a flat ``(n_slots * num_buckets, 2)``
float32 carry on ``device``, folded once per micro-batch by
the fused fold (``kernels/fused_fold``: a hand-written CUDA kernel for
CUDA tensors, its plain PyTorch version for CPU tensors).  That is the
carry layout of the reference's ``backend="pallas"``, so checkpoints move
between the two packages unchanged.  Batch plans, group mode and the
simulated-worker and multi-process backends are not ported yet; asking
for them raises ``NotImplementedError`` naming the ``ROADMAP.md`` item.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..kernels.fused_fold import ops as fused_fold
from . import stages

#: the one backend the port has: the fused fold over a flat carry slab
BACKEND = "fused"
#: reference backends still to port, with the ROADMAP item that queues them
_UNPORTED_BACKENDS = {
    "vmap": "Queue A #11 (vmap / shard_map backends)",
    "shard_map": "Queue A #11 (vmap / shard_map backends)",
}


def resolve_device(device) -> torch.device:
    """The device a plan's carry lives on.  ``"cuda"`` (the default of
    every entry point) must exist: on a host without CUDA this raises
    instead of quietly running somewhere else — ask for ``"cpu"``
    explicitly to run the plain PyTorch fold."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch reports no CUDA "
            f"device on this host; pass device='cpu' to run the plain "
            f"PyTorch fold on the CPU")
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
    ``device_hash``; distinct keys may collide (the coordinator's host-side
    label table counts collisions exactly).
    """

    num_buckets: int
    mode: str = "dense"             # "dense" | "hashed"

    @classmethod
    def dense(cls, num_buckets: int) -> "KeySpace":
        return cls(num_buckets, "dense")

    @classmethod
    def hashed(cls, num_buckets: int) -> "KeySpace":
        return cls(num_buckets, "hashed")

    @property
    def is_hashed(self) -> bool:
        return self.mode == "hashed"


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
    ranking kind).  ``group`` mode and shared join carries (the kernel
    already honours a channel offset) are not ported yet.
    """

    mode: str = "aggregate"         # "aggregate" | "top_k" ("group": later)
    reduce_fn: str | Callable = "sum"
    k: int = 0                      # top_k mode: selection capacity

    @classmethod
    def top_k(cls, k: int) -> "ReduceSpec":
        return cls(mode="top_k", k=k)


@dataclass(frozen=True)
class ExecutionPlan:
    """One device MapReduce job, declaratively.  ``compile()`` lowers it.
    ``n_workers`` is kept for parity with the reference's plans and is
    ignored: the fused fold runs over the whole flat carry with no worker
    axis until the ``vmap``/``shard_map`` slice (ROADMAP Queue A #11)."""

    key_space: KeySpace
    reduce: ReduceSpec
    n_workers: int
    window: WindowSpec | None = None

    def compile(self, map_fn: Callable | None = None, *,
                backend: str = BACKEND, device="cuda"
                ) -> "CompiledStreamAggregate":
        """Lower a windowed aggregate (or top-k) plan onto ``device``."""
        rs = self.reduce
        if backend in _UNPORTED_BACKENDS:
            raise not_ported(f"backend={backend!r}",
                             _UNPORTED_BACKENDS[backend])
        if backend != BACKEND:
            raise ValueError(f"unknown backend {backend!r} (the port has "
                             f"{BACKEND!r})")
        if self.window is None:
            raise not_ported("batch plans (window=None)",
                             "Queue A #9 (batch plans + hash_combine)")
        if rs.mode == "group":
            raise not_ported("group-mode reduction", "Queue A #8 (group mode)")
        if rs.mode not in ("aggregate", "top_k"):
            raise ValueError(f"unknown reduce mode {rs.mode!r}")
        if map_fn is not None:
            raise ValueError("the fused fold decodes the standard wire "
                             "in-kernel; a custom map_fn does not apply")
        if rs.mode == "top_k" and rs.k < 1:
            raise ValueError("top_k mode needs k >= 1")
        if self.window.is_session:
            if self.window.gap <= 0:
                raise ValueError("session windows need a positive gap")
            if self.window.fanout_on_device or rs.mode != "aggregate":
                raise ValueError("session windows lower to the host-wire "
                                 "aggregate fold (fan-out 1) only")
        if self.window.fanout_on_device and self.window.size <= 0:
            raise ValueError("on-device fan-out needs a positive window size")
        return CompiledStreamAggregate(self, resolve_device(device))


# ---------------------------------------------------------------------------
# The streaming aggregate lowering
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place carry updates cannot reach (on the
    CPU, ``.numpy()`` alone would alias the carry)."""
    return t.to("cpu", copy=True).numpy()


class CompiledStreamAggregate:
    """Streaming aggregate lowering: a flat dense carry over the
    ``(window_slot, bucket)`` id space, folded once per micro-batch by the
    fused fold.

    ``step(rows, carry[, min_window]) -> (carry, stats)`` where stats is
    an int32 ``[late_pairs, folded_pairs, 0]`` tensor on the carry's
    device, left there so the caller decides when to read it.

    The carry is updated **in place**: ``step``, ``clear_slot`` and the
    cell ops write into the tensor they are given and return it.  That
    takes the place of the reference's buffer donation (``donate_argnums``
    on the jitted step, so its ``donate`` switch has no counterpart here)
    and is safe because every drive loop rebinds its carry from the result
    (``stage.carry = step(...)``) and never reads the argument again.
    Reads (``read_slot``, ``read_cell``, ``top_k_slot``) return host
    copies.
    """

    def __init__(self, plan: ExecutionPlan, device: torch.device):
        ws = plan.window
        nb = plan.key_space.num_buckets
        self.plan = plan
        self.device = device
        self._buckets = nb
        self._geometry = dict(
            fanout=ws.fanout if ws.fanout_on_device else 1,
            n_slots=ws.n_slots, num_buckets=nb, carry_buckets=nb,
            hashed=plan.key_space.is_hashed,
            host_wire=not ws.fanout_on_device, kind="sum")

    def init_carry(self) -> torch.Tensor:
        """Zeroed carried window state — ``(n_slots * num_buckets, 2)``
        float32 ``[sum, count]`` — on the plan's device."""
        return torch.zeros((self.plan.window.n_slots * self._buckets, 2),
                           dtype=torch.float32, device=self.device)

    def step(self, rows, carry: torch.Tensor,
             min_window: int | None = None):
        """One micro-batch fold into ``carry`` (in place).  ``rows`` may be
        a numpy array or a host tensor (copied to the plan's device — to a
        card through pinned memory without waiting, so the fold queues
        behind the copy and the host moves on) or a tensor already
        there."""
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        if self.device.type == "cuda" and rows.device.type == "cpu":
            rows = rows.pin_memory().to(self.device, non_blocking=True)
        else:
            rows = rows.to(self.device)
        if not self.plan.window.fanout_on_device:
            min_window = None
        return fused_fold.fold(rows, carry, min_window, **self._geometry)

    def _slot_rows(self, carry: torch.Tensor, slot: int) -> torch.Tensor:
        nb = self._buckets
        return carry[slot * nb:(slot + 1) * nb]

    def read_slot(self, carry: torch.Tensor, slot: int) -> np.ndarray:
        """One finalized window's dense ``(num_buckets, 2)`` aggregate;
        only the window's rows cross to the host."""
        return _to_host(self._slot_rows(carry, slot))

    def clear_slot(self, carry: torch.Tensor, slot: int) -> torch.Tensor:
        """Zero a finalized window's slice so its ring slot can be reused."""
        self._slot_rows(carry, slot).zero_()
        return carry

    # -- cell ops (session windows: one key per window) ----------------------
    def _cell(self, slot: int, bucket: int) -> int:
        return slot * self._buckets + bucket

    def read_cell(self, carry: torch.Tensor, slot: int,
                  bucket: int) -> np.ndarray:
        """One (slot, bucket) cell's ``[sum, count]`` aggregate — a
        finalized session's entire state."""
        return _to_host(carry[self._cell(slot, bucket)])

    def merge_cell(self, carry: torch.Tensor, src_slot: int, dst_slot: int,
                   bucket: int) -> torch.Tensor:
        """Fold one cell's aggregate into another and zero the source —
        how a bridging event merges two open sessions of one key without
        the carry leaving the device."""
        src, dst = self._cell(src_slot, bucket), self._cell(dst_slot, bucket)
        merged = carry[src] + carry[dst]
        carry[dst] = merged
        carry[src] = 0.0
        return carry

    def clear_cell(self, carry: torch.Tensor, slot: int,
                   bucket: int) -> torch.Tensor:
        """Zero one (slot, bucket) cell so a finalized session's cell
        frees."""
        carry[self._cell(slot, bucket)] = 0.0
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
        agg = self._slot_rows(carry, slot)
        ids, vals, valid = stages.top_k_buckets(agg, rs.k, kind)
        return _to_host(ids), _to_host(vals), _to_host(valid)

    def handoff_rows(self, *args, **kwargs):
        """Multi-stage carry handoff — not ported yet."""
        raise not_ported("the multi-stage carry handoff",
                         "Queue A #6 (multi-stage chains and tee)")
