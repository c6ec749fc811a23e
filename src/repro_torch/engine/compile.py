"""Backends: where a plan's workers live and the collectives between them.

The reference lowers one SPMD stage body three ways (``vmap``,
``shard_map``, ``pallas``).  The port has three backends too:

* ``"fused"`` — the port's own default: a streaming aggregate folds the
  whole flat carry in one ``fused_fold`` launch, with no worker axis; batch
  plans map each of ``n_workers`` shards and combine them on one device.
* ``"vmap"`` — ``n_workers`` simulated workers on one device, in the
  reference's ``vmap`` layouts: carries and wires gain a leading worker
  axis (``SimulatedAxis``).
* ``"shard_map"`` — one ``torch.distributed`` rank per worker, each
  holding its share of the flat global layouts (``DistributedAxis``):
  NCCL for CUDA tensors, gloo for CPU tensors.

A *worker axis* offers the reference's four collectives — ``psum``,
``psum_scatter`` (a reduce-scatter over the leading rows), ``all_to_all``
and ``all_gather`` — so the stage functions in ``engine.stages`` are
written once and never name a backend.  It also holds the backend's
layouts, so the plans and the coordinator never name one either:
``rows_shape`` (the leading dimensions of a carry this process holds),
``layout`` (a flat tensor in the reference's wire layout), ``shard`` /
``unshard`` (this process's contiguous part of a flat global tensor, and
back) and ``round_rows`` (a wire size in whole per-worker slices).

One convention makes the collectives work on both axes: a tensor held
per worker carries a leading axis of the process's **local** workers
(all of them on the simulated axis, one on a rank), and the reductions
take what the process's workers contribute already summed over them — on
the simulated axis one combine over every worker's rows *is* the sum
over senders, so its ``psum`` is the identity and its ``psum_scatter``
only cuts the owners' slices out.
"""

from __future__ import annotations

import torch

#: the backends ``ExecutionPlan.compile`` and ``Pipeline.build`` accept
BACKENDS = ("fused", "vmap", "shard_map")


class SimulatedAxis:
    """``size`` workers simulated on one device: every per-worker tensor
    holds all of them along its leading axis, and each collective is the
    tensor op the reference's ``vmap`` lowers it to.  ``stacked`` picks
    the aggregate layouts: the reference's ``vmap`` ones, with a leading
    worker axis (``"vmap"``), or the flat slab and wire (``"fused"``)."""

    simulated = True

    def __init__(self, size: int, stacked: bool = True) -> None:
        if size < 1:
            raise ValueError(f"a worker axis needs >= 1 worker, got {size}")
        self.size = size
        self.stacked = stacked
        self.local = size               # workers this process holds
        self.rank = 0                   # this process's place on the axis

    def rows_shape(self, rows: int) -> tuple:
        """Leading dimensions of ``rows`` flat carry rows as held here:
        ``(W, rows / W)`` stacked, ``(rows,)`` flat."""
        return (self.size, rows // self.size) if self.stacked else (rows,)

    def layout(self, t):
        """A flat ``(N, width)`` wire (or one already laid out) in the
        reference's layout: ``(W, N / W, width)`` stacked, as is flat."""
        return t.reshape(self.size, -1, t.shape[-1]) if self.stacked else t

    def shard(self, t):
        """This process's part of a global tensor: all of it."""
        return t

    def unshard(self, t):
        """The global tensor from this process's part: the part itself."""
        return t

    def round_rows(self, rows: int) -> int:
        """A wire of ``rows`` rows in whole per-worker slices (the flat
        wire is not dealt to workers, so it stays as is)."""
        return -(-rows // self.size) * self.size if self.stacked else rows

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the workers of what this process's workers contributed
        — already the whole sum here."""
        return x

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The summed ``(N, ...)`` contribution as every worker's
        contiguous owner slice, ``(size, N / size, ...)`` — a view."""
        return x.reshape((self.size, x.shape[0] // self.size)
                         + tuple(x.shape[1:]))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``(W_src, W_dst, ...)`` send buffers → ``(W_dst, W_src, ...)``
        receive buffers: row ``q`` of worker ``p``'s result came from
        worker ``q``."""
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(W, n, ...)`` per-worker pieces concatenated in worker order,
        ``(W * n, ...)``."""
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def barrier(self) -> None:
        """Nothing to wait for in one process."""


class DistributedAxis:
    """One worker per rank of a ``torch.distributed`` process group.  Only
    ``all_to_all_single``, ``all_gather`` (list form) and ``all_reduce``
    (sum; max for ``pmax``) are called, so NCCL (CUDA tensors) and gloo
    (CPU tensors) both serve it; the reduce-scatter is an
    ``all_to_all_single`` and a sum over the senders in rank order, the
    same order under either backend.  Boolean tensors travel as
    ``uint8``.  ``group=None`` is the default group."""

    simulated = False

    def __init__(self, group) -> None:
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local = 1

    def rows_shape(self, rows: int) -> tuple:
        """Leading dimensions of this rank's share of ``rows`` flat carry
        rows: ``(rows / W,)``."""
        return (rows // self.size,)

    def layout(self, t):
        """The reference's ``shard_map`` wire is the flat global one."""
        return t

    def shard(self, t):
        """This rank's contiguous ``N / W`` rows of a global ``(N, ...)``
        tensor or array (a view)."""
        n = t.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"ranks")
        per = n // self.size
        return t[self.rank * per:(self.rank + 1) * per]

    def unshard(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(n, ...)`` part concatenated in rank order (an
        ``all_gather``)."""
        return self.all_gather(t.unsqueeze(0))

    def round_rows(self, rows: int) -> int:
        """A wire of ``rows`` rows in whole per-rank slices."""
        return -(-rows // self.size) * self.size

    @staticmethod
    def _send(x: torch.Tensor) -> torch.Tensor:
        return (x.to(torch.uint8) if x.dtype == torch.bool
                else x).contiguous()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``all_reduce`` (sum) of this rank's contribution."""
        out = self._send(x).clone()
        self._dist.all_reduce(out, group=self.group)
        return out.to(x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """``all_reduce`` (max) of this rank's value."""
        out = self._send(x).clone()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.MAX,
                              group=self.group)
        return out.to(x.dtype)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's owner slice of the sum of every rank's ``(N, ...)``
        contribution, as ``(1, N / size, ...)``: slice ``s`` of every rank
        comes here through one ``all_to_all_single`` and the pieces add up
        in rank order."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not scatter over "
                             f"{self.size} ranks")
        send = self._send(x)
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=self.group)
        parts = recv.reshape((self.size, x.shape[0] // self.size)
                             + tuple(x.shape[1:])).to(x.dtype)
        out = parts[0].clone()
        for s in range(1, self.size):
            out += parts[s]
        return out.unsqueeze(0)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``(1, W_dst, ...)`` send buffers → its ``(1, W_src,
        ...)`` receive buffers."""
        send = self._send(x[0])
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=self.group)
        return recv.to(x.dtype).unsqueeze(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(1, n, ...)`` piece concatenated in rank order,
        ``(size * n, ...)``."""
        send = self._send(x[0])
        parts = [torch.empty_like(send) for _ in range(self.size)]
        self._dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts).to(x.dtype)

    def barrier(self) -> None:
        """Wait until every rank got here (a one-element ``all_reduce``)."""
        backend = self._dist.get_backend(self.group)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if backend == "nccl" else torch.device("cpu"))
        self._dist.all_reduce(torch.zeros(1, device=dev), group=self.group)


def process_group(n_workers: int, group=None, device=None):
    """The process group a ``shard_map`` plan runs over: ``group``, or the
    default group the caller initialised with
    ``torch.distributed.init_process_group``.  Raises — as the reference's
    "shard_map backend needs a mesh" does — when ``torch.distributed`` is
    not initialised, when the group's size is not ``n_workers``, or when
    its backend does not serve ``device`` (NCCL for CUDA, gloo for the
    CPU: nothing is staged through the host behind the caller's back)."""
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError("backend='shard_map' needs an initialised "
                         "torch.distributed process group (one rank per "
                         "worker: init_process_group(...) before build)")
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if size != n_workers:
        raise ValueError(f"backend='shard_map' runs one rank per worker: "
                         f"n_workers={n_workers} but the process group "
                         f"has {size} ranks")
    if device is not None:
        want = "nccl" if torch.device(device).type == "cuda" else "gloo"
        have = dist.get_backend(group)
        if have != want:
            raise ValueError(f"a plan on {device} needs a {want!r} process "
                             f"group; this one is {have!r}")
    return group


def worker_axis(backend: str, n_workers: int, group=None, device=None):
    """The worker axis a plan's stages run over: ``n_workers`` simulated
    workers (``"vmap"``; flat aggregate layouts under ``"fused"``) or this
    rank of the process group (``"shard_map"``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if backend == "shard_map":
        process_group(n_workers, group, device)
        # the default group stays None: a plan holding its object keeps it
        # past destroy_process_group until interpreter exit, and gloo ranks
        # then aborted now and then ("terminate called without an active
        # exception")
        return DistributedAxis(group)
    if group is not None:
        raise ValueError(f"group= is the shard_map backend's process group; "
                         f"backend={backend!r} takes none")
    return SimulatedAxis(n_workers, stacked=backend == "vmap")
