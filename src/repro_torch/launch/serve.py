"""Serving launcher: batched decode with a request queue.

The partner of ``repro/launch/serve.py``'s LM half (``Request``,
``BatchedServer``, ``_merge_slot``, ``main``): prefill on arrival, then
batched one-token steps over the active set (continuous batching-lite:
finished sequences free their slot for queued requests).  Entry points
default to the card; on a host without CUDA pass ``device="cpu"``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --requests 16 --max-new 32 --device cpu

The module's other half is the job service's RPC front end:
``JobRPC`` dispatches JSON requests onto a ``service.JobServer``, and
``JobSocketServer`` puts it behind a TCP socket for a
``core.client.JobServiceClient(address=...)`` in another process.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import configs
from ..core.rpc import FrameServer
from ..engine.plan import resolve_device
from ..models import decode_step, init_cache, init_params
from ..models.attention import cache_write_pos
from ..models.transformer import check_ported


@dataclass
class Request:
    """One generation request: a prompt and how many tokens to add."""

    id: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    tokens: list[int] = field(default_factory=list)
    done: bool = False


def _merge_slot(new: torch.Tensor, old: torch.Tensor,
                slot: int) -> torch.Tensor:
    """``old`` with ``new``'s values on the admitted slot's batch lane.

    Batch axis convention: lengths are (B,), layer-stacked caches are
    (L, B, ...) — axis 0 or 1 respectively."""
    ax = 0 if new.dim() == 1 else 1
    idx = tuple(slice(slot, slot + 1) if a == ax else slice(None)
                for a in range(new.dim()))
    out = old.clone()
    out[idx] = new[idx]
    return out


#: a cache's (k, v) pairs: the attention layers' and zamba2's shared
#: block's (one cache a call of the block)
_KV = (("k", "v"), ("sa_k", "sa_v"))


def _written_cells(cache: dict, k_name: str = "k", v_name: str = "v"):
    """Where the next decode step writes ``cache[k_name]`` and
    ``cache[v_name]`` (``cache_write_pos``) and what those cells hold
    now."""
    k = cache[k_name]
    pos = cache_write_pos(cache["lengths"], k.shape[3])
    idx = pos.view(1, -1, 1, 1, 1).expand(k.shape[0], k.shape[1],
                                          k.shape[2], 1, k.shape[4])
    return idx, k.gather(3, idx), cache[v_name].gather(3, idx)


def _saved_lanes(cache: dict) -> dict:
    """What the next decode step overwrites, as it holds now: the cells
    of every k and v cache at each row's write position
    (``_written_cells``), and of a Mamba cache the whole conv and SSM
    states (a few MB a layer) — for zamba2 both kinds."""
    saved = {k_name: _written_cells(cache, k_name, v_name)
             for k_name, v_name in _KV if k_name in cache}
    if "mamba" in cache:
        saved["mamba"] = {name: t.clone()
                          for name, t in cache["mamba"].items()}
    return saved


def _restore_lanes(cache: dict, saved: dict, slot: int) -> None:
    """Put the saved values back on every lane but ``slot``: with
    ``_merge_slot`` on the lengths, this keeps only the admitted slot's
    lanes of a full-batch step, as the reference's merge of whole caches
    does — for k and v without copying the caches."""
    for name, old in saved.get("mamba", {}).items():
        cur = cache["mamba"][name]
        others = torch.arange(cur.shape[1], device=cur.device) != slot
        cur[:, others] = old[:, others]
    for k_name, v_name in _KV:
        if k_name not in saved:
            continue
        idx, k_old, v_old = saved[k_name]
        others = torch.ones(idx.shape[1], dtype=torch.bool,
                            device=idx.device)
        others[slot] = False
        others = others.view(1, -1, 1, 1, 1)
        for name, old in ((k_name, k_old), (v_name, v_old)):
            cur = cache[name].gather(3, idx)
            cache[name].scatter_(3, idx, torch.where(others, old, cur))


class BatchedServer:
    """Fixed-slot batched decoder.  Each slot holds one active request;
    queue admission happens between steps (an idle server holds no cache
    memory until requests arrive).

    Admission keeps the reference's semantics: the prompt runs through
    full-batch decode steps (every slot's lanes compute), and only the
    admitted slot's lanes are kept.  A slot's length — and for a Mamba
    model its conv and SSM state — carries over from the request it held
    before, and idle slots advance on token 0 in ``step``, as in the
    reference."""

    def __init__(self, cfg, params, n_slots: int, max_len: int,
                 eos: int | None = None, *, device="cuda") -> None:
        check_ported(cfg)
        self.device = resolve_device(device)
        where = params["embed"].device
        if where.type != self.device.type:
            raise ValueError(f"the parameters lie on {where}, the server "
                             f"is asked to run on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos
        self.cache = None             # allocated on first admission
        self.slots: list[Request | None] = [None] * n_slots
        self.queue: list[Request] = []

    def submit(self, req: Request) -> None:
        """Queue a request; it is admitted when a slot frees."""
        self.queue.append(req)

    def _admit_step(self, token: int, slot: int) -> None:
        """One full-batch decode step of which only ``slot``'s lanes are
        kept."""
        t = torch.full((self.n_slots, 1), token, dtype=torch.int32,
                       device=self.device)
        saved = _saved_lanes(self.cache)
        old_lengths = self.cache["lengths"]
        _, new = decode_step(self.params, self.cache, t, self.cfg)
        self.cache = dict(new, lengths=_merge_slot(new["lengths"],
                                                   old_lengths, slot))
        _restore_lanes(self.cache, saved, slot)

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                if self.cache is None:
                    self.cache = init_cache(self.cfg, self.n_slots,
                                            self.max_len, device=self.device)
                # per-slot prefill: run the prompt through decode steps
                for tok in req.prompt[:-1]:
                    self._admit_step(int(tok), i)
                req.tokens = [int(req.prompt[-1])]
                self.slots[i] = req

    def step(self) -> int:
        """One batched decode step over all active slots; returns how many
        slots it served."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        toks = np.zeros((self.n_slots, 1), np.int32)
        for i, r in enumerate(self.slots):
            if r is not None:
                toks[i, 0] = r.tokens[-1]
        logits, self.cache = decode_step(
            self.params, self.cache,
            torch.from_numpy(toks).to(self.device), self.cfg)
        nxt = torch.argmax(logits, dim=-1).tolist()
        for i in active:
            r = self.slots[i]
            r.tokens.append(int(nxt[i]))
            if len(r.tokens) - 1 >= r.max_new or (
                    self.eos is not None and int(nxt[i]) == self.eos):
                r.done = True
                self.slots[i] = None       # free the slot (scale down)
        return len(active)


class JobRPC:
    """Transport-less RPC dispatch onto the multi-tenant job server.

    One ``handle({"method": ..., ...params})`` call per request, answers
    ``{"ok": True, "result": ...}`` or ``{"ok": False, "error": ...}`` —
    the wire shape an HTTP trigger would carry, minus the socket.  A
    compiled ``BuiltPipeline`` never crosses this boundary: ``register``
    binds a program under a name server-side, and ``submit`` requests
    reference that name (the paper submits a JSON job config the same
    way).  Status polls answer purely from the metadata records, so a
    monitoring process needs no server handle at all.
    """

    METHODS = ("register", "submit", "pause", "resume", "cancel",
               "status", "jobs", "stats", "drain")

    def __init__(self, server) -> None:
        self.server = server
        self.programs: dict[str, object] = {}

    def register(self, name: str, program) -> None:
        """Server-side program registry: name → BuiltPipeline."""
        self.programs[name] = program

    def handle(self, request: dict) -> dict:
        method = request.get("method")
        params = {k: v for k, v in request.items() if k != "method"}
        if method not in self.METHODS:
            return {"ok": False,
                    "error": f"unknown method: {method!r}"}
        try:
            return {"ok": True, "result": getattr(self, f"_{method}")(
                **params)}
        except Exception as exc:                    # noqa: BLE001 — RPC edge
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}

    # -- verbs ---------------------------------------------------------------
    def _register(self, name, program):
        self.register(name, program)
        return name

    def _submit(self, tenant, program, source_prefix, resume=False,
                partitions=None):
        if program not in self.programs:
            raise KeyError(f"no program registered as {program!r}")
        return self.server.submit(tenant, self.programs[program],
                                  source_prefix=source_prefix,
                                  resume=resume, partitions=partitions)

    def _pause(self, job_id):
        self.server.pause(job_id)
        return self.server.status(job_id)["state"]

    def _resume(self, job_id):
        self.server.resume(job_id)
        return self.server.status(job_id)["state"]

    def _cancel(self, job_id):
        self.server.cancel(job_id)
        return self.server.status(job_id)["state"]

    def _status(self, job_id):
        return self.server.status(job_id)

    def _jobs(self):
        return self.server.registry.jobs()

    def _stats(self):
        return self.server.stats()

    def _drain(self):
        return self.server.run_until_complete()


class JobSocketServer(FrameServer):
    """The job-service control plane behind a real TCP socket.

    Wraps a :class:`JobRPC` in a :class:`~repro_torch.core.rpc.FrameServer`:
    each client connection exchanges length-prefixed JSON frames, every
    frame is one ``JobRPC.handle`` dispatch, and all dispatches are
    serialized under the transport's lock (the job server is
    single-threaded by design).  ``port=0`` binds an ephemeral port —
    read ``address`` back and hand it to ``JobServiceClient(address=...)``
    in another process.  Usable as a context manager::

        rpc = JobRPC(server)
        rpc.register("hourly-avg", program)
        with JobSocketServer(rpc) as srv:
            print("serving on", srv.address)
            ...
    """

    def __init__(self, rpc: JobRPC, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        super().__init__(rpc.handle, host=host, port=port)
        self.rpc = rpc


def main(argv=None) -> None:
    """Serve random prompts on an architecture's reduced configuration and
    print tokens/s.  An embeddings architecture is refused with the
    reference's ``SystemExit``: the driver makes token prompts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch)
    if cfg.input_mode == "embeddings":
        raise SystemExit(f"{args.arch} serves embeddings; this driver is for "
                         "token LMs")
    params = init_params(args.seed, cfg, device=args.device)
    server = BatchedServer(cfg, params, args.slots, args.max_len,
                           device=args.device)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        server.submit(Request(
            id=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                      dtype=np.int32),
            max_new=args.max_new))

    t0 = time.perf_counter()
    steps = tokens = 0
    while any(server.slots) or server.queue:
        n = server.step()
        tokens += n
        steps += 1
        if steps > 10_000:
            raise RuntimeError("serving did not drain")
    dt = time.perf_counter() - t0
    print(f"[serve] {cfg.name}: {args.requests} requests, {tokens} tokens in "
          f"{dt:.2f}s ({tokens/dt:.1f} tok/s, {steps} batched steps)")


if __name__ == "__main__":
    main()
