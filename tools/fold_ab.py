"""fold_ab.py — the fused fold's numbers in several checkouts, in turns, on
one card.

    python3 tools/fold_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (``.`` for
this one, or a ``git archive`` of another commit unpacked into a
directory that ``.gitignore`` lists, such as ``build/``).  Each runs in a
process of its own, in the order given, which puts that checkout's
``src`` first on the path, builds its ``fused_fold`` kernel there (nvcc,
``sm_90a``) and measures it with the helpers of the ``chip_smoke.py``
beside this script, calling the fold as that checkout's main path calls
it (``make_fold_step``'s step, or the one-off ``fold`` where a checkout
has no ``make_fold_step``).  Per checkout it prints one JSON line:

* ``main``: one 65,536-record ``linear-road-lav`` micro-batch into the
  (80,000, 2) carry, as chip_smoke phase 2 — the wrapper's ms a call (CUDA
  events), host us a call (``perf_counter`` over 1,000 calls, then one
  synchronize), device us and device records a fold (torch.profiler),
  plain ms, the bound and one ``index_add_`` call's ms;
* ``host_split`` (checkouts with ``make_fold_step``): the host us a call
  of the step's parts alone, each over 1,000 calls — ``empty``, the
  ``torch.empty`` of the stats; ``stream``, reading the current stream;
  ``launch``, the ctypes call of ``fused_fold_launch`` with the same
  arguments (the C entry and the cooperative launch); the rest of
  ``host_us`` is the step's Python (argument checks, ``data_ptr``);
* ``large``: phase 2's large shape (2**22 device-wire rows, fan-out 5,
  8 slots x 2**20 buckets, a 64 MiB carry) for sum, count, min and max —
  ms, device us and device records a fold.

The card's name and power limit (``nvidia-smi``) come first.  Every
process needs the card; without one the script exits non-zero.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def measure(tree: pathlib.Path) -> dict:
    """One checkout's numbers, in this process."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                  # puts ROOT/src on the path
    sys.path.insert(0, str(tree / "src"))    # ... then the checkout's first
    import numpy as np
    import torch
    from repro_torch.kernels.fused_fold import ops
    from repro_torch.kernels.fused_fold.ref import fused_streaming_fold_ref
    from repro_torch.workloads import linear_road as lr
    src = pathlib.Path(ops.__file__).resolve()
    if tree.resolve() not in src.parents:
        raise RuntimeError(f"imported {src}, not the checkout {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    device = torch.device("cuda")
    ref = fused_streaming_fold_ref

    rows, carry, nb = cs.lr_batch(torch, lr, device)
    kw = dict(fanout=cs.FANOUT, n_slots=lr.N_SLOTS, num_buckets=nb,
              carry_buckets=nb, channel_base=0, hashed=False,
              host_wire=False, kind="sum")
    main = cs.fold_times(torch, ops, ref, rows, carry, -(2 ** 31), kw,
                         host_calls=cs.HOST_CALLS)
    split = host_split(torch, ops, rows, carry, kw) \
        if hasattr(ops, "make_fold_step") else None
    large = {}
    rng = np.random.default_rng(cs.SEED)
    for kind in ("sum", "count", "min", "max"):
        big = torch.from_numpy(cs._wire_rows(
            rng, cs.BIG_N, host_wire=False, keymax=cs.BIG_BUCKETS)).to(device)
        carry0 = torch.from_numpy(cs._carry(
            rng, cs.N_SLOTS * cs.BIG_BUCKETS, 2, kind)).to(device)
        kw = dict(fanout=cs.FANOUT, n_slots=cs.N_SLOTS,
                  num_buckets=cs.BIG_BUCKETS, carry_buckets=cs.BIG_BUCKETS,
                  channel_base=0, hashed=False, host_wire=False, kind=kind)
        t = cs.fold_times(torch, ops, ref, big, carry0, 2, kw)
        large[kind] = {k: t[k] for k in ("ms", "device_us",
                                         "device_ops_per_fold", "route",
                                         "library_ms", "bound_ms")}
        del big, carry0
        torch.cuda.empty_cache()
    return {"tree": str(tree), "source": str(src.parent),
            "main": main, "host_split": split, "large": large}


def host_split(torch, ops, rows, carry, kw) -> dict:
    """Host us a call of the step's parts alone (see the module's
    docstring)."""
    import ctypes

    import chip_smoke as cs
    device = carry.device
    step = ops.make_fold_step(**kw, device=device)
    step(rows, carry, 0)                              # binds the geometry
    stats = torch.empty(3, dtype=torch.int32, device=device)
    lib = ops.library()
    index = torch.cuda.current_device()
    raw = torch._C._cuda_getCurrentRawStream
    args = (ctypes.addressof(step.geometry), rows.data_ptr(), rows.shape[0],
            carry.data_ptr(), carry.shape[1], stats.data_ptr(), None, 0,
            raw(index))

    def launch():
        if lib.fused_fold_launch(*args) != 0:
            raise RuntimeError("fused_fold_launch failed")

    calls = cs.HOST_CALLS
    return {"empty": 1e3 * cs._host_ms(torch, lambda: torch.empty(
                3, dtype=torch.int32, device=device), calls),
            "stream": 1e3 * cs._host_ms(torch, lambda: raw(index), calls),
            "launch": 1e3 * cs._host_ms(torch, launch, calls)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(pathlib.Path(argv[1]).resolve())))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
