"""shard_map_ab.py — chip_smoke phase 21's ``shard_map`` stream in several
checkouts, in turns, on one card.

    python3 tools/shard_map_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (``.`` for
this one, or a ``git archive`` of another commit unpacked into a
directory that ``.gitignore`` lists, such as ``build/``).  Each runs in a
process of its own, in the order given, which puts that checkout's
``src`` first on the path, builds its ``fused_fold`` kernel there (nvcc,
``sm_90a``) and, in a world of one NCCL rank, drives phase 3's
``linear-road-lav`` log (1,000,000 reports) as phase 21 does: the
program under ``backend="shard_map"`` (``n_workers=1``) once to warm up
(NCCL's set-up, the first launches), then ``RUNS`` more times, then once
under the default fused backend, whose sinks each ``shard_map`` run must
equal.  Per checkout it prints one JSON line: each run's records/s and
host wall (``StreamReport``), its micro-batches and fold steps, and the
collectives of each ``shard_map`` run by kind (``chip_smoke._Collectives``).

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

#: timed ``shard_map`` runs after the warm-up
RUNS = 3


def measure(tree: pathlib.Path) -> dict:
    """One checkout's numbers, in this process."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                  # puts ROOT/src on the path
    sys.path.insert(0, str(tree / "src"))    # ... then the checkout's first
    import torch
    from repro_torch.core import MemoryStore, MetadataStore
    from repro_torch.kernels import _build
    from repro_torch.pipeline import RunOptions
    from repro_torch.streaming import write_event_log
    from repro_torch.workloads import linear_road as lr
    src = pathlib.Path(lr.__file__).resolve()
    if tree.resolve() not in src.parents:
        raise RuntimeError(f"imported {src}, not the checkout {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    device = torch.device("cuda")
    _build.build_all(["fused_fold"])
    prefix = "linear-road/reports"
    store = MemoryStore()
    write_event_log(store, prefix, lr.records(*lr.position_reports(
        cs.SEED, **lr.FULL)), segment_records=lr.BATCH_RECORDS)
    opts = lr.build_options(lr.FULL["n_xways"])

    def drive(label: str, **build) -> tuple[dict, dict]:
        """One run of a program built for it (a job id of its own, so
        that no run finds another's windows in the store)."""
        built = lr.lav_pipeline(prefix).build(
            device=device, job_id=f"linear-road-lav-{label}",
            **dict(opts, **build))
        report = built.run(store=store, meta=MetadataStore(),
                           options=RunOptions(overlap=True))
        if report.error is not None:
            raise RuntimeError(f"{built.job_id}: {report.error}")
        sinks = cs._by_window(built.collect_outputs(store))
        return {"records_per_s": report.records_per_sec,
                "wall_s": report.wall_time, "batches": report.batches,
                "folds": report.folds}, sinks

    sharded = {"backend": "shard_map", "n_workers": 1}
    dist = cs._world_of_one(torch)
    runs = []
    try:
        warm, want = drive("warm-up", **sharded)
        for i in range(RUNS):
            with cs._Collectives(dist) as coll:
                run, sinks = drive(f"shard_map-{i}", **sharded)
            if sinks != want:
                raise RuntimeError("a shard_map run's sinks differ")
            runs.append(dict(run, collectives=dict(coll.counts)))
    finally:
        dist.destroy_process_group()
    fused, sinks = drive("fused")
    if sinks != want:
        raise RuntimeError("the shard_map sinks differ from the fused run's")
    return {"tree": str(tree), "warm_up": warm, "shard_map": runs,
            "fused": fused, "windows": len(want)}


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
