"""The multi-tenant job service under the ``shard_map`` backend over real
ranks (gloo on the CPU, 2 and 4 processes) against the reference's
``JobServer`` with the same programs under ``backend="vmap"``.

Each rank runs its own ``JobServer`` over one shared ``FileStore`` and its
own ``MetadataStore``, with the same tenants and submissions; the
decisions that issue or skip a collective (park, the ingest's tail, the
quota's verdict, a store error) are agreed across the ranks, and the
registry has one writer, rank 0.  Every world runs under its own timeout
(``_torch_ranks.spawn``); values are integers, so every float32 fold is
exact in any order and the sinks compare byte for byte.  A file of its own
beside ``test_torch_shard_map_join.py``, so that ``--dist loadfile``
spreads the spawned worlds over the test workers.
"""

import os
from types import SimpleNamespace

import pytest

import repro.core as jcore
import repro.core.autoscaler as jautoscaler
import repro.pipeline as jpipeline
import repro.service as jservice
import repro.streaming as jstreaming

from repro_torch.core import FileStore

import _torch_ranks as ranks

#: seconds a world may take, spawn and imports included
TIMEOUT = 110.0

JAX = SimpleNamespace(JobServer=jservice.JobServer,
                      ParkPolicy=jservice.ParkPolicy,
                      Pipeline=jpipeline.Pipeline,
                      Windowing=jpipeline.Windowing)


def _reference(scenario, world):
    """The scenario through the reference's ``JobServer`` in one process,
    its programs under ``backend="vmap"``."""
    def write(store, events):
        jstreaming.write_event_log(store, "gps/", events, segment_records=64)
    return scenario(JAX, jcore.MemoryStore(), jcore.MetadataStore(), world,
                    write, backend="vmap")


@pytest.mark.parametrize("world", [2, 4])
def test_shard_map_service_matches_reference(world, tmp_path):
    """Three tenants (mean, count and a group-mode max) on one shared
    ingest: every job PARKED once the first part drains, cold-restored by
    the appends, DONE at the end; each tenant's sink on the shared store
    equals the reference's; every rank holds one registry record a job,
    equal to the reference's apart from host times and to rank 0's with
    them (rank 0 writes the registry), and materialized the log once."""
    outs = ranks.spawn(ranks.service_body, world, tmp_path, "service",
                       timeout=TIMEOUT)
    want = _reference(ranks.service_scenario, world)
    assert set(want["parked"].values()) == {"PARKED"}
    assert set(want["states"].values()) == {"DONE"}
    assert all(want["sinks"].values())
    assert all(r["restores"] >= 1 for r in want["records"].values())
    store = FileStore(os.path.join(tmp_path, "store"))
    for name, _agg in ranks.SERVICE_TENANTS:
        jid = f"svc-{name}"
        assert ranks._sink(store, name, jid) == want["sinks"][jid]
    for out in outs:
        for key in ("parked", "states", "records", "index", "ingest"):
            assert out[key] == want[key], key
        assert out["index"] == sorted(want["sinks"])
        assert out["records_with_times"] == outs[0]["records_with_times"]


def test_shard_map_service_quota_fails_one_job_at_one_batch(tmp_path):
    """A tenant over its pool-time quota and one over its byte quota (only
    rank 0 writes, so only rank 0's view sees the refusal) each fail at the
    same batch on every rank, with the reference's error and cursor, while
    their neighbour finishes with the reference's sink."""
    outs = ranks.spawn(ranks.service_body, 2, tmp_path, "quota",
                       timeout=TIMEOUT)
    want = _reference(ranks.quota_scenario, 2)
    assert want["states"] == {"q-rich": "DONE", "q-broke": "FAILED",
                              "q-cheap": "FAILED"}
    assert {jid: f[0] for jid, f in want["failed"].items()} == {
        "q-broke": "ComputeQuotaExceeded", "q-cheap": "QuotaExceeded"}
    assert want["sink"]
    for out in outs:
        assert out["states"] == want["states"]
        assert out["failed"] == want["failed"]
    assert outs[0]["sink"] == want["sink"]


def test_shard_map_service_quota_sums_every_rank_meter(tmp_path,
                                                      monkeypatch):
    """Rank 1's meter bills twice rank 0's seconds a fold, so rank 1 alone
    would cross the pool-time quota at another batch than the summed bill,
    and rank 0 alone not at all: every rank fails the job at the batch at
    which the two meters summed cross it (the reference's ``JobServer``
    with one meter billing their sum a fold), and its neighbour finishes
    with the reference's sink."""
    outs = ranks.spawn(ranks.service_body, 2, tmp_path, "meter",
                       timeout=TIMEOUT)
    bills = {}
    for label, bill in (("summed", sum(ranks.METER_BILLS)),
                        ("rank 1 alone", ranks.METER_BILLS[1])):
        monkeypatch.setattr(jautoscaler.MeteredPool, "submit",
                            ranks.billed_submit(bill))
        bills[label] = _reference(ranks.meter_scenario, 2)
    want = bills["summed"]
    assert want["states"] == {"m-free": "DONE", "m-metered": "FAILED"}
    assert want["failed"]["m-metered"][0] == "ComputeQuotaExceeded"
    assert bills["rank 1 alone"]["failed"]["m-metered"][1:] != \
        want["failed"]["m-metered"][1:]
    assert want["sink"]
    for out in outs:
        assert out["states"] == want["states"]
        assert out["failed"] == want["failed"]
    assert outs[0]["sink"] == want["sink"]


def test_shard_map_service_crash_resume_exactly_once(tmp_path):
    """Every rank's server crashes mid-drive; a fresh server on each rank
    re-attaches the jobs with ``resume=True`` (one registry record a job)
    and finishes: the sinks equal the reference's uncrashed service, rank
    0 wrote each window once, and no other rank wrote."""
    outs = ranks.spawn(ranks.service_crash_body, 2, tmp_path, "svc-bob", 2,
                       timeout=TIMEOUT)
    want = _reference(ranks.service_scenario, 2)
    store = FileStore(os.path.join(tmp_path, "store"))
    for out in outs:
        assert out["crashed"]
        assert set(out["states"].values()) == {"DONE"}
        assert out["index"] == sorted(want["sinks"])
    for name, _agg in ranks.SERVICE_TENANTS:
        jid = f"svc-{name}"
        sink = ranks._sink(store, name, jid)
        assert sink == want["sinks"][jid]
        assert all(outs[0]["puts"][f"tenants/{name}/{key}"] == 1
                   for key in sink)
    assert not outs[1]["puts"]
