"""The port's windowed joins against the reference.

A join lowers to two plans over one shared carry: the left side folds
into channels [0, 2) and the right into [2, 4) of a ``(n_slots *
carry_buckets, 4)`` slab, where ``carry_buckets`` is the larger side's
key space when ``build(num_buckets=(left, right))`` sizes them apart.
The same seeded events go through ``repro`` (JAX on the CPU, its default
``backend="vmap"``, or ``"pallas"`` in interpret mode) and ``repro_torch``
(``device="cpu"``, the fold's plain PyTorch version); the sinks must be
equal byte for byte.  Values are integers, so every float32 fold is exact
in any order; a mean is formed once at emission, from the same float32
sum and count in both packages, so no tolerance is needed.

Ported from the join cases of ``tests/test_pipeline_api.py``,
``tests/test_dag_fanout.py`` (joins over multi-stage inputs),
``tests/test_async_runtime.py`` (a join pair and ``JoinSource``) and
``tests/test_pallas_backend.py`` (the shared carry); plus the side plans'
folds against the reference's plans, and a join checkpoint that restores
across the packages in both directions.
"""

import json
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from _torch_pkgs import (JAX, PALLAS, PORT, W, Boom, CountingStore,
                         crashing, decoded, error_message, events, json_meta,
                         streamed)
from repro.engine.plan import ExecutionPlan as JExecutionPlan
from repro.engine.plan import KeySpace as JKeySpace
from repro.engine.plan import ReduceSpec as JReduceSpec
from repro.engine.plan import WindowSpec as JWindowSpec
from repro_torch.engine.plan import ExecutionPlan, KeySpace, ReduceSpec, \
    WindowSpec
from repro_torch.kernels.fused_fold import ops


def _join(pk, left_ev, right_ev, *, lagg="sum", ragg="count", size=25.0,
          batch_records=100, sink=None):
    P, Wn = pk.Pipeline, pk.Windowing
    left = (P.from_source(records=left_ev, batch_records=batch_records)
            .key_by().window(Wn.tumbling(size)).reduce(lagg))
    right = (P.from_source(records=right_ev, batch_records=batch_records)
             .key_by().window(Wn.tumbling(size)).reduce(ragg))
    joined = left.join(right)
    return joined.sink(sink) if sink else joined


def _parity(make, build, *, jax=JAX):
    """Reference streamed vs the port streamed and in batch: equal bytes.
    Returns ``(reference sinks, port program)``."""
    ref = streamed(jax, make(jax).build(**build, **jax.build))
    assert ref
    built = make(PORT).build(**build, **PORT.build)
    assert streamed(PORT, built) == ref
    batched, report = built.run_batch(PORT.Store())
    assert batched == ref and report.error is None
    return ref, built


def test_windowed_join_parity_and_oracle():
    """Sum ⋈ count per key per 25 s: equal to the reference's bytes in
    both modes and to a host oracle (an inner join)."""
    left_ev = events(n=800, n_keys=6, span=100.0, seed=12)
    right_ev = events(n=500, n_keys=6, span=100.0, seed=13)
    ref, built = _parity(lambda pk: _join(pk, left_ev, right_ev),
                         dict(num_buckets=12, n_workers=W, job_id="join"))
    assert built.is_join and built.stages[0].sides[1].channel_base == 2
    assert tuple(built.stages[0].sides[0].compiled.init_carry().shape) == \
        (8 * 12, 4)
    lsum = defaultdict(lambda: defaultdict(float))
    rcnt = defaultdict(lambda: defaultdict(int))
    for ts, k, v in left_ev:
        lsum[int(ts // 25.0)][k] += v
    for ts, k, _v in right_ev:
        rcnt[int(ts // 25.0)][k] += 1
    got = {k.split("@")[0]: v for k, v in decoded(ref).items()}
    for widx in lsum:
        rows = dict(got[f"window-{widx * 25.0:.3f}-{(widx + 1) * 25.0:.3f}"])
        assert rows == {k: [lsum[widx][k], rcnt[widx][k]]
                        for k in lsum[widx] if rcnt[widx].get(k)}


def test_join_means_and_hashed_keys():
    """Mean ⋈ mean (each quotient formed once, at emission) over a dense
    and a hashed key space: the reference's bytes."""
    left_ev = events(n=700, n_keys=9, span=120.0, seed=14, vmax=40)
    right_ev = events(n=600, n_keys=9, span=120.0, seed=15, vmax=40)
    for key_space in ("dense", "hashed"):
        _parity(lambda pk: _join(pk, left_ev, right_ev, lagg="mean",
                                 ragg="mean", size=20.0),
                dict(num_buckets=16, n_workers=W, key_space=key_space,
                     job_id=f"jmean-{key_space}"))


def test_join_per_side_num_buckets_parity_and_oracle():
    """``num_buckets=(left, right)``: the symmetric pair equals the int,
    the asymmetric build widens the carry to the larger side and gives
    the same joined content, in both modes — all equal to the
    reference's."""
    left_ev = events(n=600, n_keys=4, span=100.0, seed=14)
    right_ev = events(n=900, n_keys=20, span=100.0, seed=15)

    def make(pk):
        return _join(pk, left_ev, right_ev)

    sym_t, _ = _parity(make, dict(num_buckets=(20, 20), n_workers=W,
                                  job_id="jsym"))
    sym_i, _ = _parity(make, dict(num_buckets=20, n_workers=W,
                                  job_id="jsym"))
    assert sym_t == sym_i
    asym_ref, asym = _parity(make, dict(num_buckets=(4, 20), n_workers=W,
                                        job_id="jasym"))
    assert [s.num_buckets for s in asym.sides] == [4, 20]
    assert asym.num_buckets == 20
    left_plan = asym.sides[0].compiled
    assert left_plan.plan.carry_buckets == 20
    assert left_plan.plan.key_space.num_buckets == 4
    strip = lambda outs: {k.rsplit("/", 1)[1]: v for k, v in outs.items()}
    assert strip(asym_ref) == strip(sym_i)


@pytest.mark.cuda
def test_join_per_side_num_buckets_on_the_card(cuda_device):
    """On the card: the asymmetric join folds its narrower side into the
    wider shared carry (``carry_buckets != num_buckets``) through the
    kernel, and its sinks equal the ``device="cpu"`` build's byte for
    byte, in both modes."""
    left_ev = events(n=600, n_keys=4, span=100.0, seed=14)
    right_ev = events(n=900, n_keys=20, span=100.0, seed=15)
    build = dict(num_buckets=(4, 20), n_workers=W, job_id="jasym")
    plain = _join(PORT, left_ev, right_ev).build(**build, **PORT.build)
    card = _join(PORT, left_ev, right_ev).build(**build, device="cuda")
    left = card.sides[0].compiled.plan
    assert (left.key_space.num_buckets, left.carry_buckets) == (4, 20)
    want = streamed(PORT, plain)
    assert want
    before = ops.fold.launches
    assert streamed(PORT, card) == want
    assert ops.fold.launches > before
    assert card.run_batch(PORT.Store())[0] == want


def test_join_validation():
    """Every join error of the reference, word for word: sides on
    different windows, per-side sizes off a join, hashed asymmetry, a bad
    pair, a session join, a top_k with a join, a right side that goes on
    past its reduce, the host fan-out wire, a group-mode side."""
    one = [(0.0, "a", 1.0)]

    def cases(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        kw = dict(n_workers=W, **pk.build)
        left = P.from_source(records=one).window(10.0).reduce("sum")
        right = P.from_source(records=one).window(10.0).reduce("count")
        other = P.from_source(records=one).window(20.0).reduce("sum")
        sess = (P.from_source(records=one).window(Wn.session(5.0))
                .reduce("sum"))
        return [
            lambda: left.join(other).build(num_buckets=16, **kw),
            lambda: left.build(num_buckets=(8, 16), **kw),
            lambda: left.join(right).build(num_buckets=(8, 16),
                                           key_space="hashed", **kw),
            lambda: left.join(right).build(num_buckets=(8, 16, 32), **kw),
            lambda: sess.join(sess).build(num_buckets=16, **kw),
            lambda: left.top_k(1).join(right).build(num_buckets=16, **kw),
            lambda: left.join(right.sink("r/")).build(num_buckets=16, **kw),
            lambda: left.join(right).build(num_buckets=16, fanout="host",
                                           **kw),
            lambda: left.join(P.from_source(records=one).window(10.0)
                              .reduce("max", mode="group", capacity=4)
                              ).build(num_buckets=16, **kw),
        ]

    matches = ("share one window", "only applies to joins", "hashed joins",
               "pair", "session windows cannot join", "top_k and join",
               "ends at its reduce", "fanout='device'", "aggregate mode")
    for want, got, match in zip(map(error_message, cases(JAX)),
                                map(error_message, cases(PORT)), matches):
        assert want is not None and got == want and match in got, (match,
                                                                    got)


def test_join_on_key_extractor():
    """``join(on=...)`` overrides both sides' keys."""
    def make(pk):
        P = pk.Pipeline
        lp = (P.from_source(records=[(1.0, ("user", 7), 5.0)]).window(10.0)
              .reduce("sum"))
        rp = (P.from_source(records=[(2.0, ("user", 7), 1.0)]).window(10.0)
              .reduce("count"))
        return lp.join(rp, on=lambda r: r[1][1]).build(
            num_buckets=8, n_workers=W, job_id="jon", **pk.build)

    outs, _ = make(PORT).run_batch(PORT.Store())
    ref, _ = make(JAX).run_batch(JAX.Store())
    assert outs == ref
    assert {k.split("@")[0]: v for k, v in decoded(outs).items()} == \
        {"window-0.000-10.000": [["7", [5.0, 1]]]}


# ---------------------------------------------------------------------------
# Joins over multi-stage inputs (tests/test_dag_fanout.py)
# ---------------------------------------------------------------------------

def _two_phase(pk, records, w1, w2, agg1, agg2, batch_records=100):
    Wn = pk.Windowing
    return (pk.Pipeline.from_source(records=records,
                                    batch_records=batch_records)
            .key_by().window(Wn.tumbling(w1)).reduce(agg1)
            .window(Wn.tumbling(w2)).reduce(agg2))


def test_join_over_two_multistage_inputs():
    """Each side's upstream stage feeds the join through its own device
    edge; both modes equal the reference and a host oracle."""
    left_ev = events(n=900, seed=41)
    right_ev = events(n=700, seed=42)

    def make(pk):
        return _two_phase(pk, left_ev, 5.0, 25.0, "count", "sum").join(
            _two_phase(pk, right_ev, 5.0, 25.0, "sum", "sum"))

    ref, built = _parity(make, dict(num_buckets=12, n_workers=W,
                                    job_id="msj"))
    assert len(built.stages) == 3 and built.stages[2].is_join
    assert {(e.src, e.dst, e.dst_side) for e in built.edges} == \
        {(0, 2, 0), (1, 2, 1)}
    assert all(e.device for e in built.edges)
    assert built.inputs == ((0, 0), (1, 0))

    def rollup(evs, agg1):
        fine = defaultdict(Counter)
        for ts, k, v in evs:
            fine[int(ts // 5.0)][k] += 1 if agg1 == "count" else v
        coarse = defaultdict(Counter)
        for idx, per_key in fine.items():
            for k, x in per_key.items():
                coarse[int(idx * 5.0 // 25.0)][k] += x
        return coarse

    lo, ro = rollup(left_ev, "count"), rollup(right_ev, "sum")
    got = {k.split("@")[0]: v for k, v in decoded(ref).items()}
    for widx in lo:
        rows = dict(got[f"window-{widx * 25.0:.3f}-{(widx + 1) * 25.0:.3f}"])
        assert rows == {k: [float(lo[widx][k]), float(ro[widx][k])]
                        for k in lo[widx] if k in ro[widx]}


def test_join_mixed_single_and_multistage_side():
    """A single-stage side (raw events) against a multi-stage side
    (carry-fed): the join's watermark is the minimum over both inputs, so
    no window is lost — equal to the reference in both modes."""
    left_ev = events(n=800, seed=43)
    right_ev = events(n=600, seed=44)

    def make(pk):
        left = (pk.Pipeline.from_source(records=left_ev, batch_records=100)
                .key_by().window(pk.Windowing.tumbling(25.0)).reduce("sum"))
        return left.join(_two_phase(pk, right_ev, 5.0, 25.0, "count",
                                    "sum"))

    _, built = _parity(make, dict(num_buckets=12, n_workers=W,
                                  job_id="mixj"))
    assert len(built.stages) == 2
    assert built.inputs == ((1, 0), (0, 0))         # left lands in the join


# ---------------------------------------------------------------------------
# Running a join (tests/test_async_runtime.py, tests/test_pallas_backend.py)
# ---------------------------------------------------------------------------

def test_run_accepts_join_pair_and_join_source():
    """A pair of record lists runs as one batch; a ``JoinSource`` streams;
    both equal the reference's."""
    left, right = events(n=400, seed=57), events(n=400, seed=58)

    def build(pk):
        P = pk.Pipeline
        return (P.from_source(records=left, batch_records=100)
                .key_by().window(20.0).reduce("sum")
                .join(P.from_source(records=right, batch_records=100)
                      .key_by().window(20.0).reduce("sum"))
                .sink("async-join/")
                .build(num_buckets=8, n_workers=W, job_id="async-join",
                       **pk.build))

    outs = {}
    for pk in (JAX, PORT):
        built = build(pk)
        pair, _report = built.run((left, right))
        store = pk.Store()
        merged = pk.JoinSource(pk.Source.from_records(left, batch_records=100),
                               pk.Source.from_records(right,
                                                      batch_records=100),
                               batch_records=100)
        built.run(merged, store=store)
        assert pair and sorted(built.collect_outputs(store).values()) == \
            sorted(pair.values())
        outs[pk.name] = pair
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("jax", [JAX, PALLAS], ids=["vmap", "pallas"])
def test_join_shared_carry_overlapped(jax):
    """Two joined plans share one carry at disjoint channel bases under
    the overlapped scheduler: the port equals both reference backends."""
    left_ev, right_ev = events(n=800, seed=19), events(n=800, seed=23)

    def run(pk, opts):
        built = _join(pk, left_ev, right_ev, size=20.0,
                      sink="pal-join/").build(num_buckets=8, n_workers=W,
                                              job_id="pal-join", **pk.build)
        store = pk.Store()
        src = pk.JoinSource(
            pk.Source.from_records(left_ev, batch_records=100),
            pk.Source.from_records(right_ev, batch_records=100), 100)
        built.run(src, store=store, options=opts, mode="streaming")
        return built.collect_outputs(store)

    ref = run(jax, JAX.RunOptions(overlap=True))
    assert ref and run(PORT, PORT.RunOptions(overlap=True)) == ref
    assert run(PORT, PORT.RunOptions(**PORT.sync)) == ref


@pytest.mark.parametrize("widths", [(16, 16), (6, 16), (16, 10)],
                         ids=["symmetric", "right-wider", "left-wider"])
def test_side_plans_fold_into_one_carry(widths):
    """The join's two side plans, step by step, against the reference's
    ``backend="pallas"`` plans: each folds its ``[value, 1]`` pair into
    its own channel pair (base 0, then base 2) of one 4-channel carry
    ``max(widths)`` buckets wide, leaves the other pair untouched, and
    reads its window back the same — bit for bit."""
    lb, rb = widths
    cb = max(widths)
    rng = np.random.default_rng(67)
    carries = {}
    for pkg in ("jax", "port"):
        plans = []
        for base, nb in ((0, lb), (2, rb)):
            kw = dict(channels=4, channel_base=base,
                      carry_buckets=0 if nb == cb else cb)
            if pkg == "jax":
                plans.append(JExecutionPlan(
                    JKeySpace.dense(nb), JReduceSpec(**kw), W,
                    JWindowSpec(40.0, 10.0, 6)).compile(backend="pallas"))
            else:
                plans.append(ExecutionPlan(
                    KeySpace.dense(nb), ReduceSpec(**kw), W,
                    WindowSpec(40.0, 10.0, 6)).compile(device="cpu"))
        carries[pkg] = plans
    jl, jr = carries["jax"]
    pl, pr = carries["port"]
    jc, pc = jl.init_carry(), pl.init_carry()
    assert tuple(pc.shape) == tuple(jc.shape) == (6 * cb, 4)
    for step in range(4):
        for side, (jp, pp, nb) in enumerate(((jl, pl, lb), (jr, pr, rb))):
            n = 300
            rows = np.stack([rng.integers(step, step + 4, n),
                             rng.integers(1, 5, n), rng.integers(0, nb, n),
                             rng.integers(0, 50, n), rng.random(n) > 0.1],
                            axis=1).astype(np.float32)
            other = pc[:, 2 - 2 * side:4 - 2 * side].clone()
            jc, js = jp.step(rows, jc, step)
            pc, ps = pp.step(torch.from_numpy(rows), pc, step)
            assert np.array_equal(pc.numpy(), np.asarray(jc))
            assert ps.tolist() == np.asarray(js).tolist()
            assert torch.equal(pc[:, 2 - 2 * side:4 - 2 * side], other)
    for slot in range(6):
        assert np.array_equal(pl.read_slot(pc, slot),
                              jl.read_slot(jnp.asarray(jc), slot))
    assert pc[:, 1].sum() > 0 and pc[:, 3].sum() > 0


# ---------------------------------------------------------------------------
# Join checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,then", [("pallas", "port"),
                                        ("port", "pallas")])
def test_join_checkpoint_restores_across_packages(first, then):
    """A join over a multi-stage right side crashes under one package and
    resumes under the other from the checkpoint — the shared 4-channel
    carry, the upstream stage's carry, the edge's feed watermark and both
    sides' dictionaries: the sinks equal an uncrashed run byte for byte,
    every window written once."""
    left_ev = events(n=600, n_keys=5, seed=71)
    right_ev = events(n=600, n_keys=7, seed=72)
    pkgs = {"pallas": PALLAS, "port": PORT}

    def build(pk):
        P, Wn = pk.Pipeline, pk.Windowing
        left = (P.from_source(batch_records=100).key_by()
                .window(Wn.tumbling(20.0)).reduce("sum"))
        right = (P.from_source(batch_records=100).key_by()
                 .window(Wn.tumbling(5.0)).reduce("count")
                 .window(Wn.tumbling(20.0)).reduce("sum"))
        return left.join(right).sink("xjoin/").build(
            num_buckets=(8, 8), n_workers=W, checkpoint_interval=2,
            job_id="xj", **pk.build)

    def source(pk):
        return pk.JoinSource(pk.Source.from_records(left_ev,
                                                    batch_records=100),
                             pk.Source.from_records(right_ev,
                                                    batch_records=100), 100)

    ref = streamed(PORT, build(PORT), source=source(PORT))
    a, b = pkgs[first], pkgs[then]
    store, meta = CountingStore(), a.Meta()
    dead = crashing(a.Coordinator)(store, meta, program=build(a),
                                   crash_batch=7)
    with pytest.raises(Boom):
        dead.run_stream(source(a), announce=False, flush=False)
    state = meta.get("stream/xj/state")
    assert state["offset"] == 600 and len(state["edge_fed"]) == 1
    assert state["carry_shapes"][1] == [8 * 8, 4]
    meta = json_meta(meta, b.Meta)
    report = build(b).run(source(b), store=store, meta=meta,
                          mode="streaming")
    assert report.error is None
    assert build(PORT).collect_outputs(store) == ref
    for key in ref:
        assert store.put_counts[key] == 1, key
    rows = [json.loads(x) for v in ref.values() for x in v.splitlines()]
    assert rows and all(len(r[1]) == 2 for r in rows)
