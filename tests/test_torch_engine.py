"""The port's execution plans against the reference's ``backend="pallas"``.

``CompiledStreamAggregate`` is driven step by step on the CPU with the
same numpy rows as the reference plan: carries and stats must be
byte-identical after every fold (integer-valued data — exact), and so
must every slot read, slot clear, session cell op and top-k selection.
The carry layout is the reference's flat ``(n_slots * carry_buckets,
channels)`` slab, which is what lets checkpoints move between the two.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.engine import stages as jstages
from repro.engine.plan import (ExecutionPlan as JPlan, KeySpace as JKeys,
                               ReduceSpec as JReduce, WindowSpec as JWindow)

from repro_torch.engine import stages
from repro_torch.engine.plan import (ExecutionPlan, KeySpace, ReduceSpec,
                                     WindowSpec)

W = 4


def _plans(hashed, *, top_k=0, window=(100.0, 25.0), n_slots=8, nb=16,
           host_wire=False, session_gap=0.0):
    def make(P, K, R, Wn):
        ks = K.hashed(nb) if hashed else K.dense(nb)
        rs = R(mode="top_k", k=top_k) if top_k else R()
        if session_gap:
            ws = Wn.session(session_gap, n_slots=n_slots)
        else:
            ws = Wn(window[0], window[1], n_slots,
                    fanout_on_device=not host_wire)
        return P(ks, rs, W, ws)
    jax_plan = make(JPlan, JKeys, JReduce, JWindow).compile(backend="pallas")
    port = make(ExecutionPlan, KeySpace, ReduceSpec, WindowSpec).compile(
        device="cpu")
    return jax_plan, port


def _device_rows(rng, n, fanout, n_slots, keymax):
    last = rng.integers(-2 * n_slots, 3 * n_slots, n)
    nw = rng.integers(1, fanout + 1, n)
    keys = rng.integers(0, keymax, n)
    vals = rng.integers(0, 100, n)
    valid = rng.random(n) > 0.1
    return np.stack([last, nw, keys, vals, valid], axis=1).astype(np.float32)


def _host_rows(rng, n, n_slots, keymax):
    return np.stack([rng.integers(0, n_slots, n), rng.integers(0, keymax, n),
                     rng.integers(0, 100, n), rng.random(n) > 0.1],
                    axis=1).astype(np.float32)


def _same(jax_arr, t: torch.Tensor) -> bool:
    return np.array_equal(np.asarray(jax_arr), t.numpy())


@pytest.mark.parametrize("hashed", [False, True], ids=["dense", "hashed"])
def test_step_parity_slot_ops_and_top_k(hashed):
    """Three folds (the second and third with donation on the reference
    side — in place on the port's), then every slot read, top-k, a slot
    clear and one more fold: byte-identical at every point."""
    rng = np.random.default_rng(31)
    n_slots, nb = 8, 16
    jp, pp = _plans(hashed, top_k=3)
    keymax = (1 << 20) if hashed else nb
    jc, pc = jp.init_carry(), pp.init_carry()
    assert tuple(jc.shape) == tuple(pc.shape) == (n_slots * nb, 2)
    for donate in (False, True, True):
        rows = _device_rows(rng, 400, 4, n_slots, keymax)
        jc, js = jp.step(rows, jc, 2, donate=donate)
        before = pc
        pc, ps = pp.step(rows, pc, 2)
        assert pc is before                                # in place
        assert _same(js, ps) and _same(jc, pc)
    for slot in range(n_slots):
        assert np.array_equal(jp.read_slot(jc, slot), pp.read_slot(pc, slot))
        for kind in ("sum", "count", "mean"):
            for a, b in zip(jp.top_k_slot(jc, slot, kind),
                            pp.top_k_slot(pc, slot, kind)):
                assert np.array_equal(a, b)
    snap = pp.read_slot(pc, 5)
    jc, pc = jp.clear_slot(jc, 5), pp.clear_slot(pc, 5)
    assert _same(jc, pc) and snap.any()     # the read was a copy, not a view
    rows = _device_rows(rng, 400, 4, n_slots, keymax)
    jc, js = jp.step(rows, jc, -3)
    pc, ps = pp.step(rows, pc, -3)
    assert _same(js, ps) and _same(jc, pc)


def test_host_wire_step_parity():
    rng = np.random.default_rng(37)
    jp, pp = _plans(True, host_wire=True)
    jc, pc = jp.init_carry(), pp.init_carry()
    for _ in range(2):
        rows = _host_rows(rng, 300, 8, 1 << 20)
        jc, js = jp.step(rows, jc)
        pc, ps = pp.step(rows, pc)
        assert _same(js, ps) and _same(jc, pc)


def test_session_cell_ops_parity():
    """Session cells: fold on the host wire, merge two cells of a bucket
    (the bridging event), read and clear — all byte-identical."""
    rng = np.random.default_rng(41)
    jp, pp = _plans(False, session_gap=5.0, n_slots=4, nb=8)
    jc, pc = jp.init_carry(), pp.init_carry()
    rows = _host_rows(rng, 200, 4, 8)
    jc, _ = jp.step(rows, jc)
    pc, _ = pp.step(rows, pc)
    for src, dst, bucket in ((0, 2, 3), (1, 1, 5), (3, 0, 7)):
        jc = jp.merge_cell(jc, src, dst, bucket)
        pc = pp.merge_cell(pc, src, dst, bucket)
        assert _same(jc, pc)
        assert np.array_equal(jp.read_cell(jc, dst, bucket),
                              pp.read_cell(pc, dst, bucket))
    jc, pc = jp.clear_cell(jc, 2, 3), pp.clear_cell(pc, 2, 3)
    assert _same(jc, pc)


def test_top_k_ties_break_toward_lower_bucket():
    """Ties and empty buckets: the stable descending sort gives the order
    of the reference's ``lax.top_k``."""
    agg = np.array([[5, 1], [7, 1], [5, 1], [0, 0], [7, 2], [0, 0],
                    [5, 1], [1, 1]], np.float32)
    for kind in ("sum", "count", "mean"):
        for k in (1, 3, 8):
            want = jstages.top_k_buckets(jnp.asarray(agg), k, kind)
            got = stages.top_k_buckets(torch.from_numpy(agg), k, kind)
            for a, b in zip(want, got):
                assert np.array_equal(np.asarray(a), b.numpy()), (kind, k)


def test_unported_shapes_raise_not_implemented():
    ks, ws = KeySpace.dense(16), WindowSpec(100.0, 25.0, 8)
    with pytest.raises(NotImplementedError, match="group mode"):
        ExecutionPlan(ks, ReduceSpec(mode="group"), W,
                      ws).compile(device="cpu")
    with pytest.raises(NotImplementedError, match="batch plans"):
        ExecutionPlan(ks, ReduceSpec(), W).compile(device="cpu")
    for backend in ("vmap", "shard_map"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ExecutionPlan(ks, ReduceSpec(), W, ws).compile(backend=backend,
                                                           device="cpu")
    compiled = ExecutionPlan(ks, ReduceSpec(), W, ws).compile(device="cpu")
    with pytest.raises(NotImplementedError, match="handoff"):
        compiled.handoff_rows(None, 0, None, 0, 1, "sum", 8)
    with pytest.raises(ValueError, match="map_fn"):
        ExecutionPlan(ks, ReduceSpec(), W, ws).compile(lambda s: s,
                                                       device="cpu")


def test_compile_defaults_to_cuda(monkeypatch):
    """No device given means the card; a host without one raises instead
    of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = ExecutionPlan(KeySpace.dense(16), ReduceSpec(), W,
                         WindowSpec(100.0, 25.0, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan.compile()
    assert plan.compile(device="cpu").init_carry().device.type == "cpu"
