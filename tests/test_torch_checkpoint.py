"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the reference's own cases (round
trip, elastic shard counts, CRC, the manifest as commit point, the async
writer's garbage collection) run through the port, and checkpoints move
between the packages — a float32 ``TrainState`` written by either
restores in the other bit for bit, bfloat16 leaves go reference → port
bit for bit and port → reference as equal raw bytes.  The layout is
compared directly too: object keys, manifest fields, npz member names
and each member's bytes.  Exact equality throughout: checkpoints copy
bytes, they compute nothing.
"""

import io
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.core.storage import MemoryStore as RefMemoryStore
from repro.optim import AdamW as RefAdamW
from repro.runtime.train_step import init_train_state as ref_init_state

from repro_torch import configs
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint,
                                    snapshot)
from repro_torch.core.storage import MemoryStore
from repro_torch.models.convert import train_state_from_reference
from repro_torch.optim import AdamW
from repro_torch.optim.tree import tree_leaves
from repro_torch.runtime import init_train_state


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((64, 32), generator=g),
            "b": torch.zeros((32,)),
            "nested": {"emb": torch.randn((100, 16), generator=g),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_roundtrip():
    store = MemoryStore()
    tree = _tree()
    save_checkpoint(store, "ckpt", 10, tree, n_shards=4)
    restored, step = restore_checkpoint(store, "ckpt", tree)
    assert step == 10
    _equal_trees(tree, restored)


@pytest.mark.parametrize("n_shards", [1, 3, 7, 8])
def test_checkpoint_elastic_shard_counts(n_shards):
    """Written by N workers, restored regardless of N — the re-mesh path
    (``emb``'s 100 rows split at ``np.linspace`` bounds, ``b``'s 32 too
    when N <= 32, scalars whole in shard 0)."""
    store = MemoryStore()
    tree = _tree(1)
    manifest = save_checkpoint(store, "ckpt", 5, tree, n_shards=n_shards)
    assert len(manifest["crc32"]) == n_shards
    restored, _ = restore_checkpoint(store, "ckpt", tree)
    _equal_trees(tree, restored)


def test_checkpoint_crc_detects_corruption():
    store = MemoryStore()
    save_checkpoint(store, "ckpt", 1, _tree(), n_shards=2)
    key = [m.key for m in store.list_objects("ckpt/")
           if "shard-0" in m.key][0]
    store.put(key, b"corrupted bytes")
    with pytest.raises(IOError):
        restore_checkpoint(store, "ckpt", _tree())


def test_latest_step_and_manifest_commit_point():
    store = MemoryStore()
    save_checkpoint(store, "ckpt", 10, _tree())
    save_checkpoint(store, "ckpt", 20, _tree())
    assert latest_step(store, "ckpt") == 20
    # delete a manifest → that step is invisible (commit-point semantics)
    store.delete("ckpt/step-00000020/MANIFEST.json")
    assert latest_step(store, "ckpt") == 10
    assert latest_step(MemoryStore(), "ckpt") is None


def test_restore_validates_leaves_and_shapes():
    store = MemoryStore()
    save_checkpoint(store, "ckpt", 1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(store, "ckpt", {"w": torch.zeros(64, 32)})
    bad = _tree()
    bad["w"] = torch.zeros(64, 31)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(store, "ckpt", bad)


def test_async_checkpointer():
    store = MemoryStore()
    ck = AsyncCheckpointer(store, "ckpt", n_shards=2, keep=2)
    for s in (1, 2, 3):
        ck.save(s, _tree(s))
    ck.wait()
    assert latest_step(store, "ckpt") == 3
    # GC keeps only `keep` checkpoints
    steps = {int(m.key.split("step-")[1][:8])
             for m in store.list_objects("ckpt/") if "step-" in m.key}
    assert steps == {2, 3}
    restored, _ = restore_checkpoint(store, "ckpt", _tree())
    _equal_trees(_tree(3), restored)
    ck.close()


def test_async_checkpointer_records_timings_and_closes():
    store = MemoryStore()
    ck = AsyncCheckpointer(store, "ckpt", n_shards=2)
    ck.save(1, _tree(1))
    ck.save(2, _tree(2))
    ck.wait()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(_tree()))
    assert [t["step"] for t in ck.timings] == [1, 2]
    for t in ck.timings:
        assert t["bytes"] == nbytes
        assert t["snapshot_s"] >= 0 and t["write_s"] >= 0
    ck.close()
    ck._thread.join(timeout=10)
    assert not ck._thread.is_alive()


def test_async_snapshot_is_taken_at_save():
    """``save`` copies the leaves before it returns: a later change of
    the caller's tensors does not reach the checkpoint."""
    store = MemoryStore()
    ck = AsyncCheckpointer(store, "ckpt", n_shards=2)
    tree = _tree(4)
    ck.save(1, tree)
    tree["w"].add_(1.0)
    ck.wait()
    restored, _ = restore_checkpoint(store, "ckpt", _tree(4))
    _equal_trees(_tree(4), restored)


# -- between the packages -----------------------------------------------------

ARCH = "gemma2-9b"


def _states(dtype):
    """The reference's initial TrainState of the reduced arch in
    ``dtype``, and the port's, handed over (the same values)."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    ref_cfg = ref_configs.get_reduced(ARCH).replace(**kw)
    cfg = configs.get_reduced(ARCH).replace(**kw)
    ref_state = ref_init_state(jax.random.PRNGKey(3), ref_cfg,
                               RefAdamW(lr=1e-3))
    # one step's worth of non-zero moments, count and step
    ref_state = ref_state._replace(
        opt_state=ref_state.opt_state._replace(
            m=jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5,
                           ref_state.params),
            v=jax.tree.map(lambda p: jnp.square(p.astype(jnp.float32)),
                           ref_state.params),
            count=jnp.int32(3)),
        step=jnp.int32(3))
    ref_np = jax.device_get(ref_state)
    return ref_np, train_state_from_reference(ref_np, cfg, device="cpu"), cfg


def _raw(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a).tobytes()


def _bits(t: torch.Tensor) -> bytes:
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return raw.contiguous().numpy().tobytes()


def _ref_leaves_equal_port(ref_tree, port_tree, *, raw_bf16=False):
    """Every leaf of the reference's tree equal to the port's in the
    reference's order (the port's layer list stacked)."""
    want = jax.tree.leaves(ref_tree)
    got = snapshot(port_tree)
    assert len(want) == len(got.arrays)
    for w, g, name in zip(want, got.arrays, got.dtypes):
        w = np.asarray(w)
        assert w.shape == g.shape
        if name == "bfloat16" and raw_bf16:
            assert w.dtype == np.dtype("V2")   # no ml_dtypes type on load
        else:
            assert str(w.dtype) == name
        assert _raw(w) == _raw(g)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_float32_train_state_reference_to_port(n_shards):
    ref_np, state, _ = _states("float32")
    store = RefMemoryStore()
    ref_save(store, "ckpt", 3, ref_np, n_shards=n_shards)
    target = init_train_state(0, configs.get_reduced(ARCH), AdamW(),
                              device="cpu")
    restored, step = restore_checkpoint(store, "ckpt", target)
    assert step == 3
    _equal_trees(state, restored)
    assert isinstance(restored.params["layers"], list)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_float32_train_state_port_to_reference(n_shards):
    ref_np, state, _ = _states("float32")
    store = MemoryStore()
    save_checkpoint(store, "ckpt", 3, state, n_shards=n_shards)
    restored, step = ref_restore(store, "ckpt", ref_np)
    assert step == 3
    for a, b in zip(jax.tree.leaves(ref_np), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bfloat16_reference_to_port_bit_for_bit():
    ref_np, state, cfg = _states("bfloat16")
    store = RefMemoryStore()
    ref_save(store, "ckpt", 3, ref_np, n_shards=4)
    target = init_train_state(0, cfg, AdamW(), device="cpu")
    restored, _ = restore_checkpoint(store, "ckpt", target)
    assert restored.params["embed"].dtype == torch.bfloat16
    assert restored.opt_state.m["embed"].dtype == torch.float32
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def test_bfloat16_port_to_reference_as_raw_bytes():
    """The reference reads the port's bfloat16 leaves back as the 2-byte
    records it reads its own as (``V2``: numpy has no bfloat16 of its
    own), with the same raw bytes."""
    ref_np, state, _ = _states("bfloat16")
    store = MemoryStore()
    save_checkpoint(store, "ckpt", 3, state, n_shards=4)
    restored, _ = ref_restore(store, "ckpt", ref_np)
    _ref_leaves_equal_port(restored, state, raw_bf16=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layout_equals_the_reference(dtype):
    """The same state written by both packages: the same object keys, the
    same manifest (but for the CRCs, which cover the zip members' time
    stamps, and the structure's text), the same npz member names, and
    each member's bytes equal — but for a bfloat16 member's header, whose
    ``descr`` is ``'|V2'`` (numpy's 2-byte record) where the reference's
    ``ml_dtypes`` array writes ``'<V2'``, the only byte that differs."""
    ref_np, state, _ = _states(dtype)
    ref_store, store = RefMemoryStore(), MemoryStore()
    ref_save(ref_store, "ckpt", 3, ref_np, n_shards=4)
    save_checkpoint(store, "ckpt", 3, state, n_shards=4)
    keys = sorted(m.key for m in store.list_objects("ckpt/"))
    assert keys == sorted(m.key for m in ref_store.list_objects("ckpt/"))
    mine = json.loads(store.get("ckpt/step-00000003/MANIFEST.json"))
    theirs = json.loads(ref_store.get("ckpt/step-00000003/MANIFEST.json"))
    assert set(mine) == set(theirs)
    for field in ("step", "n_shards", "leaves"):
        assert mine[field] == theirs[field]
    for key in keys:
        if key.endswith("MANIFEST.json"):
            continue
        za = zipfile.ZipFile(io.BytesIO(store.get(key)))
        zb = zipfile.ZipFile(io.BytesIO(ref_store.get(key)))
        assert za.namelist() == zb.namelist()
        for name in za.namelist():
            mine_m, theirs_m = za.read(name), zb.read(name)
            if mine_m != theirs_m:             # a bfloat16 leaf
                assert dtype == "bfloat16"
                assert b"'descr': '|V2'" in mine_m[:128]
                assert mine_m.replace(b"'|V2'", b"'<V2'", 1) == theirs_m
