"""The port's array (batch) pipelines against the reference's.

The same worker shards, made from a numpy seed, go through the reference
(``repro``, ``backend="vmap"``, with ``combine_fn`` ``None`` — its XLA
combiner — and ``"pallas"`` — its hash_combine kernel in interpret mode)
and the port (``device="cpu"``: the hash_combine wrapper's plain
version), each package with its own UDF.  Values are integers, so float32
sums are exact in any order and every comparison is exact: result shape
and values (``finalize`` on and off), ``sent``/``dropped`` and the
per-bucket collision counts of hashed key spaces.  Then the grammar
errors the reference raises, the run modes, and the device half of
``examples/quickstart.py``.  The CUDA path runs only on a card: its test
carries the ``cuda`` marker and skips here.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.mapreduce import wordcount_map_factory as jwordcount
from repro.data.pipeline import synth_corpus
from repro.engine.plan import KeySpace as JKeySpace
from repro.pipeline import Pipeline as JPipeline

from _torch_cuda import cuda_device  # noqa: F401  (fixture)
from repro_torch.core.mapreduce import wordcount_map_factory
from repro_torch.engine import stages
from repro_torch.engine.plan import ExecutionPlan, KeySpace, ReduceSpec
from repro_torch.kernels.hash_combine import ops
from repro_torch.pipeline import Pipeline, PipelineError, run_batch
from repro_torch.workloads import wordcount

W = 4


# -- UDFs, one per package, the same function --------------------------------

def _jax_rows(s):            # tests/test_pipeline_api.py's (key, value, ok)
    return s[:, 0].astype(jnp.int32), s[:, 1], s[:, 2] > 0


def _torch_rows(s):
    return s[:, 0].to(torch.int32), s[:, 1], s[:, 2] > 0


def _jax_pairs(s):           # tests/test_mapreduce_device.py's _array_job
    return (s[:, 0], s[:, 1].astype(jnp.float32),
            jnp.ones(s.shape[0], bool))


def _torch_pairs(s):
    return (s[:, 0], s[:, 1].to(torch.float32),
            torch.ones(s.shape[0], dtype=torch.bool))


def _jax_wide(s):            # (N, 3) values: [value, 1, key parity]
    v = s[:, 1].astype(jnp.float32)
    return s[:, 0], jnp.stack([v, jnp.ones_like(v),
                               (s[:, 0] % 2).astype(jnp.float32)], -1), \
        s[:, 0] % 3 != 0


def _torch_wide(s):
    v = s[:, 1].to(torch.float32)
    return s[:, 0], torch.stack([v, torch.ones_like(v),
                                 (s[:, 0] % 2).to(torch.float32)], -1), \
        s[:, 0] % 3 != 0


def _jax_shardwise(s):       # not row-wise: ranks within the worker's shard
    return (jnp.argsort(s[:, 0]).astype(jnp.int32) % 7,
            s[:, 1].astype(jnp.float32) - jnp.min(s[:, 1]),
            jnp.ones(s.shape[0], bool))


def _torch_shardwise(s):
    return (torch.argsort(s[:, 0], stable=True).to(torch.int32) % 7,
            s[:, 1].to(torch.float32) - torch.min(s[:, 1]),
            torch.ones(s.shape[0], dtype=torch.bool))


UDFS = {"rows": (_jax_rows, _torch_rows), "pairs": (_jax_pairs, _torch_pairs),
        "wide": (_jax_wide, _torch_wide),
        "shardwise": (_jax_shardwise, _torch_shardwise)}


def _row_shards(seed, n_per=16, n_keys=8):
    """tests/test_pipeline_api.py's float32 (W, n, 3) [key, value, ok]."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((W, n_per, 3), np.float32)
    rows[:, :, 0] = rng.integers(0, n_keys, (W, n_per))
    rows[:, :, 1] = rng.integers(0, 9, (W, n_per))
    rows[:, :, 2] = rng.random((W, n_per)) > 0.2
    return rows


def _pair_shards(seed, n_per=500, n_keys=32, lo=0):
    """tests/test_mapreduce_device.py's int32 (W, n, 2) [key, value]."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(lo, n_keys, (W, n_per), dtype=np.int32)
    vals = rng.integers(1, 5, (W, n_per), dtype=np.int32)
    return np.stack([keys, vals], axis=-1)


def _run_both(udf, shards, *, num_buckets, combine_fn=None, top=None,
              **build):
    """The reference's (vmap) and the port's (CPU) result and stats."""
    judf, tudf = UDFS[udf]
    out = []
    for P, fn, extra in ((JPipeline, judf, dict(backend="vmap",
                                                combine_fn=combine_fn)),
                         (Pipeline, tudf, dict(device="cpu"))):
        p = P.from_source(shards=shards).map(fn).reduce("sum")
        if top is not None:
            p = p.top_k(top)
        built = p.build(num_buckets=num_buckets, n_workers=W, **build,
                        **extra)
        out.append(built.run_batch(data=shards))
    return out


def _assert_same(ref, port):
    """Tensors/arrays (or tuples of them) equal exactly, shape included."""
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref)
        for r, p in zip(ref, port):
            _assert_same(r, p)
        return
    want = np.asarray(ref)
    got = port.cpu().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _assert_stats(ref, port):
    assert int(port.sent) == int(ref.sent)
    assert int(port.dropped) == int(np.asarray(ref.dropped).sum()) == 0
    if ref.bucket_collisions is None:
        assert port.bucket_collisions is None
        assert port.collisions == 0
    else:
        _assert_same(ref.bucket_collisions, port.bucket_collisions)
        assert int(port.collisions) == int(ref.collisions)


CASES = {
    # name: (udf, shard maker, num_buckets, build options)
    "api-rows": ("rows", lambda: _row_shards(9), 8, {}),
    "device-pairs": ("pairs", lambda: _pair_shards(3), 32, {}),
    "buckets-not-multiple-of-W": ("pairs", lambda: _pair_shards(5, n_keys=10),
                                  10, {}),
    "dense-keys-outside-range": ("pairs",
                                 lambda: _pair_shards(6, n_keys=14, lo=-3),
                                 10, {}),
    "wide-values": ("wide", lambda: _pair_shards(7, n_keys=12), 11, {}),
    "udf-not-row-wise": ("shardwise", lambda: _pair_shards(8), 7, {}),
    "hashed-collisions": ("pairs",
                          lambda: _pair_shards(10, n_keys=1 << 20), 13,
                          dict(key_space="hashed")),
    "hashed-masked": ("wide", lambda: _pair_shards(11, n_keys=5000), 37,
                      dict(key_space="hashed")),
}


@pytest.mark.parametrize("finalize", [True, False],
                         ids=["finalize", "per-worker"])
@pytest.mark.parametrize("combine_fn", [None, "pallas"],
                         ids=["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_array_pipeline_matches_reference(case, combine_fn, finalize):
    udf, make, nb, build = CASES[case]
    shards = make()
    (ref, rstats), (got, gstats) = _run_both(
        udf, shards, num_buckets=nb, combine_fn=combine_fn,
        finalize=finalize, **build)
    _assert_same(ref, got)
    _assert_stats(rstats, gstats)
    if "hashed" in case:
        assert int(gstats.collisions) > 0


@pytest.mark.parametrize("case", ["api-rows", "device-pairs",
                                  "hashed-collisions"])
def test_array_top_k_matches_reference(case):
    udf, make, nb, build = CASES[case]
    (ref, rstats), (got, gstats) = _run_both(udf, make(), num_buckets=nb,
                                             top=3, **build)
    _assert_same(tuple(ref), got)
    _assert_stats(rstats, gstats)


def test_top_k_ties_break_toward_the_lower_bucket():
    """Equal counts rank by bucket id, as ``jax.lax.top_k`` orders them;
    empty buckets come back invalid."""
    shards = np.zeros((W, 6, 2), np.int32)
    shards[..., 0] = [[5, 2, 9, 2, 5, 9]] * W
    shards[..., 1] = 1
    (ref, _), (got, _) = _run_both("pairs", shards, num_buckets=12, top=5)
    _assert_same(tuple(ref), got)
    assert got[0].tolist()[:3] == [2, 5, 9]
    assert got[2].tolist() == [True, True, True, False, False]


def test_key_space_instance_passes_through():
    shards = _pair_shards(12, n_keys=1 << 16)
    for track in (True, False):
        out = []
        for P, KS, fn, extra in (
                (JPipeline, JKeySpace, _jax_pairs, dict(backend="vmap")),
                (Pipeline, KeySpace, _torch_pairs, dict(device="cpu"))):
            built = P.from_source(shards=shards).map(fn).reduce("sum").build(
                key_space=KS.hashed(19, track_collisions=track), n_workers=W,
                **extra)
            assert built.num_buckets == 19
            out.append(built.run(shards))
        (ref, rstats), (got, gstats) = out
        _assert_same(ref, got)
        _assert_stats(rstats, gstats)
        assert (gstats.bucket_collisions is not None) == track


def test_run_and_run_batch_agree():
    shards = _row_shards(13)
    built = (Pipeline.from_source(shards=shards).map(_torch_rows)
             .reduce("sum").build(num_buckets=8, n_workers=W, device="cpu"))
    direct, _ = built.run_batch(data=shards)
    via_run, _ = built.run(shards)
    bound, _ = built.run()                 # the graph's bound shards
    pinned, _ = run_batch(built, data=torch.from_numpy(shards))
    for other in (via_run, bound, pinned):
        assert torch.equal(other, direct)
    expected = np.bincount(shards[:, :, 0].astype(int).ravel(),
                           weights=shards[:, :, 1].ravel() * shards[:, :, 2]
                           .ravel(), minlength=8)
    np.testing.assert_array_equal(direct.numpy(), expected)


def test_quickstart_device_half_matches_reference_and_counts():
    """``examples/quickstart.py``'s device engine: the corpus tokenized to
    ids, 8 padded worker shards, word count — equal to the reference and
    to ``Counter`` over the words."""
    corpus = synth_corpus(100_000, vocab_words=2000, seed=0)
    expected = Counter(corpus.split())
    vocab = {w: i for i, w in enumerate(sorted(expected))}
    tok = np.array([vocab[w] for w in corpus.split()], dtype=np.int32)
    n_workers = 8
    n = (len(tok) + n_workers - 1) // n_workers * n_workers
    toks = np.concatenate([tok, np.full(n - len(tok), -1, np.int32)])
    shard = np.stack([toks.reshape(n_workers, -1),
                      np.ones((n_workers, n // n_workers), np.int32)], -1)
    results = []
    for P, factory, extra in ((JPipeline, jwordcount, dict(backend="vmap")),
                              (Pipeline, wordcount_map_factory,
                               dict(device="cpu"))):
        built = (P.from_source(shards=shard).map(factory(len(vocab)))
                 .reduce("sum").build(num_buckets=len(vocab),
                                      n_workers=n_workers, **extra))
        results.append(built.run_batch(data=shard))
    (ref, rstats), (got, gstats) = results
    _assert_same(ref, got)
    _assert_stats(rstats, gstats)
    got = got.numpy()
    for w, c in expected.items():
        assert got[vocab[w]] == c


def test_wordcount_workload_matches_its_oracle():
    cfg = dict(wordcount.FULL, n_tokens=1 << 12)
    shards = wordcount.token_shards(0, **cfg)
    assert shards.shape == (8, 512, 2) and shards.dtype == np.int32
    built = wordcount.pipeline(shards).build(
        num_buckets=wordcount.VOCAB, n_workers=wordcount.N_WORKERS,
        device="cpu")
    got, stats = built.run()
    np.testing.assert_array_equal(got.numpy(), wordcount.oracle(shards))
    assert int(stats.sent) == 1 << 12
    with pytest.raises(ValueError, match="split"):
        wordcount.token_shards(0, n_tokens=1001)


def test_engine_plan_compiles_batch_plans():
    plan = ExecutionPlan(KeySpace.dense(10), ReduceSpec(), n_workers=4)
    assert KeySpace.dense(10).padded(4) == 12
    compiled = plan.compile(_torch_pairs, device="cpu", finalize=False)
    out, stats = compiled.run(_pair_shards(14, n_keys=10))
    assert out.shape == (4, 3) and int(stats.sent) == 2000
    with pytest.raises(ValueError, match="map_fn"):
        plan.compile(device="cpu")
    with pytest.raises(ValueError, match="finalize=False"):
        ExecutionPlan(KeySpace.dense(10), ReduceSpec.top_k(2), 4).compile(
            _torch_pairs, device="cpu", finalize=False)
    with pytest.raises(ValueError, match="exceeds"):
        ExecutionPlan(KeySpace.dense(10), ReduceSpec.top_k(11), 4).compile(
            _torch_pairs, device="cpu")
    with pytest.raises(ValueError, match="worker shards"):
        compiled.run(_pair_shards(14)[:3])


def test_custom_combine_fn_is_called():
    calls = []

    def combine(keys, values, num_buckets, valid):
        calls.append(num_buckets)
        return stages.local_combine_dense(keys, values, num_buckets, valid)

    shards = _pair_shards(15, n_keys=10)
    built = (Pipeline.from_source(shards=shards).map(_torch_pairs)
             .reduce("sum").build(num_buckets=10, n_workers=W, device="cpu",
                                  combine_fn=combine))
    got, _ = built.run()
    assert calls == [12]
    want = np.bincount(shards[..., 0].ravel(), weights=shards[..., 1].ravel(),
                       minlength=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_array_grammar_errors_match_reference():
    shards = _pair_shards(16)
    for P, fn, extra in ((JPipeline, _jax_pairs, dict(backend="vmap")),
                         (Pipeline, _torch_pairs, dict(device="cpu"))):
        src = P.from_source(shards=shards)
        kw = dict(num_buckets=32, n_workers=W, **extra)
        with pytest.raises(PipelineError if P is Pipeline else ValueError,
                           match="exactly one map"):
            src.reduce("sum").build(**kw)
        with pytest.raises(ValueError, match="one-shot"):
            src.map(fn).window(10.0).reduce("sum").build(**kw)
        with pytest.raises(ValueError, match="one-shot"):
            src.map(fn).reduce("sum").map(fn).reduce("sum").build(**kw)
        with pytest.raises(ValueError, match="build-wide options"):
            src.map(fn).reduce("sum", num_buckets=8).build(**kw)
        built = src.map(fn).reduce("sum").build(**kw)
        assert built.is_array
        with pytest.raises(ValueError, match="no streaming mode"):
            built.run(shards, mode="streaming")
    built = (Pipeline.from_source(shards=shards).map(_torch_pairs)
             .reduce("sum").build(num_buckets=32, n_workers=W, device="cpu"))
    from repro_torch.pipeline import RunOptions
    with pytest.raises(ValueError, match="shard="):
        built.run(shards, options=RunOptions(shard=(0, 2)))
    vmapped = (Pipeline.from_source(shards=shards).map(_torch_pairs)
               .reduce("sum").build(num_buckets=32, n_workers=W,
                                    backend="vmap", device="cpu"))
    assert vmapped.backend == "vmap"
    with pytest.raises(ValueError, match="process group"):
        (Pipeline.from_source(shards=shards).map(_torch_pairs).reduce("sum")
         .build(num_buckets=32, backend="shard_map", device="cpu"))
    with pytest.raises(PipelineError, match="combine_fn"):
        (Pipeline.from_source(records=[(0.0, "a", 1.0)]).key_by()
         .window(10.0).reduce("sum").build(device="cpu", combine_fn="pallas"))


# ---------------------------------------------------------------------------
# On the card (skipped on a host without CUDA)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_array_pipeline_matches_cpu(cuda_device):
    shards = _pair_shards(18, n_keys=1 << 20)
    out = {}
    for device in ("cuda", "cpu"):
        before = ops.combine.launches
        built = (Pipeline.from_source(shards=shards).map(_torch_pairs)
                 .reduce("sum").build(num_buckets=64, n_workers=W,
                                      key_space="hashed", device=device))
        got, stats = built.run()
        out[device] = (got.cpu(), stats.bucket_collisions.cpu())
        assert ops.combine.launches == before + (device == "cuda")
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
