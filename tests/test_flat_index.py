"""Flat index: exact recall, growth, delete, cosine, filters, blocked scan."""

import numpy as np
import jax.numpy as jnp
import pytest

from valkey_search_tpu.indexes.base import RecordResult
from valkey_search_tpu.indexes.flat import FlatVectorIndex
from valkey_search_tpu.ops import topk as topk_ops


def brute_force(q, corpus, k, metric="l2"):
    if metric == "l2":
        d = ((q[:, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    else:
        d = 1.0 - q @ corpus.T
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


def test_add_search_exact(rng):
    idx = FlatVectorIndex(dim=32)
    corpus = rng.standard_normal((300, 32)).astype(np.float32)
    for i, v in enumerate(corpus):
        assert idx.add_record(f"doc:{i}", v) is RecordResult.ADDED
    q = rng.standard_normal((5, 32)).astype(np.float32)
    d, ids = idx.search_batch(q, k=10)
    want_d, want_i = brute_force(q, corpus, 10)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_allclose(d, want_d, rtol=1e-4, atol=1e-4)


def test_binary_blob_roundtrip(rng):
    idx = FlatVectorIndex(dim=4)
    v = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    assert idx.add_record("a", v.tobytes()) is RecordResult.ADDED
    res = idx.search(v, k=1)
    assert res[0][0] == "a"
    assert res[0][1] == pytest.approx(0.0, abs=1e-5)


def test_invalid_vector_rejected():
    idx = FlatVectorIndex(dim=4)
    assert idx.add_record("bad", b"\x00" * 9) is RecordResult.INVALID_DATA
    assert (
        idx.add_record("nan", np.array([np.nan, 0, 0, 0], np.float32))
        is RecordResult.INVALID_DATA
    )
    assert idx.count() == 0


def test_remove_and_modify(rng):
    idx = FlatVectorIndex(dim=8)
    a = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    idx.add_record("a", a)
    idx.add_record("b", b)
    assert idx.remove_record("a") is RecordResult.REMOVED
    assert idx.remove_record("a") is RecordResult.SKIPPED
    res = idx.search(a, k=2)
    assert [k for k, _ in res] == ["b"]
    # modify b to equal a
    assert idx.modify_record("b", a) is RecordResult.MODIFIED
    res = idx.search(a, k=1)
    assert res[0][0] == "b" and res[0][1] == pytest.approx(0.0, abs=1e-4)


def test_cosine_normalization(rng):
    idx = FlatVectorIndex(dim=16, metric="cosine")
    v = rng.standard_normal(16).astype(np.float32)
    idx.add_record("v", v * 5.0)  # scaled copy → cosine distance 0
    idx.add_record("w", rng.standard_normal(16).astype(np.float32))
    res = idx.search(v, k=1)
    assert res[0][0] == "v"
    assert res[0][1] == pytest.approx(0.0, abs=1e-5)
    doc = idx.doc_of("v")
    assert idx.store.magnitudes[doc] == pytest.approx(
        np.linalg.norm(v * 5.0), rel=1e-5
    )


def test_capacity_growth_and_id_reuse(rng):
    idx = FlatVectorIndex(dim=4, block_size=2048)
    for i in range(3000):  # crosses the 2048 growth boundary
        idx.add_record(f"k{i}", rng.standard_normal(4).astype(np.float32))
    assert idx.count() == 3000
    assert idx.store.capacity >= 3000
    idx.remove_record("k0")
    idx.add_record("fresh", rng.standard_normal(4).astype(np.float32))
    # freed id recycled → capacity unchanged
    assert idx.interner.capacity == 3000


def test_filter_mask(rng):
    idx = FlatVectorIndex(dim=8)
    corpus = rng.standard_normal((50, 8)).astype(np.float32)
    for i, v in enumerate(corpus):
        idx.add_record(f"d{i}", v)
    cap = idx.store.capacity
    allowed = np.zeros(cap, bool)
    allowed[[3, 7, 9]] = True
    q = corpus[3:4]
    d, ids = idx.search_batch(q, k=5, filter_mask=jnp.asarray(allowed))
    returned = [i for i in ids[0] if i >= 0]
    assert set(returned) <= {3, 7, 9}
    assert ids[0][0] == 3


def test_blocked_scan_matches_single_shot(rng):
    q = rng.standard_normal((3, 16)).astype(np.float32)
    corpus = rng.standard_normal((4096, 16)).astype(np.float32)
    d1, i1 = topk_ops.flat_topk(
        jnp.asarray(q), jnp.asarray(corpus), k=7, block_rows=1024
    )
    d2, i2 = topk_ops.flat_topk(
        jnp.asarray(q), jnp.asarray(corpus), k=7, block_rows=8192
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)


def test_k_larger_than_corpus(rng):
    idx = FlatVectorIndex(dim=4)
    idx.add_record("only", np.ones(4, np.float32))
    d, ids = idx.search_batch(np.zeros((1, 4), np.float32), k=5)
    assert ids[0][0] == idx.doc_of("only")
    assert (ids[0][1:] == -1).all()
    assert np.isinf(d[0][1:]).all()


def test_int8_corpus_mirror_snapshot(rng):
    """search.corpus-dtype int8: snapshot publishes an int8 mirror + scale;
    scatter updates requantize; out-of-range rows force a republish."""
    import numpy as np

    from valkey_search_tpu.indexes.flat import FlatVectorIndex
    from valkey_search_tpu.runtime import config

    config.set_config("search.corpus-dtype", "int8")
    try:
        idx = FlatVectorIndex(dim=8, metric="l2")
        vecs = rng.standard_normal((50, 8)).astype(np.float32)
        for i, v in enumerate(vecs):
            idx.add_record(f"k{i}", v)
        snap = idx.store.device_snapshot()
        assert "vectors_i8" in snap and "i8_scale" in snap
        scale = float(snap["i8_scale"])
        deq = np.asarray(snap["vectors_i8"], np.float32)[:50] * scale
        np.testing.assert_allclose(deq, vecs, atol=scale * 0.51)
        # in-range scatter keeps the published scale
        idx.add_record("k50", (vecs[0] * 0.5).astype(np.float32))
        snap2 = idx.store.device_snapshot()
        assert float(snap2["i8_scale"]) == scale
        # out-of-range row forces a fresh global scale
        idx.add_record("k51", (vecs[0] * 10).astype(np.float32))
        snap3 = idx.store.device_snapshot()
        assert float(snap3["i8_scale"]) > scale
        # searches still exact via the fp32 rescore path
        d, ids = idx.search_batch(vecs[:4], 1)
        assert (ids[:, 0] == np.arange(4)).all()
    finally:
        config.set_config("search.corpus-dtype", "bfloat16")


def test_scan_span_config_plumbed(rng, monkeypatch):
    """search.scan-span / search.scan-coarse-factor reach the fused scan
    (the operator recall-margin lever documented in BASELINE.md's
    corpus-shapes table); 0 = auto (None at the kernel boundary)."""
    from valkey_search_tpu.indexes import flat as flat_mod
    from valkey_search_tpu.runtime import config

    seen = {}

    def spy(queries, *a, k, **kw):
        # the fused kernel compiles only for a GPU; return shaped fakes — the
        # assertion is about the config plumbing only
        seen["span"] = kw.get("span")
        seen["coarse_factor"] = kw.get("coarse_factor")
        b = queries.shape[0]
        return (np.full((b, k), np.inf, np.float32),
                np.full((b, k), -1, np.int32))

    monkeypatch.setattr(flat_mod.topk_ops, "flat_topk_fused", spy)
    monkeypatch.setattr(flat_mod.topk_ops, "use_fused_scan",
                        lambda cap, m: m is None)
    config.set_config("search.corpus-dtype", "int8")
    try:
        idx = FlatVectorIndex(dim=8)
        for i, v in enumerate(
                rng.standard_normal((40, 8)).astype(np.float32)):
            idx.add_record(f"k{i}", v)
        q = rng.standard_normal((2, 8)).astype(np.float32)
        idx.search_batch(q, k=3)
        assert seen == {"span": None, "coarse_factor": None}
        config.set_config("search.scan-span", "4")
        config.set_config("search.scan-coarse-factor", "5")
        idx.search_batch(q, k=3)
        assert seen == {"span": 4, "coarse_factor": 5}
    finally:
        config.set_config("search.scan-span", "0")
        config.set_config("search.scan-coarse-factor", "0")
        config.set_config("search.corpus-dtype", "bfloat16")
