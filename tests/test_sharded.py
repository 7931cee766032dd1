"""Sharded (cluster-mode) search over the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from valkey_search_tpu.parallel import mesh as pm
from valkey_search_tpu.parallel.fanout import ShardedHnswIndex


def test_sharded_flat_matches_brute_force(rng):
    mesh = pm.make_mesh(8)
    corpus = rng.standard_normal((8 * 512, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    d, i, vv = pm.sharded_flat_topk(mesh, jnp.asarray(corpus), jnp.asarray(q), k=5)
    dd = ((q[:, None, :] - corpus[None, :, :]) ** 2).sum(-1)
    want = np.argsort(dd, axis=1)[:, :5]
    np.testing.assert_array_equal(np.asarray(i), want)
    assert np.asarray(vv)[0] == np.asarray(vv)[1]


def test_sharded_batch_update(rng):
    mesh = pm.make_mesh(4)
    corpus = rng.standard_normal((4 * 256, 8)).astype(np.float32)
    target = rng.standard_normal((2, 8)).astype(np.float32)
    upd = pm.sharded_batch_update(
        mesh, jnp.asarray(corpus), jnp.asarray([3, 700], jnp.int32),
        jnp.asarray(target),
    )
    upd = np.asarray(upd)
    np.testing.assert_allclose(upd[3], target[0], rtol=1e-6)
    np.testing.assert_allclose(upd[700], target[1], rtol=1e-6)
    # untouched rows identical
    np.testing.assert_array_equal(upd[4], corpus[4])


@pytest.fixture(scope="module")
def sharded_index():
    rng = np.random.default_rng(123)
    corpus = rng.standard_normal((1200, 16)).astype(np.float32)
    idx = ShardedHnswIndex(
        dim=16, m=8, ef_construction=60, mesh=pm.make_mesh(4)
    )
    for i, v in enumerate(corpus):
        idx.add_record(f"k{i}", v)
    return idx, corpus


def test_sharded_hnsw_recall(sharded_index, rng):
    idx, corpus = sharded_index
    queries = rng.standard_normal((8, 16)).astype(np.float32)
    d, docs = idx.search_batch(queries, k=10, ef=80)
    hits = 0
    for b, q in enumerate(queries):
        dd = ((corpus - q) ** 2).sum(-1)
        want = {
            idx.interner.lookup(f"k{j}") for j in np.argsort(dd)[:10]
        }
        hits += len(want & {int(x) for x in docs[b] if x >= 0})
    assert hits / 80 >= 0.9, f"sharded recall {hits/80}"


def test_sharded_self_lookup(sharded_index):
    idx, corpus = sharded_index
    d, docs = idx.search_batch(corpus[99][None], k=1, ef=60)
    assert idx.interner.key_of(int(docs[0, 0])) == "k99"
    assert d[0, 0] == pytest.approx(0.0, abs=1e-4)


def test_sharded_remove(sharded_index):
    idx, corpus = sharded_index
    idx.remove_record("k99")
    d, docs = idx.search_batch(corpus[99][None], k=5, ef=60)
    keys = {idx.interner.key_of(int(x)) for x in docs[0] if x >= 0}
    assert "k99" not in keys


def test_sharded_filter(sharded_index):
    idx, corpus = sharded_index
    cap = idx.interner.capacity
    allowed = np.zeros(cap, bool)
    docs_allowed = {idx.interner.lookup(f"k{i}") for i in range(50)}
    for d0 in docs_allowed:
        allowed[d0] = True
    d, docs = idx.search_batch(
        corpus[500][None], k=10, ef=100, filter_mask=jnp.asarray(allowed)
    )
    got = {int(x) for x in docs[0] if x >= 0}
    assert got and got <= docs_allowed


def test_shard_distribution(sharded_index):
    idx, _ = sharded_index
    counts = [s.count() for s in idx.shards]
    assert sum(counts) == 1199  # one removed
    assert min(counts) > 0


def test_sharded_two_stage_matches_exact(rng):
    mesh8 = pm.make_mesh(8)
    d = 16
    corpus = rng.standard_normal((8 * 64, d)).astype("float32")
    queries = rng.standard_normal((6, d)).astype("float32")
    de, ie, _ = pm.sharded_flat_topk(
        mesh8, jnp.asarray(corpus), jnp.asarray(queries), k=5
    )
    dt, it, _ = pm.sharded_flat_topk(
        mesh8, jnp.asarray(corpus), jnp.asarray(queries), k=5, two_stage=True
    )
    # tiny shards: coarse covers everything → identical ids
    assert np.array_equal(np.asarray(ie), np.asarray(it))
    assert np.allclose(np.asarray(de), np.asarray(dt), atol=1e-4)


def test_mesh_version_mismatch_retries_then_converges(rng):
    """Divergent shard versions must trip the mesh consistency check and
    retry against a fresh snapshot (reference: FAILED_PRECONDITION on
    fingerprint mismatch -> coordinator retry, server.h:60-65)."""
    mesh = pm.make_mesh(8)
    corpus = jnp.asarray(rng.standard_normal((8 * 256, 16)).astype(np.float32))
    q = jnp.asarray(rng.standard_normal((3, 16)).astype(np.float32))
    calls = {"n": 0}

    def snapshot():
        calls["n"] += 1
        if calls["n"] == 1:  # shard 5 lags one version behind
            versions = jnp.asarray([2, 2, 2, 2, 2, 1, 2, 2], jnp.int32)
        else:  # converged on refresh
            versions = jnp.full(8, 2, jnp.int32)
        return corpus, versions, None

    d, i, partial = pm.consistent_sharded_topk(mesh, snapshot, q, k=5)
    assert calls["n"] == 2 and not partial
    dd = ((np.asarray(q)[:, None, :] - np.asarray(corpus)[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.asarray(i), np.argsort(dd, 1)[:, :5])


def test_mesh_version_mismatch_exhausts_retries(rng):
    mesh = pm.make_mesh(4)
    corpus = jnp.asarray(rng.standard_normal((4 * 128, 8)).astype(np.float32))
    q = jnp.asarray(rng.standard_normal((2, 8)).astype(np.float32))

    def snapshot():  # never converges
        return corpus, jnp.asarray([1, 2, 1, 1], jnp.int32), None

    with pytest.raises(pm.MeshConsistencyError, match="did not converge"):
        pm.consistent_sharded_topk(mesh, snapshot, q, k=3, max_retries=3)


def test_mesh_killed_shard_partial_results(rng):
    """A dead shard's rows drop out of the merge; partial_ok returns the
    surviving shards' results flagged partial, first-error policy raises
    (reference fanout.cc:177-221)."""
    mesh = pm.make_mesh(8)
    n, d_dim = 8 * 256, 16
    corpus_np = rng.standard_normal((n, d_dim)).astype(np.float32)
    q_np = corpus_np[:4] + 0.01  # queries near shard-0 rows
    corpus = jnp.asarray(corpus_np)
    q = jnp.asarray(q_np)

    def snapshot():
        return corpus, jnp.full(8, 7, jnp.int32), None

    # shard 0 dead: its rows (the true nearest) must not appear
    d, i, partial = pm.consistent_sharded_topk(
        mesh, snapshot, q, k=5, partial_ok=True, dead_shards=[0],
    )
    assert partial
    rows = n // 8
    ids = np.asarray(i)
    assert (ids >= rows).all(), "dead shard's rows leaked into results"
    # exact check vs brute force over the surviving shards
    dd = ((q_np[:, None, :] - corpus_np[None]) ** 2).sum(-1)
    dd[:, :rows] = np.inf
    np.testing.assert_array_equal(ids, np.argsort(dd, 1)[:, :5])

    with pytest.raises(pm.MeshConsistencyError, match="partial results"):
        pm.consistent_sharded_topk(
            mesh, snapshot, q, k=5, partial_ok=False, dead_shards=[0],
        )


@pytest.mark.slow
def test_mesh_large_sharded_tier(rng):
    """Wide-corpus tier on the 8-device virtual mesh: 1M rows x 32d
    sharded, mismatch injection + killed shard against the same data
    (scale story; real 10M+ runs ride the card's bench)."""
    mesh = pm.make_mesh(8)
    n, d_dim = 1 << 20, 32
    corpus_np = rng.standard_normal((n, d_dim)).astype(np.float32)
    corpus = jnp.asarray(corpus_np)
    q_np = rng.standard_normal((8, d_dim)).astype(np.float32)
    q = jnp.asarray(q_np)
    calls = {"n": 0}

    def snapshot():
        calls["n"] += 1
        v = np.full(8, 3, np.int32)
        if calls["n"] == 1:
            v[3] = 2  # stale shard on the first attempt
        return corpus, jnp.asarray(v), None

    d, i, partial = pm.consistent_sharded_topk(mesh, snapshot, q, k=10)
    assert calls["n"] == 2 and not partial
    dd = ((q_np[:, None, :] - corpus_np[None]) ** 2).sum(-1)
    want = np.argsort(dd, 1)[:, :10]
    np.testing.assert_array_equal(np.asarray(i), want)

    d2, i2, partial2 = pm.consistent_sharded_topk(
        mesh, snapshot, q, k=10, partial_ok=True, dead_shards=[1, 6],
    )
    assert partial2
    rows = n // 8
    ids2 = np.asarray(i2)
    for s in (1, 6):
        assert not (((ids2 >= s * rows) & (ids2 < (s + 1) * rows)).any())


def test_dim_sharded_tp_topk_matches_brute_force(rng):
    """Dimension-axis (tensor-parallel) sharding: partial dots + psum
    across devices == exact distances (SURVEY §5.7 extension)."""
    mesh = pm.make_mesh(8)
    n, d = 512, 8 * 32
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((4, d)).astype(np.float32)
    dists, ids = pm.dim_sharded_flat_topk(
        mesh, jnp.asarray(corpus), jnp.asarray(q), k=5,
    )
    dd = ((q[:, None, :] - corpus[None]) ** 2).sum(-1)
    want = np.argsort(dd, axis=1)[:, :5]
    np.testing.assert_array_equal(np.asarray(ids), want)
    np.testing.assert_allclose(
        np.asarray(dists), np.sort(dd, axis=1)[:, :5], rtol=1e-4, atol=1e-3,
    )


def test_dim_sharded_tp_cosine(rng):
    mesh = pm.make_mesh(4)
    n, d = 256, 4 * 16
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = corpus[:3]
    dists, ids = pm.dim_sharded_flat_topk(
        mesh, jnp.asarray(corpus), jnp.asarray(q), k=1, metric="cosine",
    )
    np.testing.assert_array_equal(np.asarray(ids)[:, 0], [0, 1, 2])


@pytest.mark.slow
def test_sharded_flat_large_scale_exactness(rng):
    """Scale tier: 256k x 64 across the 8-device virtual mesh — the
    cross-shard merge stays exact at sizes where per-shard padding,
    blocking and the all_gather top-k merge all engage (to
    widen the virtual-mesh story beyond toy shapes)."""
    mesh = pm.make_mesh(8)
    n, d, k, nq = 8 * 32768, 64, 10, 32
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    dist, ids, vv = pm.sharded_flat_topk(
        mesh, jnp.asarray(corpus), jnp.asarray(q), k=k)
    ids = np.asarray(ids)
    # brute-force ground truth in chunks (keeps peak memory bounded)
    for s in range(0, nq, 8):
        dd = ((q[s:s + 8, None, :] - corpus[None, :, :]) ** 2).sum(-1)
        want = np.argsort(dd, axis=1, kind="stable")[:, :k]
        got_sets = [set(r) for r in ids[s:s + 8]]
        for row, (g, w) in enumerate(zip(got_sets, want)):
            assert g == set(w), (s + row, sorted(g)[:5], sorted(w)[:5])
    assert len({int(x) for x in np.asarray(vv)}) == 1  # one shard version


def test_sharded_ivf_matches_single_chip(rng):
    from valkey_search_tpu.ops import ivf

    mesh = pm.make_mesh(8)
    n, d, k = 8192, 16, 5
    cent = rng.standard_normal((8, d)).astype(np.float32)
    a = rng.integers(0, 8, n)
    x = (cent[a] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    idx = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=4096)
    assert idx.n_blocks % 8 == 0
    q = x[:8]
    # full probe on both paths: sharded result must equal the single-chip
    # kernel exactly (same formula, disjoint blocks, exact merge)
    d1, i1 = ivf.ivf_search_batch(
        idx, jnp.asarray(q), k=k, probe=idx.n_blocks
    )
    ds, js = pm.sharded_ivf_topk(
        mesh, idx, jnp.asarray(q), k=k, probe=idx.n_blocks
    )
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(js))
    np.testing.assert_allclose(
        np.asarray(d1), np.asarray(ds), rtol=1e-5, atol=1e-5
    )


def test_sharded_ivf_partial_probe_recall(rng):
    from valkey_search_tpu.ops import ivf

    mesh = pm.make_mesh(8)
    n, d, k = 8192, 16, 5
    cent = rng.standard_normal((8, d)).astype(np.float32)
    a = rng.integers(0, 8, n)
    x = (cent[a] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    idx = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=4096)
    q = x[:16]
    probe = max(1, idx.n_blocks // 8)
    ds, js = pm.sharded_ivf_topk(mesh, idx, jnp.asarray(q), k=k, probe=probe)
    js = np.asarray(js)
    # per-shard probing covers at least the single-chip probe's cells
    truth = np.argsort(
        ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1), axis=1
    )[:, :k]
    hits = sum(
        len(set(r[r >= 0]) & set(t)) for r, t in zip(js, truth)
    )
    assert hits / truth.size >= 0.9


def test_sharded_ivf_rescored_exact_tier(rng):
    """The mesh >=0.99 tier: int8 blocks AND fp32 rows
    sharded over 8 devices, per-shard exact rescore, all_gather merge. Recall
    must beat the no-rescore path on a quantization-hostile corpus and
    the returned distances must be fp32-exact."""
    from valkey_search_tpu.ops import ivf

    mesh = pm.make_mesh(8)
    n, d, k = 16384, 16, 10
    cent = rng.standard_normal((8, d)).astype(np.float32)
    a = rng.integers(0, 8, n)
    # tight clusters: residual-int8 rounding rivals intra-cluster spread,
    # so coarse-only ordering is visibly noisy (same setup as the
    # single-chip rescore tests)
    x = (cent[a] + 0.02 * rng.standard_normal((n, d))).astype(np.float32)
    idx = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=4096)
    assert idx.n_blocks % 8 == 0
    slots = jnp.asarray(pm.rows_in_slot_order(x, idx.block_ids))
    q = x[:64] + 0.002 * rng.standard_normal((64, d)).astype(np.float32)
    dd = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(dd, axis=1, kind="stable")[:, :k]
    probe = idx.n_blocks  # full probe isolates the rescore's contribution
    _, i_raw = pm.sharded_ivf_topk(mesh, idx, jnp.asarray(q), k=k,
                                   probe=probe)
    d_r, i_r = pm.sharded_ivf_topk_rescored(
        mesh, idx, slots, jnp.asarray(q), k=k, probe=probe,
        coarse_factor=8,
    )
    d_r, i_r = np.asarray(d_r), np.asarray(i_r)

    def recall(ids):
        return np.mean([
            len(set(ids[b].tolist()) & set(truth[b].tolist())) / k
            for b in range(len(q))
        ])

    assert recall(i_r) >= 0.99
    assert recall(i_r) >= recall(np.asarray(i_raw))
    # distances are the exact fp32 distances of the returned rows
    for b in range(0, 64, 9):
        for j in range(k):
            rid = i_r[b, j]
            assert rid >= 0
            assert abs(d_r[b, j] - dd[b, rid]) < 1e-3 + 1e-4 * abs(dd[b, rid])
    # no duplicate ids (rows live in exactly one shard)
    for b in range(64):
        live = i_r[b][i_r[b] >= 0]
        assert len(live) == len(set(live.tolist()))
