"""IVF coarse-pruned search (ops/ivf.py): recall vs brute force, layout
invariants, metric handling, and the engine-facing routing gate."""

import jax.numpy as jnp
import numpy as np
import pytest

from valkey_search_tpu.ops import ivf


def clustered(rng, n, d, centers=64, spread=0.08):
    c = rng.normal(size=(centers, d)).astype(np.float32)
    a = rng.integers(0, centers, size=n)
    x = c[a] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return np.ascontiguousarray(x, np.float32)


def brute(queries, corpus, k, metric="l2"):
    if metric == "l2":
        d = (
            (queries * queries).sum(1)[:, None]
            + (corpus * corpus).sum(1)[None, :]
            - 2.0 * queries @ corpus.T
        )
    else:
        d = 1.0 - queries @ corpus.T
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def recall_at_k(ids, truth):
    hits = 0
    for row, t in zip(ids, truth):
        hits += len(set(row[row >= 0]) & set(t))
    return hits / truth.size


class TestBuild:
    def test_layout_partitions_every_row_once(self, rng):
        n, d, s = 5000, 16, 128
        x = clustered(rng, n, d, centers=8)
        idx = ivf.build_ivf(x, block_rows=s, n_clusters=8, train_sample=2048)
        ids = np.asarray(idx.block_ids).ravel()
        live = np.sort(ids[ids >= 0])
        assert np.array_equal(live, np.arange(n))
        # pow2 block count, every valid flag consistent with ids
        assert idx.n_blocks & (idx.n_blocks - 1) == 0
        valid = np.asarray(idx.block_valid)
        has_rows = (np.asarray(idx.block_ids) >= 0).any(axis=1)
        assert np.array_equal(valid, has_rows)

    def test_custom_row_ids_survive(self, rng):
        n, d = 1000, 8
        x = clustered(rng, n, d, centers=4)
        row_ids = np.arange(1000, 1000 + n)
        idx = ivf.build_ivf(
            x, row_ids, block_rows=64, n_clusters=4, train_sample=512
        )
        ids = np.asarray(idx.block_ids).ravel()
        assert set(ids[ids >= 0]) == set(row_ids.tolist())

    def test_residual_codes_reconstruct_rows(self, rng):
        x = clustered(rng, 600, 8, centers=4)
        idx = ivf.build_ivf(x, block_rows=64, n_clusters=4, train_sample=512)
        codes = np.asarray(idx.blocks_i8, np.float32)
        cent = np.asarray(idx.centroids)
        scale = np.asarray(idx.block_scale)
        ids = np.asarray(idx.block_ids)
        recon = cent[:, None, :] + codes * scale[:, None, None]
        bb, ss = np.nonzero(ids >= 0)
        err = np.abs(recon[bb, ss] - x[ids[bb, ss]])
        # per-dim reconstruction error bounded by half a quantization step
        assert (err <= scale[bb][:, None] * 0.51 + 1e-6).all()
        np.testing.assert_allclose(
            np.asarray(idx.row_sq)[bb, ss],
            (recon[bb, ss] ** 2).sum(1),
            rtol=1e-4,
            atol=1e-4,
        )


class TestSearch:
    @pytest.mark.parametrize("metric", ["l2", "ip"])
    def test_recall_clustered_rescored(self, rng, metric):
        # the engine path: int8 coarse retrieval + exact fp32 rescore
        # (pure-coarse ordering is scrambled by int8 rounding when the
        # quantization step rivals intra-cluster spread — same story as
        # the fused flat scan, same fix)
        n, d, k = 20000, 32, 10
        x = clustered(rng, n, d, centers=32)
        if metric == "ip":
            x /= np.linalg.norm(x, axis=1, keepdims=True)
        idx = ivf.build_ivf(x, block_rows=256, n_clusters=16, train_sample=8192)
        q = x[rng.integers(0, n, size=64)] + 0.01 * rng.normal(
            size=(64, d)
        ).astype(np.float32)
        if metric == "ip":
            q /= np.linalg.norm(q, axis=1, keepdims=True)
        truth = brute(q, x, k, metric)
        _, ids = ivf.ivf_search_rescored(
            idx, jnp.asarray(q), jnp.asarray(x), k=k, probe=32, metric=metric
        )
        assert recall_at_k(np.asarray(ids), truth) >= 0.97
        # the property the rescore relies on: the coarse top-4k CONTAINS
        # the true top-k (ordering within it may be int8-noisy)
        _, cids = ivf.ivf_search_batch(
            idx, jnp.asarray(q), k=4 * k, probe=32, metric=metric
        )
        assert recall_at_k(np.asarray(cids), truth) >= 0.95

    def test_probe_full_coverage_is_near_exact(self, rng):
        # probing every block must reproduce brute force (up to int8
        # rounding, which the margin-free clustered corpus tolerates)
        n, d, k = 4000, 16, 5
        x = clustered(rng, n, d, centers=8)
        idx = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=2048)
        q = x[:32]
        truth = brute(q, x, k)
        _, ids = ivf.ivf_search_batch(
            idx, jnp.asarray(q), k=k, probe=idx.n_blocks
        )
        # bounded by distance-to-reconstruction ordering noise only
        assert recall_at_k(np.asarray(ids), truth) >= 0.96

    def test_probe_chunk_padding_no_duplicates(self, rng):
        # probe not divisible by probe_chunk exercises the pad/dedup path
        n, d, k = 4000, 16, 8
        x = clustered(rng, n, d, centers=8)
        idx = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=2048)
        q = x[:16]
        _, ids = ivf.ivf_search_batch(
            idx, jnp.asarray(q), k=k, probe=5, probe_chunk=4
        )
        ids = np.asarray(ids)
        for row in ids:
            live = row[row >= 0]
            assert len(live) == len(set(live.tolist()))

    def test_skewed_clusters(self, rng):
        # 90% of mass in one cluster: per-block mini-centroids must keep
        # selection fine-grained inside the big cluster
        d, k = 16, 10
        big = rng.normal(size=(18000, d)).astype(np.float32) * 0.1
        small = rng.normal(size=(2000, d)).astype(np.float32) * 0.1 + 3.0
        x = np.concatenate([big, small]).astype(np.float32)
        idx = ivf.build_ivf(x, block_rows=256, n_clusters=8, train_sample=8192)
        q = x[rng.integers(0, len(x), size=48)]
        truth = brute(q, x, k)
        # an isotropic blob is the IVF worst case: probe is the dial —
        # 40% of blocks probed holds >=0.95 even here
        _, ids = ivf.ivf_search_rescored(
            idx, jnp.asarray(q), jnp.asarray(x), k=k, probe=32
        )
        assert recall_at_k(np.asarray(ids), truth) >= 0.95

    def test_distances_close_to_true_l2(self, rng):
        n, d, k = 4000, 16, 5
        x = clustered(rng, n, d, centers=8)
        idx = ivf.build_ivf(x, block_rows=128, n_clusters=8, train_sample=2048)
        q = x[:8]
        dists, ids = ivf.ivf_search_batch(
            idx, jnp.asarray(q), k=k, probe=idx.n_blocks
        )
        dists, ids = np.asarray(dists), np.asarray(ids)
        smax = float(np.asarray(idx.block_scale).max())
        qn = float(np.linalg.norm(q, axis=1).max())
        # residual rounding error: |err| <= 2|q - c|·sqrt(d)·scale/2 plus
        # bf16 product noise; bound loosely with the max block scale
        tol = max(4.0 * qn * (d**0.5) * smax, 1e-2)
        for qi in range(len(q)):
            for j in range(k):
                if ids[qi, j] < 0:
                    continue
                true = float(((q[qi] - x[ids[qi, j]]) ** 2).sum())
                assert abs(dists[qi, j] - true) <= tol

    def test_tiny_corpus_probe_clamped(self, rng):
        x = clustered(rng, 100, 8, centers=2)
        idx = ivf.build_ivf(x, block_rows=64, n_clusters=2, train_sample=100)
        _, ids = ivf.ivf_search_batch(idx, jnp.asarray(x[:4]), k=3, probe=999)
        assert (np.asarray(ids)[:, 0] >= 0).all()


class TestKmeans:
    def test_separated_centers_recovered(self, rng):
        d = 8
        centers = np.eye(4, d).astype(np.float32) * 10
        x = np.repeat(centers, 256, axis=0) + 0.05 * rng.normal(
            size=(1024, d)
        ).astype(np.float32)
        cent = np.asarray(ivf.kmeans_fit(jnp.asarray(x), 4, iters=10))
        # every true center has a learned centroid within 0.5
        for c in centers:
            assert np.min(np.linalg.norm(cent - c, axis=1)) < 0.5

    def test_assign_chunks_matches_full(self, rng):
        x = clustered(rng, 3000, 8, centers=4)
        cent = ivf.kmeans_fit(jnp.asarray(x[:1024]), 4, iters=5)
        a1 = ivf.assign_clusters(x, cent, chunk_rows=512)
        a2 = ivf.assign_clusters(x, cent, chunk_rows=4096)
        assert np.array_equal(a1, a2)


class TestEngineRouting:
    """search.ivf-threshold routes index searches through the IVF mirror."""

    def _with_ivf(self, thresh=1000, block=128, probe=12):
        from valkey_search_tpu.runtime import config

        config.set_config("search.ivf-threshold", thresh)
        config.set_config("search.ivf-block-rows", block)
        config.set_config("search.ivf-probe", probe)

    def _reset(self):
        from valkey_search_tpu.runtime import config

        config.REGISTRY.reset_all()  # back to shipped defaults

    def test_flat_routes_and_recalls(self, rng):
        from valkey_search_tpu.indexes.flat import FlatVectorIndex
        from valkey_search_tpu.runtime.metrics import STATS

        self._with_ivf(probe=16)
        try:
            idx = FlatVectorIndex(dim=16, metric="l2")
            x = clustered(rng, 4000, 16, centers=8)
            idx.bulk_load([f"k{i}" for i in range(len(x))], x)
            before = STATS.get("ivf_served_searches")
            q = x[:32]
            d, ids = idx.search_batch(q, 5)
            assert STATS.get("ivf_served_searches") - before == 32
            truth = brute(q, x, 5)
            assert recall_at_k(ids, truth) >= 0.95
            # distances come from the exact fp32 rescore
            np.testing.assert_allclose(
                d[:, 0], [((q[i] - x[ids[i, 0]]) ** 2).sum() for i in range(32)],
                rtol=1e-4, atol=1e-4,
            )
        finally:
            self._reset()

    def test_flat_filter_mask_respected(self, rng):
        import jax.numpy as jnp

        from valkey_search_tpu.indexes.flat import FlatVectorIndex

        self._with_ivf(probe=32)
        try:
            idx = FlatVectorIndex(dim=16, metric="l2")
            x = clustered(rng, 3000, 16, centers=4)
            idx.bulk_load([f"k{i}" for i in range(len(x))], x)
            cap = idx.store.capacity
            mask = np.zeros(cap, bool)
            mask[: len(x) : 2] = True  # only even docs allowed
            d, ids = idx.search_batch(x[:16], 5, filter_mask=jnp.asarray(mask))
            live = ids[ids >= 0]
            assert len(live) and (live % 2 == 0).all()
        finally:
            self._reset()

    def test_flat_mutation_rebuilds_mirror(self, rng):
        from valkey_search_tpu.indexes.flat import FlatVectorIndex

        self._with_ivf(probe=16)
        try:
            idx = FlatVectorIndex(dim=16, metric="l2")
            x = clustered(rng, 2000, 16, centers=4)
            idx.bulk_load([f"k{i}" for i in range(len(x))], x)
            d, ids = idx.search_batch(x[:1], 1)
            assert ids[0, 0] == 0
            # removing the best hit must drop it from results (epoch bump
            # rebuilds the mirror; mask drops the cleared row either way)
            idx.remove_record("k0")
            d, ids = idx.search_batch(x[:1], 1)
            assert ids[0, 0] != 0
            # a new exact-duplicate doc becomes findable
            idx.add_record("dup", x[1])
            d, ids = idx.search_batch(x[1:2], 2)
            keys = {idx.interner.key_of(int(i)) for i in ids[0] if i >= 0}
            assert "dup" in keys and "k1" in keys
        finally:
            self._reset()

    def test_hnsw_exact_path_routes(self, rng):
        from valkey_search_tpu.indexes.hnsw import HnswVectorIndex
        from valkey_search_tpu.runtime.metrics import STATS

        self._with_ivf(probe=16)
        try:
            idx = HnswVectorIndex(dim=16, metric="l2", m=8)
            x = clustered(rng, 2000, 16, centers=4)
            idx.bulk_load([f"k{i}" for i in range(len(x))], x)
            before = STATS.get("ivf_served_searches")
            d, ids = idx.search_batch(x[:8], 5)
            assert STATS.get("ivf_served_searches") - before == 8
            truth = brute(x[:8], x, 5)
            assert recall_at_k(ids, truth) >= 0.95
            # tombstoned node rides the mask (store epoch may not bump)
            idx.remove_record("k0")
            d, ids = idx.search_batch(x[:1], 1)
            assert idx.interner.key_of(int(ids[0, 0])) != "k0"
        finally:
            self._reset()


class TestSampleRefine:
    def test_sample_refine_matches_exact_quality(self, rng):
        # the very-large-N path: level-2 centroids from the sample only.
        # Same corpus, both refine modes, comparable recall.
        n, d, k = 20000, 16, 10
        x = clustered(rng, n, d, centers=6, spread=0.3)
        q = x[rng.integers(0, n, size=48)]
        truth = brute(q, x, k)
        res = {}
        for mode in ("exact", "sample"):
            idx = ivf.build_ivf(
                x, block_rows=128, n_clusters=6, refine=mode,
                train_sample=8192,
            )
            _, ids = ivf.ivf_search_rescored(
                idx, jnp.asarray(q), jnp.asarray(x), k=k, probe=40
            )
            res[mode] = recall_at_k(np.asarray(ids), truth)
            # layout still a partition
            flat = np.asarray(idx.block_ids).ravel()
            assert np.array_equal(np.sort(flat[flat >= 0]), np.arange(n))
        assert res["sample"] >= 0.92
        assert res["sample"] >= res["exact"] - 0.05


class TestHostQuantize:
    def test_host_and_device_quantization_agree(self, rng):
        n, d, s = 3000, 16, 128
        x = clustered(rng, n, d, centers=8)
        a = ivf.build_ivf(x, block_rows=s, n_clusters=8, train_sample=2048,
                          host_quantize=False)
        b = ivf.build_ivf(x, block_rows=s, n_clusters=8, train_sample=2048,
                          host_quantize=True)
        np.testing.assert_array_equal(
            np.asarray(a.block_ids), np.asarray(b.block_ids)
        )
        np.testing.assert_allclose(
            np.asarray(a.centroids), np.asarray(b.centroids),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(a.block_scale), np.asarray(b.block_scale),
            rtol=1e-5, atol=1e-6,
        )
        # codes may differ by 1 ulp at round-half boundaries
        diff = np.abs(
            np.asarray(a.blocks_i8, np.int32) - np.asarray(b.blocks_i8, np.int32)
        )
        assert diff.max() <= 1
        np.testing.assert_allclose(
            np.asarray(a.row_sq), np.asarray(b.row_sq), rtol=1e-3, atol=1e-3
        )

def test_hnsw_ef_runtime_raises_probe(rng, monkeypatch):
    # EF_RUNTIME maps onto the IVF probe dial when the route engages
    from valkey_search_tpu.indexes.hnsw import HnswVectorIndex
    from valkey_search_tpu.ops import ivf as ivf_mod
    from valkey_search_tpu.runtime import config

    config.set_config("search.ivf-threshold", 1000)
    config.set_config("search.ivf-block-rows", 128)
    config.set_config("search.ivf-probe", 2)
    try:
        idx = HnswVectorIndex(dim=16, metric="l2", m=8)
        x = clustered(rng, 2000, 16, centers=4)
        idx.bulk_load([f"k{i}" for i in range(len(x))], x)
        seen = {}
        orig = ivf_mod.ivf_search_rescored

        def spy(*a, **kw):
            seen["probe"] = kw.get("probe")
            return orig(*a, **kw)

        monkeypatch.setattr(ivf_mod, "ivf_search_rescored", spy)
        idx.search_batch(x[:2], 3)
        assert seen["probe"] == 2  # config floor
        # EF_RUNTIME is a CANDIDATE count: it raises the probe only when
        # the requested pool exceeds probe * block_rows (128 here)
        idx.search_batch(x[:2], 3, ef=1000)
        assert seen["probe"] == 8  # ceil(1000 / 128)
        idx.search_batch(x[:2], 3, ef=100)
        assert seen["probe"] == 2  # covered by the floor already
    finally:
        config.REGISTRY.reset_all()  # back to shipped defaults


def test_filtered_searches_bypass_ivf(rng):
    """A selective 1-D filter must NOT ride IVF — block probing cannot see
    the mask and would prune away the allowed docs' blocks (r3 review
    finding). Filtered searches take the exact scan paths."""
    import jax.numpy as jnp

    from valkey_search_tpu.indexes.flat import FlatVectorIndex
    from valkey_search_tpu.runtime import config
    from valkey_search_tpu.runtime.metrics import STATS

    config.set_config("search.ivf-threshold", 1000)
    config.set_config("search.ivf-block-rows", 128)
    config.set_config("search.ivf-probe", 2)  # aggressive pruning
    try:
        idx = FlatVectorIndex(dim=16, metric="l2")
        x = clustered(rng, 4000, 16, centers=8)
        idx.bulk_load([f"k{i}" for i in range(len(x))], x)
        # allow only 20 docs, all far from the query's cluster
        allowed = np.arange(3980, 4000)
        mask = np.zeros(idx.store.capacity, bool)
        mask[allowed] = True
        before = STATS.get("ivf_served_searches")
        d, ids = idx.search_batch(x[:4], 5, filter_mask=jnp.asarray(mask))
        assert STATS.get("ivf_served_searches") == before  # scan path
        live = ids[ids >= 0]
        assert len(live) and np.isin(live, allowed).all()
    finally:
        config.REGISTRY.reset_all()  # back to shipped defaults


def test_ivf_delta_overlay_read_your_writes(rng):
    """Writes after the mirror build are served exactly via the delta
    overlay — no rebuild required — and the mirror only rebuilds once
    drift is material."""
    from valkey_search_tpu.indexes.flat import FlatVectorIndex
    from valkey_search_tpu.runtime import config
    from valkey_search_tpu.runtime.metrics import STATS

    config.set_config("search.ivf-threshold", 1000)
    config.set_config("search.ivf-block-rows", 128)
    config.set_config("search.ivf-probe", 16)
    try:
        idx = FlatVectorIndex(dim=16, metric="l2")
        x = clustered(rng, 3000, 16, centers=6)
        idx.bulk_load([f"k{i}" for i in range(len(x))], x)
        idx.search_batch(x[:1], 1)  # builds the mirror
        builds = STATS.get("ivf_mirror_builds")
        # post-build write: immediately visible, no rebuild
        q = rng.normal(size=(16,)).astype(np.float32) * 0.01 + 7.5
        idx.add_record("fresh", q)
        d, ids = idx.search_batch(q[None, :], 1)
        assert idx.interner.key_of(int(ids[0, 0])) == "fresh"
        assert STATS.get("ivf_mirror_builds") == builds  # throttled
        # post-build delete: immediately invisible
        idx.remove_record("fresh")
        d, ids = idx.search_batch(q[None, :], 1)
        assert idx.interner.key_of(int(ids[0, 0])) != "fresh"
        assert STATS.get("ivf_mirror_builds") == builds
    finally:
        config.REGISTRY.reset_all()  # back to shipped defaults


class TestDeviceBuild:
    """build_ivf_device: the link-free build from an already-uploaded
    mirror must match the host build's quality and layout invariants."""

    def test_partitions_every_row_once(self, rng):
        x = clustered(rng, 4096, 32)
        idx = ivf.build_ivf_device(
            jnp.asarray(x), block_rows=128, n_clusters=8, train_sample=2048
        )
        ids = np.asarray(idx.block_ids).reshape(-1)
        live = ids[ids >= 0]
        assert len(live) == 4096
        assert len(np.unique(live)) == 4096

    def test_present_mask_and_row_ids(self, rng):
        x = clustered(rng, 2048, 32)
        present = np.zeros(2048, bool)
        present[::2] = True
        row_ids = np.arange(2048) * 7 + 3
        idx = ivf.build_ivf_device(
            jnp.asarray(x), row_ids, present=present,
            block_rows=64, n_clusters=4, train_sample=512,
        )
        ids = np.asarray(idx.block_ids).reshape(-1)
        live = np.sort(ids[ids >= 0])
        assert np.array_equal(live, np.sort(row_ids[::2]))

    def test_recall_matches_host_build(self, rng):
        x = clustered(rng, 20000, 48, centers=32)
        q = x[:128]
        truth = brute(q, x, 10)
        dev = ivf.build_ivf_device(
            jnp.asarray(x), block_rows=256, n_clusters=16,
            train_sample=8192,
        )
        host = ivf.build_ivf(
            x, block_rows=256, n_clusters=16, train_sample=8192,
        )
        _, ids_d = ivf.ivf_search_batch(dev, jnp.asarray(q), k=10, probe=8)
        _, ids_h = ivf.ivf_search_batch(host, jnp.asarray(q), k=10, probe=8)
        r_d = recall_at_k(np.asarray(ids_d), truth)
        r_h = recall_at_k(np.asarray(ids_h), truth)
        assert r_d >= 0.9
        assert r_d >= r_h - 0.05  # sample-refined level 2 vs exact refine

    def test_bf16_mirror_accepted(self, rng):
        x = clustered(rng, 4096, 32)
        q = x[:64]
        truth = brute(q, x, 5)
        idx = ivf.build_ivf_device(
            jnp.asarray(x, jnp.bfloat16), block_rows=128, n_clusters=8,
            train_sample=2048,
        )
        _, ids = ivf.ivf_search_batch(idx, jnp.asarray(q), k=5, probe=8)
        assert recall_at_k(np.asarray(ids), truth) >= 0.85


class TestStreamingBuild:
    """build_ivf_streaming: the chunk-source build (nothing fp32 resident)
    must match build_ivf_device quality on the same materialized corpus.
    Reference scale story being replaced: hnswlib holds every fp32 vector
    resident (hnswalg.h addPoint) and the reference scales past memory only
    by sharding; the streaming build serves 100M x 128 from one chip."""

    @staticmethod
    def _source(x, n_chunks):
        ch = len(x) // n_chunks
        chunks = [jnp.asarray(x[i * ch:(i + 1) * ch]) for i in range(n_chunks)]
        return (lambda ci: chunks[ci]), ch

    def test_partitions_every_row_once(self, rng):
        x = clustered(rng, 8192, 32, centers=16)
        src, _ = self._source(x, 4)
        idx = ivf.build_ivf_streaming(
            src, 4, block_rows=128, n_clusters=8, block_align=4,
        )
        ids = np.asarray(idx.block_ids).reshape(-1)
        live = ids[ids >= 0]
        assert len(live) == 8192
        assert len(np.unique(live)) == 8192
        assert idx.n_blocks % 4 == 0  # block_align honored, not pow2

    def test_recall_matches_device_build(self, rng):
        x = clustered(rng, 20480, 48, centers=32)
        q = x[:128]
        truth = brute(q, x, 10)
        src, _ = self._source(x, 5)
        stream = ivf.build_ivf_streaming(
            src, 5, block_rows=256, n_clusters=16, block_align=8,
        )
        dev = ivf.build_ivf_device(
            jnp.asarray(x), block_rows=256, n_clusters=16,
            train_sample=4096,
        )
        _, ids_s = ivf.ivf_search_batch(stream, jnp.asarray(q), k=10, probe=8)
        _, ids_d = ivf.ivf_search_batch(dev, jnp.asarray(q), k=10, probe=8)
        r_s = recall_at_k(np.asarray(ids_s), truth)
        r_d = recall_at_k(np.asarray(ids_d), truth)
        assert r_s >= 0.88
        # fit sample comes from chunk 0 only (iid chunks): small slack
        assert r_s >= r_d - 0.07

    def test_codes_match_quantize_blocks(self, rng):
        # the scatter-quantize passes must reproduce quantize_blocks'
        # residual coding (same cent/scale/codes semantics) block by block
        x = clustered(rng, 4096, 16, centers=4)
        src, _ = self._source(x, 2)
        idx = ivf.build_ivf_streaming(
            src, 2, block_rows=64, n_clusters=4, block_align=1,
        )
        ids = np.asarray(idx.block_ids)
        codes = np.asarray(idx.blocks_i8)
        cents = np.asarray(idx.centroids)
        scale = np.asarray(idx.block_scale)
        rowsq = np.asarray(idx.row_sq)
        for b in range(idx.n_blocks):
            rows = ids[b][ids[b] >= 0]
            if not len(rows):
                continue
            got_rows = x[rows]
            cent_ref = got_rows.mean(axis=0)
            np.testing.assert_allclose(cents[b], cent_ref, rtol=2e-5,
                                       atol=2e-5)
            resid = got_rows - cent_ref
            assert scale[b] >= np.abs(resid).max() / 127.0 * 0.999
            recon = cents[b] + codes[b][ids[b] >= 0].astype(np.float32) \
                * scale[b]
            np.testing.assert_allclose(
                rowsq[b][ids[b] >= 0], (recon * recon).sum(1),
                rtol=1e-4, atol=1e-3,
            )
            # quantization error bounded by scale/2 per component
            assert np.abs(recon - got_rows).max() <= scale[b] * 0.51


class TestBuildResidency:
    """The >6M engine routing path must BUILD within device memory next to
    its own serving mirrors. ivf_build_plan models every array the build
    holds; these tests
    (a) validate the model is an upper bound on measured live-array bytes
    for a real build, and (b) assert the threshold-scale plan fits."""

    def test_plan_bounds_measured_peak(self, rng, monkeypatch):
        import jax

        n, d, s = 524_288, 32, 1024
        x = clustered(rng, n, d, centers=64)
        dev = jnp.asarray(x)

        def live_bytes():
            return sum(int(np.prod(a.shape)) * a.dtype.itemsize
                       for a in jax.live_arrays())

        base = live_bytes()
        peak = {"v": 0, "stages": {}}

        def probe(tag):
            b = live_bytes() - base
            peak["v"] = max(peak["v"], b)
            peak["stages"][tag] = max(peak["stages"].get(tag, 0), b)

        monkeypatch.setattr(ivf, "_RESIDENCY_PROBE", probe)
        idx = ivf.build_ivf_device(dev, block_rows=s)
        assert peak["stages"], "probe hooks never fired"
        plan = ivf.ivf_build_plan(n, d, block_rows=s)
        # the model is an upper bound on reality...
        assert peak["v"] <= plan["peak_bytes"], (peak, plan)
        # ...and not vacuously loose (within ~8x of measured)
        assert plan["peak_bytes"] <= max(peak["v"], 1) * 8, (peak, plan)
        # the final index is also within the plan's index term
        assert idx.device_bytes() <= plan["index_bytes"]

    def test_threshold_scale_build_fits_16gib(self):
        # 10.09M x 128 int8-mode serving (fp32 + int8 + norms + invalid
        # mirrors resident) must build within a 16 GiB share of a card
        # (several node processes per card, XLA_PYTHON_CLIENT_MEM_FRACTION)
        n, d = 10_092_544, 128
        serving = n * (d * 4 + d * 1 + 4 + 1)
        plan = ivf.ivf_build_plan(n, d, block_rows=1024,
                                  resident_bytes=serving)
        hbm = int(15.75 * 2**30)
        assert plan["peak_bytes"] < hbm, plan
        # large builds must use alignment padding, not pow2 (the pow2 pad
        # alone wasted ~0.8 GiB of codes at this shape)
        assert plan["nb_pad"] % 1024 == 0
        # and the serve-state after the build (mirrors + index) also fits
        assert serving + plan["index_bytes"] < hbm


class TestStreamingRescore:
    """The >=0.99 tier for corpora beyond device memory: exact fp32
    rescore by re-deriving candidate rows from the deterministic chunk
    source
    (ivf_search_rescored_streaming)."""

    def test_exact_distances_and_recall(self, rng):
        x = clustered(rng, 20480, 48, centers=32)
        q = x[:96] + 0.01 * rng.normal(size=(96, 48)).astype(np.float32)
        truth = brute(q, x, 10)
        ch = 4096
        chunks = [jnp.asarray(x[i * ch:(i + 1) * ch]) for i in range(5)]
        idx = ivf.build_ivf_streaming(
            lambda ci: chunks[ci], 5, block_rows=256, n_clusters=16,
            block_align=8,
        )
        nb = idx.n_blocks
        d_s, i_s = ivf.ivf_search_rescored_streaming(
            idx, jnp.asarray(q), lambda ci: chunks[ci], 5, ch,
            k=10, probe=nb, coarse_factor=8, sync_every=2,
        )
        d_s, i_s = np.asarray(d_s), np.asarray(i_s)
        # full probe + wide rescore: exact recall
        assert recall_at_k(i_s, truth) >= 0.999
        # returned distances are the EXACT fp32 distances of the ids
        for b in range(0, 96, 7):
            for j in range(10):
                rid = i_s[b, j]
                assert rid >= 0
                ref = float(((q[b] - x[rid]) ** 2).sum())
                assert abs(d_s[b, j] - ref) < 1e-2 + 1e-3 * abs(ref)
        # no duplicate ids within a query's top-k
        for b in range(96):
            live = i_s[b][i_s[b] >= 0]
            assert len(live) == len(set(live.tolist()))

    def test_beats_no_rescore_recall(self, rng):
        # residual-int8 reconstruction scores saturate below the rescored
        # tier on tight corpora — the whole reason this tier exists
        x = clustered(rng, 16384, 32, centers=8, spread=0.02)
        q = x[:128] + 0.002 * rng.normal(size=(128, 32)).astype(np.float32)
        truth = brute(q, x, 10)
        ch = 4096
        chunks = [jnp.asarray(x[i * ch:(i + 1) * ch]) for i in range(4)]
        idx = ivf.build_ivf_streaming(
            lambda ci: chunks[ci], 4, block_rows=128, n_clusters=8,
            block_align=4,
        )
        probe = min(16, idx.n_blocks)
        _, i_raw = ivf.ivf_search_batch(idx, jnp.asarray(q), k=10,
                                        probe=probe)
        d_r, i_r = ivf.ivf_search_rescored_streaming(
            idx, jnp.asarray(q), lambda ci: chunks[ci], 4, ch,
            k=10, probe=probe, coarse_factor=4,
        )
        r_raw = recall_at_k(np.asarray(i_raw), truth)
        r_res = recall_at_k(np.asarray(i_r), truth)
        assert r_res >= r_raw
        assert r_res >= 0.95


class TestGroupedDispatch:
    """ivf_search_batch's inverted (MoE-style) stage 2 must agree with the
    per-query gather scan: identical block selection, identical scoring
    formula — differences only from bf16 contraction order."""

    def _both(self, idx, q, probe, metric="l2", fmask=None):
        d_g, i_g = ivf._ivf_search_batch_grouped(
            idx, q, k=10, probe=probe, metric=metric, filter_mask=fmask)
        d_s, i_s = ivf._ivf_search_batch_steps(
            idx, q, k=10, probe=probe, metric=metric, probe_chunk=4,
            filter_mask=fmask)
        return (np.asarray(d_g), np.asarray(i_g),
                np.asarray(d_s), np.asarray(i_s))

    def test_grouped_matches_steps(self, rng):
        x = clustered(rng, 20000, 48, centers=32)
        idx = ivf.build_ivf(x, block_rows=256, n_clusters=16,
                            train_sample=8192)
        q = jnp.asarray(x[:256])
        d_g, i_g, d_s, i_s = self._both(idx, q, probe=8)
        np.testing.assert_allclose(d_g, d_s, rtol=2e-3, atol=2e-2)
        # ids agree except where near-tie scores reorder
        assert (i_g == i_s).mean() > 0.98

    def test_grouped_matches_steps_ip_filtered(self, rng):
        x = clustered(rng, 8192, 32, centers=16)
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        idx = ivf.build_ivf(x, block_rows=128, n_clusters=8,
                            train_sample=4096)
        q = jnp.asarray(x[:128])
        fmask = jnp.asarray(np.arange(8192) % 3 != 0)
        d_g, i_g, d_s, i_s = self._both(idx, q, probe=6, metric="ip",
                                        fmask=fmask)
        np.testing.assert_allclose(d_g, d_s, rtol=2e-3, atol=2e-2)
        assert (i_g == i_s).mean() > 0.98
        assert not set(np.asarray(i_g)[i_g >= 0].ravel()) & set(
            range(0, 8192, 3))

    def test_dispatch_picks_grouped_at_high_multiplicity(self, rng):
        # B*probe >> n_blocks -> grouped; recall must hold either way
        x = clustered(rng, 16384, 32, centers=16)
        q = x[:512]
        truth = brute(q, x, 10)
        idx = ivf.build_ivf(x, block_rows=128, n_clusters=8,
                            train_sample=4096)
        _, ids = ivf.ivf_search_batch(idx, jnp.asarray(q), k=10, probe=16)
        assert recall_at_k(np.asarray(ids), truth) >= 0.9

    def test_grouped_gather_cap_routes_to_steps(self, rng, monkeypatch):
        # Grouped materializes a [n_seg, S, d] int8 gather; past the
        # memory cap the steps path must serve instead (B=512 probe=512
        # at the 100M layout plans a 23.7 GiB gather, while steps bounds
        # temps by probe_chunk).
        x = clustered(rng, 8192, 32, centers=16)
        q = x[:256]
        truth = brute(q, x, 10)
        idx = ivf.build_ivf(x, block_rows=128, n_clusters=8,
                            train_sample=4096)
        called = {}
        orig_grouped = ivf._ivf_search_batch_grouped
        orig_steps = ivf._ivf_search_batch_steps

        def spy_grouped(*a, **kw):
            called["grouped"] = True
            return orig_grouped(*a, **kw)

        def spy_steps(*a, **kw):
            called["steps"] = True
            return orig_steps(*a, **kw)

        monkeypatch.setattr(ivf, "_ivf_search_batch_grouped", spy_grouped)
        monkeypatch.setattr(ivf, "_ivf_search_batch_steps", spy_steps)
        # multiplicity >= 2 and gather under the cap -> grouped
        ivf.ivf_search_batch(idx, jnp.asarray(q), k=10, probe=16)
        assert called == {"grouped": True}
        called.clear()
        # same launch with a tiny cap -> steps, same answer
        monkeypatch.setattr(ivf, "_grouped_gather_cap", lambda limit: 1)
        _, ids = ivf.ivf_search_batch(idx, jnp.asarray(q), k=10, probe=16)
        assert called == {"steps": True}
        assert recall_at_k(np.asarray(ids), truth) >= 0.9

    def test_default_probe_scales_with_block_count(self):
        # anchors: 6M layout (nb<=7168) -> 8; 10M (nb~12288) -> 16; 100M
        # (nb=100352) -> 256+; clamped at 512
        def fake(nb):
            z = jnp.zeros((nb, 1, 1), jnp.int8)
            return ivf.IvfDeviceIndex(
                centroids=None, cent_sq=None, block_valid=None,
                blocks_i8=z, block_scale=None, row_sq=None, block_ids=None)

        assert ivf.default_probe(fake(2048)) == 8
        assert ivf.default_probe(fake(7168)) == 8
        assert ivf.default_probe(fake(9216)) == 16
        assert ivf.default_probe(fake(12288)) == 16
        assert ivf.default_probe(fake(16384)) == 43
        assert ivf.default_probe(fake(100352)) == 262
        assert ivf.default_probe(fake(1 << 20)) == 512


def test_grouped_gather_cap_routing():
    """On an H100 (JAX's default share: 3/4 of 80 GB) the 10M engine
    shape stays on the grouped fast path while the 100M shape, whose
    gather alone is 23.7 GiB, stays on bounded-temps steps."""
    from valkey_search_tpu.ops.ivf import (
        _grouped_gather_bytes, _grouped_gather_cap)

    cap = _grouped_gather_cap(int(0.75 * 80e9))
    # 10M bench shape: B=16384, probe=16, nb=11264, S=1024, d=128 int8
    g10 = _grouped_gather_bytes(16384, 16, 11264, 1024, 128)
    assert g10 <= cap, g10
    # 100M shape: B=512, probe=512, nb=100352 — 23.7 GiB, must not group
    g100 = _grouped_gather_bytes(512, 512, 100352, 1024, 128)
    assert g100 > cap, g100
