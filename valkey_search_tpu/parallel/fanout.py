"""ShardedHnswIndex: the cluster-mode index — fanout without gRPC.

Reference mapping: the coordinator's cross-shard scatter/gather
(src/query/fanout.cc PerformSearchFanoutAsync :312, per-shard
SearchIndexPartition RPC, merge tracker :69-222) becomes S per-device HNSW
subgraphs searched in one shard_map program with an all_gather top-k merge
across devices (parallel/mesh.py). Keys are routed to shards by hash (the
reference routes by keyspace hash slot, vmsdk/src/cluster_map.h); the
per-shard version scalars replace the index-fingerprint consistency check
(coordinator/server.h:60-65) — a (min≠max) version spread is surfaced as
``consistent=False`` so callers can retry on a fresh snapshot or accept
partial results (search.prefer-partial-results).
"""

from __future__ import annotations

import threading
import zlib
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.indexes.base import IndexBase, RecordResult
from valkey_search_tpu.indexes.hnsw import HnswVectorIndex
from valkey_search_tpu.ops import hnsw_search as hs_ops
from valkey_search_tpu.parallel import mesh as pm
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.metrics import STATS
from valkey_search_tpu.utils.interning import KeyInterner


def _normalize_graphs(
    graphs: List[hs_ops.HnswDeviceGraph], m: int
) -> List[hs_ops.HnswDeviceGraph]:
    """Pad per-shard graphs to identical shapes so they stack on a mesh axis:
    same node capacity, same level count, same per-level table rows."""
    cap = max(g.vectors.shape[0] for g in graphs)
    dim = graphs[0].vectors.shape[1]
    m0 = graphs[0].links0.shape[1]
    max_lv = max(len(g.upper_id2row) for g in graphs)
    lvl_rows = [
        max(
            (g.upper_links[li].shape[0] if li < len(g.upper_links) else 8)
            for g in graphs
        )
        for li in range(max_lv)
    ]

    out = []
    for g in graphs:
        pad_n = cap - g.vectors.shape[0]
        vectors = g.vectors
        links0 = g.links0
        deleted = g.deleted
        node_doc = g.node_doc
        if pad_n:
            vectors = jnp.concatenate(
                [vectors, jnp.zeros((pad_n, dim), vectors.dtype)]
            )
            links0 = jnp.concatenate(
                [links0, jnp.full((pad_n, m0), -1, jnp.int32)]
            )
            deleted = jnp.concatenate([deleted, jnp.ones(pad_n, bool)])
            node_doc = jnp.concatenate(
                [node_doc, jnp.full(pad_n, -1, jnp.int32)]
            )
        id2rows, links = [], []
        for li in range(max_lv):
            if li < len(g.upper_id2row):
                idr = g.upper_id2row[li]
                lnk = g.upper_links[li]
                if idr.shape[0] < cap:
                    idr = jnp.concatenate(
                        [idr, jnp.full(cap - idr.shape[0], -1, jnp.int32)]
                    )
                if lnk.shape[0] < lvl_rows[li]:
                    lnk = jnp.concatenate(
                        [lnk, jnp.full((lvl_rows[li] - lnk.shape[0], m),
                                       -1, jnp.int32)]
                    )
            else:
                idr = jnp.full(cap, -1, jnp.int32)
                lnk = jnp.full((lvl_rows[li], m), -1, jnp.int32)
            id2rows.append(idr)
            links.append(lnk)
        out.append(
            hs_ops.HnswDeviceGraph(
                vectors=vectors,
                links0=links0,
                deleted=deleted,
                entry=g.entry,
                upper_id2row=tuple(id2rows),
                upper_links=tuple(links),
                node_doc=node_doc,
            )
        )
    return out


class ShardedHnswIndex(IndexBase):
    """HNSW corpus sharded across a device mesh (the 'cluster mode' index)."""

    kind = "HNSW"
    mutation_weight = 10.0

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        ef_runtime: Optional[int] = None,
        n_shards: Optional[int] = None,
        mesh: Optional[object] = None,
        interner: Optional[KeyInterner] = None,
        seed: int = 0x5EED,
    ):
        self.dim = dim
        self.metric = metric
        self.m = m
        self.ef_runtime = ef_runtime or int(config.get("search.default-ef-runtime"))
        self._owns_interner = interner is None
        self.interner = interner if interner is not None else KeyInterner()
        self.mesh = mesh if mesh is not None else pm.make_mesh(n_shards)
        self.n_shards = self.mesh.shape[pm.SHARD_AXIS]
        # Sub-indexes share the schema interner so predicate masks stay in the
        # schema doc-id space across shards.
        self.shards = [
            HnswVectorIndex(
                dim, metric, m, ef_construction, ef_runtime,
                interner=self.interner, seed=seed + s,
            )
            for s in range(self.n_shards)
        ]
        self._stacked = None
        self._stacked_caps: Optional[Tuple] = None
        self._lock = threading.RLock()

    # -- key routing (hash slot analog) -------------------------------------
    def shard_of(self, key: str) -> int:
        return zlib.crc32(key.encode()) % self.n_shards

    # -- IndexBase -----------------------------------------------------------
    def add_record(self, key: str, value) -> RecordResult:
        r = self.shards[self.shard_of(key)].add_record(key, value)
        if r is not RecordResult.INVALID_DATA:
            with self._lock:
                self._stacked = None
        return r

    def modify_record(self, key: str, value) -> RecordResult:
        return self.add_record(key, value)

    def remove_record(self, key: str) -> RecordResult:
        r = self.shards[self.shard_of(key)].remove_record(key)
        if r is RecordResult.REMOVED:
            if self._owns_interner:
                # sub-shards share our interner (so they never release);
                # without this the doc-id space grows forever under
                # add/remove churn (r2 review finding)
                self.interner.release(key)
            with self._lock:
                self._stacked = None
        return r

    def tracked_keys(self):
        out = set()
        for s in self.shards:
            out |= s.tracked_keys()
        return out

    def count(self) -> int:
        return sum(s.count() for s in self.shards)

    def doc_of(self, key: str):
        return self.shards[self.shard_of(key)].doc_of(key)

    # -- snapshot ------------------------------------------------------------
    def _publish(self):
        with self._lock:
            if self._stacked is not None:
                return self._stacked
            graphs = _normalize_graphs(
                [s.device_graph() for s in self.shards], self.m
            )
            stacked = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *graphs
            )
            versions = jnp.asarray(
                [s.store.epoch for s in self.shards], jnp.int32
            )
            node_docs = np.stack(
                [np.asarray(g.node_doc) for g in graphs]
            )
            self._stacked = (stacked, versions, node_docs)
            STATS.incr("sharded_graph_publishes")
            return self._stacked

    # -- search --------------------------------------------------------------
    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: Optional[int] = None,
        filter_mask: Optional[jnp.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fanout search → (dists [B,k], doc ids [B,k])."""
        if self.count() == 0:
            b = np.atleast_2d(queries).shape[0]
            return (
                np.full((b, k), np.inf, np.float32),
                np.full((b, k), -1, np.int32),
            )
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        ef = max(ef or self.ef_runtime, k)
        fmasks = None
        if filter_mask is not None:
            fmasks = jnp.broadcast_to(
                filter_mask[None, :], (self.n_shards,) + filter_mask.shape
            )
        # consistency: per-shard store epochs are INDEPENDENT counters, so
        # comparing them to each other is meaningless (a single-shard write
        # would look like permanent divergence and retry forever — r2
        # review finding). The check that matches the reference's
        # FAILED_PRECONDITION semantics: did any shard's epoch move between
        # the publish we searched and now? Bounded retry on a fresh
        # publish, then accept (partial-results stance).
        for _attempt in range(3):
            stacked, versions, node_docs = self._publish()
            d, gids, _vminmax = pm.sharded_hnsw_search(
                self.mesh,
                stacked,
                jnp.asarray(queries),
                k=k,
                ef=ef,
                metric=self.metric,
                filter_masks=fmasks,
                shard_versions=versions,
                precision=config.get("search.distance-precision"),
            )
            current = np.asarray(
                [s.store.epoch for s in self.shards], np.int32
            )
            if np.array_equal(np.asarray(versions), current) or bool(
                config.get("search.prefer-partial-results")
            ):
                break
            STATS.incr("fanout_version_retries")
            with self._lock:
                self._stacked = None
        d = np.asarray(d)
        gids = np.asarray(gids)
        node_cap = stacked.vectors.shape[1]
        shard_idx = np.maximum(gids, 0) // node_cap
        node_idx = np.maximum(gids, 0) % node_cap
        docs = np.where(
            gids >= 0, node_docs[shard_idx, node_idx], -1
        ).astype(np.int32)
        STATS.incr("fanout_searches", queries.shape[0])
        return d, docs

    def exact_search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[jnp.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Prefiltered exact path: per-shard masked scans merged on host
        (the non-vector per-shard LIMIT optimization analog)."""
        per = [
            s.exact_search_batch(queries, k, filter_mask) for s in self.shards
        ]
        d = np.concatenate([p[0] for p in per], axis=1)
        docs = np.concatenate([p[1] for p in per], axis=1)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(d, order, 1), np.take_along_axis(docs, order, 1)

    def neighbors_to_keys(self, dists, docs):
        out = []
        for dd, doc in zip(np.asarray(dists), np.asarray(docs)):
            if doc < 0 or not np.isfinite(dd):
                continue
            key = self.interner.key_of(int(doc))
            if key is not None:
                out.append((key, float(dd)))
        return out
