"""HNSW vector index: native host construction + batched device search.

Reference: src/indexes/vector_hnsw.{h,cc} over modified hnswlib. Device split:
- construction (addPoint's greedy descent + ef_construction beam + neighbor
  pruning, hnswalg.h:1260) runs in the native builder (native_lib.HnswBuilder)
  — host-side, like the reference;
- search (searchKnn, hnswalg.h:1611) runs as a batched device kernel
  (ops/hnsw_search.py) over a published device snapshot of the graph;
- updates tombstone the old node and insert a fresh one (the node↔doc
  indirection mirrors hnswlib's internal-id↔label maps,
  vector_base.h:263-276); tombstones are traversed but never returned
  (markDelete semantics, hnswalg.h:1156);
- capacity grows geometrically so device-program recompiles are O(log N)
  (the reference grows by hnsw-block-size under resize_mutex_,
  vector_hnsw.h:76 — block growth is free on CPU but each capacity change
  here recompiles the XLA program).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.indexes.base import RecordResult
from valkey_search_tpu.indexes.vector_base import (
    VectorIndexBase,
    parse_vector,
)
from valkey_search_tpu.native_lib import HnswBuilder
from valkey_search_tpu.ops import hnsw_search as hs_ops
from valkey_search_tpu.ops import topk as topk_ops
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.metrics import STATS
from valkey_search_tpu.utils.interning import KeyInterner


def _pad_pow2_batch(queries: np.ndarray) -> Tuple[np.ndarray, int]:
    b = queries.shape[0]
    bp = 1
    while bp < b:
        bp *= 2
    if bp != b:
        queries = np.concatenate(
            [queries, np.zeros((bp - b, queries.shape[1]), queries.dtype)]
        )
    return queries, b


class HnswVectorIndex(VectorIndexBase):
    kind = "HNSW"

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        m: int = 16,
        ef_construction: int = 200,
        ef_runtime: Optional[int] = None,
        interner: Optional[KeyInterner] = None,
        seed: int = 0x5EED,
    ):
        super().__init__(
            dim,
            metric,
            interner,
            block_size=int(config.get("search.hnsw-block-size")),
            growth="pow2",
        )
        self.m = m
        self.ef_construction = ef_construction
        self.ef_runtime = ef_runtime or int(config.get("search.default-ef-runtime"))
        try:
            self.builder = HnswBuilder(
                dim, metric=metric, m=m, ef_construction=ef_construction,
                seed=seed,
            )
        except Exception:
            STATS.incr("hnsw_create_exceptions")
            raise
        # node-space bookkeeping (store rows are NODES for this index)
        self._doc_node: dict = {}  # doc id → live node
        self._node_doc = np.full(self.store.capacity, -1, np.int32)
        self._deleted = np.zeros(self.store.capacity, bool)
        self._graph_dirty = True
        self._device_graph: Optional[hs_ops.HnswDeviceGraph] = None
        self._aos_tables = None  # AoS traversal mirror (budget-gated)
        self._aos_for_epoch = -1
        self._graph_lock = threading.Lock()

    # -- deleted-slot reclamation -------------------------------------------
    def deleted_count(self) -> int:
        with self._lock:
            return self.builder.count - len(self._doc_node)

    def reclaimable_bytes(self) -> int:
        """Bytes held by tombstoned graph slots (reference
        reclaimable-memory gauge, integration/test_reclaimable_memory.py).
        Tombstones keep their vector row + link rows until vacuum()."""
        n_del = self.deleted_count()
        if n_del <= 0 or self.builder.count == 0:
            return 0
        per_node = self.builder.memory_bytes() / max(1, self.builder.count)
        return int(n_del * (per_node + self.dim * 4))  # + store row

    def vacuum(self, force: bool = False) -> int:
        """Rebuild the graph from live vectors, dropping tombstones.

        The reference reuses deleted slots in place (hnswlib
        allow_replace_deleted + markDelete); an accelerator-first engine
        rebuilds instead — bulk construction is fast (device-seeded or
        multi-threaded host build), the rebuilt graph has no tombstone
        drag on traversal, and the device mirror republishes compactly.
        Triggered by cron when the deleted fraction exceeds
        search.hnsw-vacuum-deleted-ratio (0 disables). Returns reclaimed
        slot count."""
        with self._lock:
            total = self.builder.count
            n_del = total - len(self._doc_node)
            if total == 0 or n_del == 0:
                return 0
            ratio = float(config.get("search.hnsw-vacuum-deleted-ratio"))
            if not force and (ratio <= 0 or n_del / total < ratio):
                return 0
            pairs = sorted(self._doc_node.items(), key=lambda kv: kv[1])
            docs = np.asarray([d for d, _ in pairs], np.int64)
            nodes = np.asarray([n for _, n in pairs], np.int64)
            vecs = self.store.vectors[nodes].copy()
            if self.metric == "cosine":
                # store rows are normalized; rebuild from originals
                vecs = vecs * self.store.magnitudes[nodes][:, None]
            seed = getattr(self.builder, "seed", 0x5EED)
            self.builder = HnswBuilder(
                self.dim, metric=self.metric, m=self.m,
                ef_construction=self.ef_construction, seed=seed,
            )
            self.store = type(self.store)(
                self.dim, self.metric,
                int(config.get("search.hnsw-block-size")), growth="pow2",
            )
            self._doc_node = {}
            self._node_doc = np.full(self.store.capacity, -1, np.int32)
            self._deleted = np.zeros(self.store.capacity, bool)
            if len(vecs):
                threads = int(config.get("search.native-build-threads"))
                if threads == 0:
                    import os as _os

                    threads = _os.cpu_count() or 1
                new_nodes = self.builder.add_batch(vecs, threads=max(1, threads))
                self.store.ensure_capacity(int(new_nodes.max()) + 1)
                self._ensure_node_arrays()
                for row, doc, v in zip(new_nodes, docs, vecs):
                    self.store.set_row(int(row), v)
                    self._node_doc[int(row)] = int(doc)
                    self._doc_node[int(doc)] = int(row)
            self._graph_dirty = True
            self._device_graph = None
            self._aos_tables = None
            STATS.incr("hnsw_vacuums")
            STATS.incr("hnsw_slots_reclaimed", n_del)
            return n_del

    # -- record mutation (overrides doc==row base behavior) ------------------
    def add_record(self, key: str, value) -> RecordResult:
        try:
            vec = parse_vector(value, self.dim)
        except ValueError:
            STATS.incr("vector_invalid_records")
            return RecordResult.INVALID_DATA
        try:
            return self._add_record_parsed(key, vec)
        except Exception:
            # reference hnsw_add/modify_exceptions_cnt (metrics.h)
            STATS.incr("hnsw_modify_exceptions" if key in self._tracked
                       else "hnsw_add_exceptions")
            raise

    def _add_record_parsed(self, key: str, vec) -> RecordResult:
        with self._lock:
            doc = self.interner.intern(key)
            existed = key in self._tracked
            if existed:
                old = self._doc_node.pop(doc, None)
                if old is not None:
                    self.builder.mark_deleted(old)
                    self._deleted[old] = True
            ins = vec
            if self.metric == "cosine":
                mag = float(np.linalg.norm(vec))
                if mag > 0:
                    ins = vec / mag
            node = self.builder.add(ins)
            self.store.ensure_capacity(node + 1)
            self._ensure_node_arrays()
            self.store.set_row(node, vec)  # normalizes + records magnitude
            self._node_doc[node] = doc
            self._deleted[node] = False
            self._doc_node[doc] = node
            self._tracked[key] = doc
            self._graph_dirty = True
            STATS.incr(
                "vector_records_modified" if existed else "vector_records_added"
            )
            return RecordResult.MODIFIED if existed else RecordResult.ADDED

    def remove_record(self, key: str) -> RecordResult:
        try:
            return self._remove_record_inner(key)
        except Exception:
            STATS.incr("hnsw_remove_exceptions")
            raise

    def _remove_record_inner(self, key: str) -> RecordResult:
        with self._lock:
            doc = self._tracked.pop(key, None)
            if doc is None:
                return RecordResult.SKIPPED
            node = self._doc_node.pop(doc, None)
            if node is not None:
                self.builder.mark_deleted(node)
                self._deleted[node] = True
            if self._owns_interner:
                self.interner.release(key)
            self._graph_dirty = True
            STATS.incr("vector_records_removed")
            return RecordResult.REMOVED

    def bulk_load(self, keys, vectors: np.ndarray) -> int:
        """Batch construction. Returns count inserted.

        Mode (search.hnsw-build-mode):
        - "device" (default, corpora >= 2048): the level-0 candidate pool
          for every insert comes from an exact tensor-core scan of the point
          against all lower node ids — the ef_construction beam that
          dominates hnswlib addPoint (hnswalg.h:1260) is skipped and the
          candidate pool is *exact* rather than beam-approximate, so
          graph quality matches or beats host construction.
        - "host": classic sequential native build (the recall oracle).
        """
        vectors = np.ascontiguousarray(vectors, np.float32)
        with self._lock:
            # replace semantics (mirror add_record): drop intra-batch
            # duplicates (last occurrence wins) and tombstone the previous
            # node of any already-tracked key — otherwise the stale node
            # stays live in the graph mapped to the same doc and searches
            # can return the key at its OLD vector's distance (r2 review)
            last = {k: i for i, k in enumerate(keys)}
            if len(last) != len(keys):
                order = sorted(last.values())
                keys = [keys[i] for i in order]
                vectors = vectors[order]
            for k in keys:
                doc = self._tracked.get(k)
                if doc is None:
                    continue
                old = self._doc_node.pop(doc, None)
                if old is not None:
                    self.builder.mark_deleted(old)
                    self._deleted[old] = True
            ins = vectors
            if self.metric == "cosine":
                mags = np.linalg.norm(vectors, axis=1, keepdims=True)
                ins = vectors / np.maximum(mags, 1e-30)
            mode = str(config.get("search.hnsw-build-mode"))
            if mode == "auto":
                # the vectorized build pays off on an accelerator; on the
                # CPU the native sequential build is faster
                import jax as _jax

                on_cpu = _jax.devices()[0].platform == "cpu"
                mode = "host" if on_cpu else "device"
            if mode == "device" and len(keys) >= 2048:
                if self.builder.count == 0:
                    nodes = self._bulk_build_device(ins)
                else:
                    nodes = self._add_batch_device_seeded(ins)
            else:
                threads = int(config.get("search.native-build-threads"))
                if threads == 0:
                    import os as _os

                    threads = _os.cpu_count() or 1
                nodes = self.builder.add_batch(ins, threads=threads)
            self.store.ensure_capacity(int(nodes.max()) + 1)
            self._ensure_node_arrays()
            st = self.store
            st.vectors[nodes] = ins
            st.norms_sq[nodes] = (ins * ins).sum(1)
            if self.metric == "cosine":
                st.magnitudes[nodes] = np.linalg.norm(vectors, axis=1)
            st.present[nodes] = True
            st._device = None
            docs = np.fromiter(
                (self.interner.intern(k) for k in keys), np.int64, len(keys)
            )
            self._node_doc[nodes] = docs
            self._deleted[nodes] = False
            for k, d, n in zip(keys, docs, nodes):
                self._tracked[k] = int(d)
                self._doc_node[int(d)] = int(n)
            self._graph_dirty = True
            STATS.incr("vector_records_added", len(keys))
            return len(keys)

    def _bulk_build_device(self, ins: np.ndarray) -> np.ndarray:
        """Vectorized construction (SURVEY.md §7 M2): device-exact KNN
        candidates + device-parallel select heuristic; host assembles
        links and the tiny upper hierarchy (ops/hnsw_build.py)."""
        from valkey_search_tpu.ops import hnsw_build as hb

        levels, _ = hb.sample_levels(ins.shape[0], self.m, seed=0x5EED)
        links = hb.build_pruned_knn_links(
            ins, self.metric, m=self.m,
            k_cand=min(self.ef_construction, 64),
            batch=int(config.get("search.hnsw-build-batch")),
        )
        nodes = self.builder.bulk_build(ins, levels, links)
        # Bulk KNN graphs have no long-range edges (those come from
        # incremental insertion history in hnswlib), so clustered corpora
        # fragment into islands at level 0. Repair: union-find the
        # components, scan each component representative against the rest
        # of the corpus on device, and add mutual bridge edges until one
        # component remains.
        hb.bridge_components(self.builder, ins)
        return nodes

    def _add_batch_device_seeded(self, ins: np.ndarray) -> np.ndarray:
        """Insert ``ins`` with device-computed candidate pools.

        Seeds for batch rows [s, e) are the exact top-k of each row against
        node ids < base+e (earlier batch rows included, so intra-batch
        near-duplicates still link; the native side skips ids >= own node).
        Candidate scoring runs in bf16 — the builder re-computes exact fp32
        distances during neighbor selection anyway."""
        import jax.numpy as _jnp

        base = self.builder.count
        n = ins.shape[0]
        total = base + n
        if base:
            corpus = np.concatenate([self.store.vectors[:base], ins])
        else:
            corpus = ins
        c_dev = _jnp.asarray(corpus, _jnp.bfloat16)
        c_sq = _jnp.einsum(
            "ij,ij->i", c_dev.astype(_jnp.float32), c_dev.astype(_jnp.float32)
        )
        row_ids = _jnp.arange(total, dtype=_jnp.int32)
        bsz = int(config.get("search.hnsw-build-batch"))
        k_seeds = min(self.ef_construction, 128) + 1  # +1: self-match slot
        out_nodes = np.empty(n, np.int32)
        for s in range(0, n, bsz):
            e = min(s + bsz, n)
            qb = ins[s:e]
            if e - s < bsz:  # pad the tail so program shapes stay stable
                qb = np.concatenate(
                    [qb, np.zeros((bsz - (e - s), ins.shape[1]), np.float32)]
                )
            invalid = row_ids >= (base + e)
            # approx selection: exact top-k would pay a full sort over the
            # score row per batch (the dominant cost); a ~0.95-recall pool
            # of exact-scored candidates is still far better than the
            # hnswlib beam pool it replaces
            _, ids = topk_ops.flat_topk(
                _jnp.asarray(qb, _jnp.bfloat16),
                c_dev,
                k=min(k_seeds, total),
                metric=self.metric if self.metric != "cosine" else "ip",
                corpus_sq=c_sq if self.metric == "l2" else None,
                invalid=invalid,
                block_rows=c_dev.shape[0],
                precision="high",
                mode="approx",
            )
            seeds = np.asarray(ids[: e - s])
            out_nodes[s:e] = self.builder.add_batch_seeded(ins[s:e], seeds)
        return out_nodes

    def _ensure_node_arrays(self):
        cap = self.store.capacity
        if self._node_doc.shape[0] < cap:
            grow = cap - self._node_doc.shape[0]
            self._node_doc = np.concatenate(
                [self._node_doc, np.full(grow, -1, np.int32)]
            )
            self._deleted = np.concatenate([self._deleted, np.zeros(grow, bool)])

    @property
    def node_count(self) -> int:
        return self.builder.count

    # -- snapshot publish ----------------------------------------------------
    def device_graph(self) -> hs_ops.HnswDeviceGraph:
        """Publish (or reuse) the device snapshot of the graph.

        The epoch-snapshot analog of the reference's read time-slice: queries
        run against an immutable published graph; host mutations set
        ``_graph_dirty`` and the next publish re-exports. (Incremental export
        is a planned optimization; publish cost is O(N) today.)
        """
        with self._graph_lock:
            if self._device_graph is not None and not self._graph_dirty:
                return self._device_graph
            with self._lock:
                prev = self._device_graph
                cap = self.store.capacity
                self._ensure_node_arrays()
                dirty = self.builder.dirty_count
                # incremental publish: scatter just the changed level-0
                # rows into the device mirror (the reference republishes
                # nothing — readers share the mutable index under the
                # time-sliced mutex; here snapshots are immutable, so the
                # cost target is O(mutations), not O(N))
                if (
                    prev is not None
                    and prev.links0.shape[0] == cap
                    and 0 < dirty <= max(1024, cap // 5)
                ):
                    upper_dirty = self.builder.upper_dirty
                    nodes, links_rows, del_rows = self.builder.export_dirty()
                    snap = self.store.device_snapshot()
                    idx = jnp.asarray(nodes)
                    links0 = prev.links0.at[idx].set(jnp.asarray(links_rows))
                    deleted = prev.deleted.at[idx].set(jnp.asarray(del_rows))
                    node_doc = prev.node_doc.at[idx].set(
                        jnp.asarray(self._node_doc[nodes])
                    )
                    if upper_dirty:
                        self._device_graph = hs_ops.build_device_graph(
                            vectors=snap["vectors"],
                            links0=links0,
                            deleted=deleted,
                            uppers=self.builder.export_uppers(),
                            entry=max(self.builder.entry, 0),
                            node_doc=node_doc,
                            m=self.m,
                        )
                    else:
                        self._device_graph = prev._replace(
                            vectors=snap["vectors"],
                            links0=links0,
                            deleted=deleted,
                            node_doc=node_doc,
                        )
                    self._graph_dirty = False
                    STATS.incr("hnsw_graph_incremental_publishes")
                    return self._device_graph

                g = self.builder.export_graph()
                n = g["count"]
                links0 = np.full((cap, 2 * self.m), -1, np.int32)
                links0[:n] = g["links0"]
                deleted = np.ones(cap, bool)
                deleted[:n] = g["deleted"]
                snap = self.store.device_snapshot()
                self._device_graph = hs_ops.build_device_graph(
                    vectors=snap["vectors"],
                    links0=links0,
                    deleted=deleted,
                    uppers=g["uppers"],
                    entry=g["entry"] if g["entry"] >= 0 else 0,
                    node_doc=self._node_doc,
                    m=self.m,
                )
                self.builder.clear_dirty()
                self._graph_dirty = False
                STATS.incr("hnsw_graph_publishes")
            return self._device_graph

    # -- search --------------------------------------------------------------
    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        ef: Optional[int] = None,
        filter_mask: Optional[jnp.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ANN search [B, d] → (dists [B, k], doc ids [B, k]).

        filter_mask: optional device bool array in doc-id space — the
        inline-filter path (reference InlineVectorFilter, search.cc:102-133).
        """
        try:
            return self._search_batch_inner(queries, k, ef, filter_mask)
        except Exception:
            STATS.incr("hnsw_search_exceptions")
            raise

    def _search_batch_inner(self, queries, k, ef, filter_mask):
        if self.builder.count == 0:
            b = np.atleast_2d(queries).shape[0]
            return (
                np.full((b, k), np.inf, np.float32),
                np.full((b, k), -1, np.int32),
            )
        # accelerator-first planner choice the reference cannot make: below the
        # scan threshold the exact matmul scan beats graph traversal outright
        # (higher QPS at recall 1.0) — the graph stays for huge corpora,
        # persistence, and hnswlib-semantics parity. 0 disables.
        scan_thresh = int(config.get("search.hnsw-scan-threshold"))
        if scan_thresh and self.builder.count <= scan_thresh:
            STATS.incr("hnsw_served_by_scan")
            return self.exact_search_batch(
                queries, k, filter_mask=filter_mask, ef=ef
            )
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        queries, b = _pad_pow2_batch(queries)
        ef = min(
            max(ef or self.ef_runtime, k),
            int(config.get("search.max-ef-runtime")),
        )
        graph = self.device_graph()
        filtered = filter_mask is not None
        aos = None if filtered else self._aos_mirror(graph)
        if aos is not None:
            # fast path: AoS int8 neighbor blocks + exact fp32 rescore
            d, ids = hs_ops.hnsw_search_batch_aos(
                graph, aos, jnp.asarray(queries), k=k, ef=ef,
                metric=self.metric,
                seed_stride=int(
                    config.get("search.hnsw-traversal-seed-stride")
                ),
            )
        else:
            if not filtered:
                # dummy mask keeps the jit signature stable across calls
                filter_mask = jnp.zeros((1,), bool)
            d, ids = hs_ops.hnsw_search_batch(
                graph,
                jnp.asarray(queries),
                k=k,
                ef=ef,
                metric=self.metric,
                filter_mask=filter_mask,
                filtered=filtered,
                precision=config.get("search.distance-precision"),
            )
        d = np.asarray(d)[:b]
        nodes = np.asarray(ids)[:b]
        docs = np.where(nodes >= 0, self._node_doc[np.maximum(nodes, 0)], -1)
        STATS.incr("hnsw_searches", b)
        return d, docs.astype(np.int32)

    def _aos_mirror(self, graph):
        """Budget-gated AoS traversal mirror, rebuilt per publish epoch
        (ops/hnsw_search.py HnswAosTables)."""
        budget = int(config.get("search.hnsw-aos-budget-bytes"))
        dp = int(config.get("search.hnsw-aos-project-dim")) or self.dim
        dp = min(dp, self.dim)
        cap, m0 = graph.links0.shape
        if budget == 0 or cap * m0 * dp > budget:
            return None
        epoch = (self.store.epoch, dp)
        if self._aos_tables is None or self._aos_for_epoch != epoch:
            self._aos_tables = hs_ops.build_aos_tables(
                graph, project_dim=dp if dp < self.dim else 0
            )
            self._aos_for_epoch = epoch
        return self._aos_tables

    def exact_search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[jnp.ndarray] = None,
        ef: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scored scan over this index's vectors (pre-filter path).

        Reference: CalcBestMatchingPrefilteredKeys (search.cc:456) computes
        exact distances over the qualified key set; here the doc-space filter
        mask is converted to node space on device and fused into a blocked
        flat scan.
        """
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        graph = self.device_graph()
        snap = self.store.device_snapshot()
        node_doc = graph.node_doc
        invalid = graph.deleted | (node_doc < 0)
        node_filter = None
        if filter_mask is not None:
            node_filter = jnp.take(filter_mask, jnp.maximum(node_doc, 0)) & (
                node_doc >= 0
            )
        if node_filter is None:
            # sub-linear IVF path (ops/ivf.py; same gate as the flat
            # index: user filters take the scan paths — block probing
            # cannot see a mask, so a selective filter would lose
            # results). Mirror rows are NODES; tombstones don't bump the
            # store epoch, so deletions ride the dense ~invalid mask.
            mirror = self.ivf_mirror()
            if mirror is not None:
                from valkey_search_tpu.ops import ivf as ivf_ops

                # EF_RUNTIME is a CANDIDATE-count dial in the reference
                # (hnswalg.h ef_); probed candidates here are
                # probe * block_rows, so the floor only rises when the
                # requested candidate pool exceeds what the configured
                # probe already covers
                probe = (int(config.get("search.ivf-probe"))
                         or ivf_ops.default_probe(mirror))
                if ef:
                    probe = max(probe, -(-int(ef) // mirror.block_rows))
                metric = "ip" if self.metric == "cosine" else self.metric
                qd = jnp.asarray(queries)
                delta = self.ivf_delta_ids()  # node rows since build
                mask = ~invalid
                if len(delta):
                    dmask = np.zeros(self.store.capacity, bool)
                    live = delta[delta >= 0]
                    dmask[live[live < self.store.capacity]] = True
                    mask = mask & ~jnp.asarray(dmask)
                d, ids = ivf_ops.ivf_search_rescored(
                    mirror,
                    qd,
                    snap["vectors"],
                    k=k,
                    probe=probe,
                    metric=metric,
                    filter_mask=mask,
                )
                if len(delta):
                    d, ids = ivf_ops.delta_overlay_merge(
                        qd, snap["vectors"], jnp.asarray(delta, jnp.int32),
                        invalid, d, ids, k=k, metric=metric,
                    )
                d = np.asarray(d)
                nodes = np.asarray(ids)
                docs = np.where(
                    nodes >= 0, self._node_doc[np.maximum(nodes, 0)], -1
                )
                STATS.incr("ivf_served_searches", queries.shape[0])
                return d, docs.astype(np.int32)
        if (
            ("vectors_lp" in snap or "vectors_i8" in snap)
            and str(config.get("search.topk-mode")) == "approx"
            and topk_ops.use_fused_scan(snap["vectors"].shape[0], node_filter)
        ):
            d, ids = topk_ops.flat_topk_fused(
                jnp.asarray(queries),
                snap["vectors"],
                snap.get("vectors_lp"),
                k=k,
                metric=self.metric,
                corpus_sq=snap["norms_sq"],
                invalid=invalid,
                filter_mask=node_filter,
                block_rows=max(self.store.capacity, 131072),
                corpus_i8=snap.get("vectors_i8"),
                i8_scale=snap.get("i8_scale"),
            )
        elif (
            "vectors_lp" in snap
            and str(config.get("search.topk-mode")) == "approx"
        ):
            d, ids = topk_ops.flat_topk_two_stage(
                jnp.asarray(queries),
                snap["vectors"],
                snap["vectors_lp"],
                k=k,
                metric=self.metric,
                corpus_sq=snap["norms_sq"],
                invalid=invalid,
                filter_mask=node_filter,
                block_rows=max(self.store.capacity, 131072),
            )
        else:
            d, ids = topk_ops.flat_topk(
                jnp.asarray(queries),
                snap["vectors"],
                k=k,
                metric=self.metric,
                corpus_sq=snap["norms_sq"],
                invalid=invalid,
                filter_mask=node_filter,
                block_rows=max(self.store.capacity, 131072),
                # topk-mode exact means exact: full fp32 products (a GPU
                # runs "high" float32 products in TF32)
                precision=(
                    "highest"
                    if str(config.get("search.topk-mode")) == "exact"
                    else config.get("search.distance-precision")
                ),
            )
        d = np.asarray(d)
        nodes = np.asarray(ids)
        docs = np.where(nodes >= 0, self._node_doc[np.maximum(nodes, 0)], -1)
        return d, docs.astype(np.int32)

    def search(
        self, query: np.ndarray, k: int, ef: Optional[int] = None
    ) -> List[Tuple[str, float]]:
        d, docs = self.search_batch(np.atleast_2d(query), k, ef=ef)
        return self.neighbors_to_keys(d[0], docs[0])
