"""Flat (brute-force, exact) vector index.

Reference: src/indexes/vector_flat.{h,cc} over hnswlib BruteforceSearch
(third_party/hnswlib/bruteforce.h) with block-sized growth. Device design:
the corpus lives in device memory as a padded [cap, d] fp32 array; a search
is one streaming blocked-matmul pass with fused top-k (ops/topk.py),
amortized over a whole batch of queries — so at ~1M×128d scale exact search
is bound by the tensor cores and device memory, and can outrun a CPU HNSW
(PAPERS.md lists the accelerator k-NN work this follows).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from valkey_search_tpu.indexes.vector_base import VectorIndexBase
from valkey_search_tpu.ops import topk as topk_ops
from valkey_search_tpu.runtime import config
from valkey_search_tpu.runtime.metrics import STATS


class FlatVectorIndex(VectorIndexBase):
    kind = "FLAT"

    def search_batch(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[jnp.ndarray] = None,
        precision: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact k-NN for a query batch [B, d] → (dists [B, k], doc ids [B, k]).

        ``filter_mask``: optional device bool array [cap] (or [B, cap]) of
        allowed docs — the fused pre-filter path (reference
        src/query/search.cc:456 scores only qualified keys; flat indexes
        always pre-filter, planner.cc:26-28).
        """
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        if queries.shape[1] != self.dim:
            raise ValueError(f"query dim {queries.shape[1]} != index dim {self.dim}")
        if self.metric == "cosine":
            mags = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(mags, 1e-30)
        snap = self.store.device_snapshot()
        mode = str(config.get("search.topk-mode"))
        # topk-mode exact means exact: full fp32 products (a GPU runs
        # "high" float32 products in TF32)
        prec = "highest" if mode == "exact" else (
            precision or config.get("search.distance-precision"))
        if filter_mask is None:
            # sub-linear IVF path for large corpora (ops/ivf.py): engaged
            # above search.ivf-threshold; per-query row traffic drops from
            # O(N) to O(nb + probe*block-rows). FILTERED searches take the
            # scan paths below: block probing cannot see a mask, so a
            # selective filter would prune away the very blocks holding
            # the allowed docs and silently lose results. The ~invalid
            # mask is kept: it is DENSE (deletions are a small fraction;
            # vacuum/epoch rebuilds reclaim), so probing is unaffected,
            # and it keeps rows cleared since the mirror's build epoch
            # out of results.
            mirror = self.ivf_mirror()
            if mirror is not None:
                from valkey_search_tpu.ops import ivf as ivf_ops

                metric = "ip" if self.metric == "cosine" else self.metric
                qd = jnp.asarray(queries)
                # rows written since the mirror build: excluded from the
                # mirror query, exact-scored by the delta overlay — the
                # throttled rebuild keeps read-your-writes exact
                delta = self.ivf_delta_ids()
                mask = ~snap["invalid"]
                if len(delta):
                    dmask = np.zeros(self.store.capacity, bool)
                    live = delta[delta >= 0]
                    dmask[live[live < self.store.capacity]] = True
                    mask = mask & ~jnp.asarray(dmask)
                d, i = ivf_ops.ivf_search_rescored(
                    mirror,
                    qd,
                    snap["vectors"],
                    k=k,
                    probe=(int(config.get("search.ivf-probe"))
                           or ivf_ops.default_probe(mirror)),
                    metric=metric,
                    filter_mask=mask,
                )
                if len(delta):
                    d, i = ivf_ops.delta_overlay_merge(
                        qd, snap["vectors"], jnp.asarray(delta, jnp.int32),
                        snap["invalid"], d, i, k=k, metric=metric,
                    )
                STATS.incr("flat_searches", queries.shape[0])
                STATS.incr("ivf_served_searches", queries.shape[0])
                return np.asarray(d), np.asarray(i)
        if (
            mode == "approx"
            and ("vectors_lp" in snap or "vectors_i8" in snap)
            and topk_ops.use_fused_scan(snap["vectors"].shape[0], filter_mask)
        ):
            # fused Pallas coarse scan + exact fp32 rescore (ops/pallas_scan).
            # One kernel block over the whole corpus: the survivor array is
            # 128x smaller than the score matrix, so even at 10M rows it is
            # B x 80k — no need for the blocked scan's memory bound at
            # engine batch sizes.
            d, i = topk_ops.flat_topk_fused(
                jnp.asarray(queries),
                snap["vectors"],
                snap.get("vectors_lp"),
                k=k,
                metric=self.metric,
                corpus_sq=snap["norms_sq"],
                invalid=snap["invalid"],
                filter_mask=filter_mask,
                block_rows=max(
                    int(config.get("search.flat-block-size")),
                    snap["vectors"].shape[0],
                ),
                # int8 coarse mirror when published (search.corpus-dtype
                # int8): int8 tensor-core rate, exact fp32 rescore unchanged
                corpus_i8=snap.get("vectors_i8"),
                i8_scale=snap.get("i8_scale"),
                # operator recall-margin levers (0 = measured auto)
                span=int(config.get("search.scan-span")) or None,
                coarse_factor=(
                    int(config.get("search.scan-coarse-factor")) or None),
            )
        elif mode == "approx" and "vectors_lp" in snap:
            # bf16 coarse scan + exact fp32 rescore (ops/topk.py)
            d, i = topk_ops.flat_topk_two_stage(
                jnp.asarray(queries),
                snap["vectors"],
                snap["vectors_lp"],
                k=k,
                metric=self.metric,
                corpus_sq=snap["norms_sq"],
                invalid=snap["invalid"],
                filter_mask=filter_mask,
                block_rows=int(config.get("search.flat-block-size")),
            )
        else:
            d, i = topk_ops.flat_topk(
                jnp.asarray(queries),
                snap["vectors"],
                k=k,
                metric=self.metric,
                corpus_sq=snap["norms_sq"],
                invalid=snap["invalid"],
                filter_mask=filter_mask,
                block_rows=int(config.get("search.flat-block-size")),
                precision=prec,
                mode=mode,
            )
        STATS.incr("flat_searches", queries.shape[0])
        return np.asarray(d), np.asarray(i)

    def search(
        self,
        query: np.ndarray,
        k: int,
        filter_mask: Optional[jnp.ndarray] = None,
    ) -> List[Tuple[str, float]]:
        """Single-query convenience wrapper → [(key, distance)] ascending."""
        d, i = self.search_batch(np.atleast_2d(query), k, filter_mask=filter_mask)
        return self.neighbors_to_keys(d[0], i[0])
